"""A configuration, a traffic mix and a per-layer metric are added by
adding files that the harness finds by name: a throwaway cell built from
new files only runs and reports its new metric."""

from __future__ import annotations

import json
import time

import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_root


def test_new_files_make_a_new_cell(tmp_path):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    bench = root / "benchmark"
    m = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "haadf256.json").read_text())
    cfg["nslice"] = 6  # a new deployment
    (bench / "configs" / "haadf_tmp.json").write_text(json.dumps(cfg))
    t = json.loads((bench / "traffic" / "fista.json").read_text())
    t["draws"] = 2  # a new mix
    (bench / "traffic" / "fista_tmp.json").write_text(json.dumps(t))
    (bench / "cells" / "haadf_tmp.fista_tmp.json").write_text(
        (bench / "cells" / "haadf256.fista.json").read_text())
    (bench / "metrics" / "jobs_tmp.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    m["configs"].append({"name": "haadf_tmp", "source": "x",
                         "file": "benchmark/configs/haadf_tmp.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "haadf_tmp.fista_tmp",
                           "config": "haadf_tmp", "traffic": "fista_tmp",
                           "chips": 1, "why": "x"})
    m["end_to_end"][0]["workloads"].append("haadf_tmp.fista_tmp")
    m["per_layer"].append({"name": "jobs_tmp", "unit": "n",
                           "better": "higher", "source": "host_clock",
                           "layer": "api", "moves": "recon_s",
                           "workloads": ["haadf_tmp.fista_tmp"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.load("haadf_tmp.fista_tmp", root, bench)
    assert cell.config["nslice"] == 6 and cell.traffic["draws"] == 2
    assert [p["name"] for p in cell.per_layer] == ["jobs_tmp"]
    run = harness.run("haadf_tmp.fista_tmp", 5, 0.3, True, "cpu",
                      time.perf_counter(), root=root, bench=bench,
                      log=lambda s: None)
    assert run["metrics"] == {"jobs_tmp": {"value": 42.0, "unit": "n"}}
    assert run["correct"] is True


USED = set()  # the throwaway parts that were called

# each throwaway part wraps a copy of an existing part's file and records
# its use here
WRAP = {
    "reference": ("fista", "run"),
    "entries": ("TomoTorch", "make"),
    "phantoms": ("nanocube", "make"),
}


def _throwaway(bench, kind, name, new):
    fn = WRAP[kind][1]
    text = (bench / kind / f"{name}.py").read_text()
    text += (f"\n\n_orig = {fn}\n\n\ndef {fn}(*a, **k):\n"
             f"    import benchmark.tests.test_bench_data_driven as T\n"
             f"    T.USED.add({kind!r})\n"
             f"    return _orig(*a, **k)\n")
    (bench / kind / f"{new}.py").write_text(text)


def test_new_reference_entry_driver_and_phantom_files(tmp_path):
    """A mix that names a reference, an entry, a driver and a phantom that
    no file of the benchmark had runs from new files alone."""
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    bench = root / "benchmark"
    for kind, (name, _) in WRAP.items():
        _throwaway(bench, kind, name, f"{name}_tmp")
    driver = (bench / "drivers" / "batch.py").read_text()
    (bench / "drivers" / "batch_tmp.py").write_text(
        driver + "\n\nclass Driver(Driver):\n"
        "    def step(self):\n"
        "        import benchmark.tests.test_bench_data_driven as T\n"
        "        T.USED.add('drivers')\n"
        "        return super().step()\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "haadf256.json").read_text())
    cfg["phantom"]["kind"] = "nanocube_tmp"
    t = json.loads((bench / "traffic" / "fista.json").read_text())
    t.update(driver="batch_tmp", entry="TomoTorch_tmp",
             reference="fista_tmp")
    cfg["solvers"]["TomoTorch_tmp"] = cfg["solvers"]["TomoTorch"]
    (bench / "configs" / "haadf_tmp.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "fista_tmp.json").write_text(json.dumps(t))
    (bench / "cells" / "haadf_tmp.fista_tmp.json").write_text(
        (bench / "cells" / "haadf256.fista.json").read_text())
    m["configs"].append({"name": "haadf_tmp", "source": "x",
                         "file": "benchmark/configs/haadf_tmp.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "haadf_tmp.fista_tmp",
                           "config": "haadf_tmp", "traffic": "fista_tmp",
                           "chips": 1, "why": "x"})
    m["end_to_end"][0]["workloads"].append("haadf_tmp.fista_tmp")
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    USED.clear()
    run = harness.run("haadf_tmp.fista_tmp", 5, 0.3, False, "cpu",
                      time.perf_counter(), root=root, bench=bench,
                      log=lambda s: None)
    assert run["correct"] is True, run["checks"]
    assert USED == {"reference", "entries", "drivers", "phantoms"}
