"""The three-element deployment `chem3el512` and its cell
`chem3el512.fusion_sart` (`ChemicalTomo.data_fusion(method="sart")`), the
cell `chem2el128.fused` (`data_fusion(fused=True)`), and the fusion's
spans and counter.

On the CPU: the SART fusion of three elements at 8 x 32^2 against the
benchmark's plain reference `reference/data_fusion_sart.py`; the spans
``fusion.haadf`` and ``fusion.chem`` and the counter ``element_launches``
(2 Nel a chemistry span) on the host loop and on ``fused=True``; the
reader `projector.element_launches_per_step.recon` on a synthetic store;
the driver `batch_kwargs`, which lays the traffic's arguments over the
program's calls and hands the reference the configuration's own; both
cells at the tiny size of `benchmark/tests/tiny.py` through
`harness.run`, and their bfloat16 controls against the cells' limits; the
configuration file's cut. On the card (`cuda`): the SART fusion at 512^2
planes, where K8 takes its (16, 2) shape, against the reference under the
cell's limits.

This file imports no jax, so that its `cuda` test runs on the card."""

from __future__ import annotations

import ast
import json
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import calibrate, check, data, found, harness, run
from benchmark.tests.tiny import REPO, tiny_root
from tomojax_torch import ChemicalTomo, api, profiling
from tomojax_torch.solvers import cuda_sart

CELL = "chem3el512.fusion_sart"
FUSED = "chem2el128.fused"
METRIC = "projector.element_launches_per_step.recon"
SEED = 2**31 + 31  # a seed past 32 signed bits
BENCH = REPO / "benchmark"
CONFIG = BENCH / "configs" / "chem3el512.json"


def _limits(cell):
    return json.loads((BENCH / "cells" / f"{cell}.json").read_text())[
        "limits"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _small_config(nslice=8, n=32, chem_iters=6, fusion_iters=4):
    """chem3el512 at nslice x n^2, the tilts cut to 13 and 5 and a few
    iterations: every other setting as the configuration states it."""
    cfg = json.loads(CONFIG.read_text())
    cfg["nslice"], cfg["n"] = nslice, n
    cfg["series"]["haadf"]["angles"]["num"] = 13
    cfg["series"]["chem"]["angles"]["num"] = 5
    sv = cfg["solvers"]
    sv["chemical_tomography"]["Niter"] = chem_iters
    sv["data_fusion"].update(Niter=fusion_iters, iterSIRT=3, tvIter=3)
    return cfg


def _job(inp, cfg, device, **over):
    sv = cfg["solvers"]
    t = ChemicalTomo(inp["haadf"], inp["haadf_angles"], inp["chem"],
                     inp["chem_angles"], device=device, **sv["ChemicalTomo"])
    t.chemical_tomography(**sv["chemical_tomography"])
    t.data_fusion(**{**sv["data_fusion"], **over})
    return {"recon": t.get_recon(), "costHAADF": np.asarray(t.costHAADF),
            "costCHEM": np.asarray(t.costCHEM),
            "costTV": np.asarray(t.costTV)}


# ------------------------------------------------ against the reference


@pytest.fixture(scope="module")
def small():
    torch.set_num_threads(2)
    cfg = _small_config()
    inp, = data.make(cfg, SEED, 1, "cpu")
    ref = found.module("reference", "data_fusion_sart").run(
        inp, cfg["solvers"], torch.device("cpu"), torch.float32)
    return cfg, inp, ref


# Both sides are float32 and take the same steps; they differ in the
# order of their sums (the port's gather projector and per-angle SART
# against the reference's sparse-matrix products), ~1e-7 relative a
# step, which a few iterations grow to ~1e-6 (read 3e-6 at most). The
# tolerances leave 10-30x room above that and sit 100x or more below the
# bfloat16 reference's readings at this size (1.6e-2 to 8e-2).
TOL = {"recon": 1e-4, "costHAADF": 3e-5, "costCHEM": 3e-5, "costTV": 3e-5}


@pytest.mark.parametrize("output", sorted(TOL))
def test_sart_fusion_matches_the_plain_reference(small, output):
    cfg, inp, ref = small
    prog = _job(inp, cfg, "cpu")
    got = check.gap(output, prog[output], ref[output])
    assert got <= TOL[output], (output, got)


def test_the_reference_differs_from_the_sirt_fusion(small):
    """The inner solver is what the reference swaps: SIRT's reference on
    the same inputs is far from it."""
    cfg, inp, ref = small
    sirt = found.module("reference", "data_fusion").run(
        inp, cfg["solvers"], torch.device("cpu"), torch.float32)
    assert check.gap("recon", sirt["recon"], ref["recon"]) > 1e-2


def test_the_reference_fuses_with_sart_only(small):
    cfg, inp, _ = small
    solvers = json.loads(json.dumps(cfg["solvers"]))
    run_ = found.module("reference", "data_fusion_sart").run
    for method in ("sirt", None):
        if method is None:
            del solvers["data_fusion"]["method"]
        else:
            solvers["data_fusion"]["method"] = method
        with pytest.raises(ValueError, match="SART only"):
            run_(inp, solvers, torch.device("cpu"), torch.float32)


def test_the_reference_turns_tf32_off_while_it_runs(monkeypatch):
    from benchmark.reference import plain

    cfg = _small_config(nslice=2, n=16, chem_iters=1, fusion_iters=1)
    inp, = data.make(cfg, SEED, 1, "cpu")
    seen = []
    real = plain.make_fusion

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(plain, "make_fusion", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    found.module("reference", "data_fusion_sart").run(
        inp, cfg["solvers"], torch.device("cpu"), torch.float32)
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True


# ------------------------------------------ the spans and the counter


def _profiled(fn):
    profiling.recorded().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    spans = list(profiling.recorded().spans)
    profiling.recorded().clear()
    return spans


@pytest.mark.parametrize("nel", [2, 3])
@pytest.mark.parametrize("kw", [{}, {"fused": True}, {"method": "sirt"},
                                {"method": "sirt", "fused": True}])
def test_each_chemistry_span_counts_two_launches_an_element(small, kw, nel):
    """On the host loop and on fused=True, with either inner solver."""
    cfg, inp, _ = small
    inp = {**inp, "chem": dict(list(inp["chem"].items())[:nel])}
    sv = cfg["solvers"]
    n_chem = sv["chemical_tomography"]["Niter"]
    n_fuse = sv["data_fusion"]["Niter"]
    spans = _profiled(lambda: _job(inp, cfg, "cpu", **kw))
    chem = [s for s in spans if s.name == "fusion.chem"]
    haadf = [s for s in spans if s.name == "fusion.haadf"]
    assert len(chem) == n_chem + n_fuse and len(haadf) == n_fuse
    assert all(s.counts.get("element_launches") == 2 * nel for s in chem)
    assert sum(s.counts.get("element_launches", 0) for s in spans) == \
        2 * nel * len(chem)
    ids = {s.id: s for s in spans}
    # every fused step's two sides lie inside one fusion iteration
    for s in haadf + chem[n_chem:]:
        assert ids[s.parent].name == "solvers.iteration"
    iters = [s for s in spans if s.name == "solvers.iteration"]
    assert len(iters) == n_chem + n_fuse


def test_the_reader_gives_launches_per_step(small, monkeypatch):
    """The reader on the spans of a whole job: 2 Nel."""
    cfg, inp, _ = small
    spans = _profiled(lambda: _job(inp, cfg, "cpu"))
    fake = types.SimpleNamespace(spans=spans, spans_dropped=0)
    monkeypatch.setattr(profiling, "recorded", lambda: fake)
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(window_s=1.0),
                                calls={}, device=torch.device("cuda"))
    assert harness.reader(METRIC).read(ctx) == 6.0


def test_the_reader_gives_none_where_there_is_nothing_to_read(monkeypatch):
    read = harness.reader(METRIC).read
    span = types.SimpleNamespace(name="fusion.chem", id=1, parent=None,
                                 root=1, start_ns=0, end_ns=1, inner_ns=0,
                                 counts={"element_launches": 4})
    fake = types.SimpleNamespace(spans=[span], spans_dropped=0)
    monkeypatch.setattr(profiling, "recorded", lambda: fake)

    def ctx(device="cuda", traced=True):
        tr = types.SimpleNamespace(window_s=1.0) if traced else None
        return types.SimpleNamespace(trace=tr, calls={},
                                     device=torch.device(device))

    assert read(ctx()) == 4.0
    assert read(ctx(device="cpu")) is None
    assert read(ctx(traced=False)) is None
    fake.spans = [types.SimpleNamespace(**{**vars(span),
                                           "name": "solvers.iteration"})]
    assert read(ctx()) is None  # a port that records no chemistry span
    fake.spans_dropped = 1
    assert read(ctx()) is None


def test_off_the_profiler_the_spans_are_the_shared_no_op(small):
    cfg, inp, _ = small
    profiling.recorded().clear()
    assert profiling.annotate("fusion.chem") is profiling._OFF
    assert profiling.annotate("fusion.haadf") is profiling._OFF
    _job(inp, cfg, "cpu", fused=True)
    assert list(profiling.recorded().spans) == []


# ------------------------------------------------------- batch_kwargs


class _Recorder:
    calls = []

    def __init__(self, *a, **k):
        pass

    def __getattr__(self, call):
        return lambda **kw: self.calls.append((call, kw))


def test_batch_kwargs_hands_its_arguments_to_the_program_only(root):
    cell = harness.load(FUSED, root, root / "benchmark")
    solvers = json.loads(json.dumps(cell.config["solvers"]))
    _Recorder.calls = []
    drv = cell.driver([{}], torch.device("cpu"), SEED)
    drv.make = lambda inp, kw, device: _Recorder()
    drv.job(0)
    got = dict(_Recorder.calls)
    assert got["data_fusion"] == {**solvers["data_fusion"], "fused": True}
    assert got["chemical_tomography"] == solvers["chemical_tomography"]
    # the configuration's arguments, which the reference is handed, are
    # as they were
    assert cell.config["solvers"] == solvers
    assert "fused" not in cell.config["solvers"]["data_fusion"]


def test_the_fused_cell_runs_fused_and_its_reference_does_not(root,
                                                              monkeypatch):
    fused_runs, handed = [], []
    real_run = api.data_fusion_run

    def counting(*a, **k):
        fused_runs.append(1)
        return real_run(*a, **k)

    monkeypatch.setattr(api, "data_fusion_run", counting)
    real_ref = harness.Cell.reference

    def reference(self):
        ref = real_ref(self)

        def wrapped(inp, solvers, device, dt):
            handed.append(json.loads(json.dumps(solvers)))
            return ref(inp, solvers, device, dt)
        return wrapped

    monkeypatch.setattr(harness.Cell, "reference", reference)
    result = harness.run(FUSED, SEED, 0.3, False, "cpu", time.perf_counter(),
                         root=root, bench=root / "benchmark",
                         log=lambda s: None)
    assert result["correct"] is True, result["checks"]
    assert len(fused_runs) == result["attempted"] + 1  # and the warm-up
    assert handed and all("fused" not in s["data_fusion"] for s in handed)


# ------------------------------------------------------ the cells on the CPU


@pytest.mark.parametrize("cell", [CELL, FUSED])
def test_cell_runs_and_is_correct_at_the_tiny_size(root, cell, capsys):
    result = harness.run(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                         root=root, bench=root / "benchmark",
                         log=lambda s: None)
    run.emit(result)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"recon_s", "setup_s"}
    assert set(line["checks"]) == set(_limits(cell))
    spec = harness.load(cell, root, root / "benchmark")
    assert METRIC in {p["name"] for p in spec.per_layer}


@pytest.mark.parametrize("cell", [CELL, FUSED])
def test_control_is_not_correct_under_the_cells_limits(root, cell):
    spec = harness.load(cell, root, root / "benchmark")
    assert spec.limits == _limits(cell)
    lines = []
    calibrate.readings(spec, [7], [7], torch.device("cpu"), lines.append)
    kinds = [line["kind"] for line in lines if "kind" in line]
    assert kinds == ["program", "control"]
    for line in lines:
        if "kind" in line:
            ok, _ = check.verdict(line["numbers"], spec.limits, 0)
            assert ok is (line["kind"] == "program"), line


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_faulty_sart_fusion_is_not_correct(root, fault, monkeypatch):
    if fault == "unchanged":  # the fused step leaves the state as it was
        zero = torch.zeros(())
        monkeypatch.setattr(api, "data_fusion_step",
                            lambda x, *a: (x, zero, zero))
    else:  # one element's map altered where the answer is produced
        get = api.ChemicalTomo.get_recon

        def broken(self):
            v = np.array(get(self))
            v[2, v.shape[1] // 2] *= 1.05
            return v

        monkeypatch.setattr(api.ChemicalTomo, "get_recon", broken)
    result = harness.run(CELL, SEED, 0.3, False, "cpu", time.perf_counter(),
                         root=root, bench=root / "benchmark",
                         log=lambda s: None)
    assert result["correct"] is False


# ----------------------------------------------- imports and the manifest


@pytest.mark.parametrize("path", ["reference/data_fusion_sart.py",
                                  "drivers/batch_kwargs.py",
                                  f"metrics/{METRIC}.py"])
def test_the_new_parts_import_neither_jax_nor_the_port(path):
    tree = ast.parse((BENCH / path).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "flax", "tomojax", "tomojax_torch"}


def test_the_manifest_lists_both_cells_and_the_metric():
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in m["workloads"]}
    assert (cells[CELL]["config"], cells[CELL]["traffic"],
            cells[CELL]["chips"]) == ("chem3el512", "fusion_sart", 1)
    assert (cells[FUSED]["config"], cells[FUSED]["traffic"],
            cells[FUSED]["chips"]) == ("chem2el128", "fused", 1)
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert {CELL, FUSED} <= set(e2e["recon_s"]["workloads"])
    metric = next(p for p in m["per_layer"] if p["name"] == METRIC)
    assert metric["workloads"] == ["chem2el128.fusion", FUSED, CELL]
    assert (metric["layer"], metric["moves"], metric["source"]) == (
        "projector", "recon_s", "program_counter")


# ----------------------------------------------- the configuration


def test_configuration_states_its_cut():
    cfg = json.loads(CONFIG.read_text())
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in manifest["configs"] if c["name"] == "chem3el512")
    assert cfg["reduced"] == entry["reduced"] == ["nslice"]
    assert cfg["source"] == entry["source"]
    assert (cfg["nslice"], cfg["n"]) == (128, 512)
    assert cfg["published"] == {"nslice": 512}
    assert "512 x 512^2" in cfg["deployment"]
    assert cfg["elements"] == ["Sr", "Ti", "O"]
    assert cfg["series"]["haadf"]["angles"] == {"start": -76.0,
                                                "stop": 76.0, "num": 77}
    assert cfg["series"]["chem"]["angles"] == {"start": -60.0,
                                               "stop": 60.0, "num": 9}
    fusion = cfg["solvers"]["data_fusion"]
    assert fusion["method"] == "sart" and fusion["iterSIRT"] == 5
    assert fusion["Niter"] == 50
    assert cuda_sart.sart_shape(cfg["n"], cfg["n"]) == (16, 2)


def test_the_disks_do_not_overlap():
    ph = json.loads(CONFIG.read_text())["phantom"]
    c, r = np.asarray(ph["centres"]), np.asarray(ph["radii"])
    for i in range(len(r)):
        for j in range(i + 1, len(r)):
            assert np.linalg.norm(c[i] - c[j]) > r[i] + r[j]
    vol = found.module("phantoms", "disks").make(ph, 2, 64, "cpu")
    assert vol.shape == (3, 2, 64, 64)
    assert float(vol.sum(0).max()) == 1.0


# ------------------------------------------------------------ the card


@pytest.mark.cuda
def test_sart_fusion_at_512_planes_matches_the_reference_on_card():
    """3 x 4 x 512^2, 13 HAADF tilts, where K8 takes its (16, 2) shape,
    two fused iterations of 3 sweeps, against the reference under the
    cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = _small_config(nslice=4, n=512, chem_iters=4, fusion_iters=2)
    assert cuda_sart.sart_shape(512, 512) == (16, 2)
    inp, = data.make(cfg, SEED, 1, dev)
    prog = _job(inp, cfg, dev)
    ref = found.module("reference", "data_fusion_sart").run(
        inp, cfg["solvers"], dev, torch.float32)
    ok, checks = check.verdict(check.numbers([(prog, ref)]), _limits(CELL),
                               0)
    assert ok, checks
