"""A copy of the benchmark at a tiny size, for the CPU tests: every
configuration cut to 16 rays, a few slices and tilts and 4 iterations,
the cells, traffic files, limits and metric readers as they are."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path) -> Path:
    """A root under `tmp` holding BENCHMARK.json and a tiny benchmark/."""
    root = tmp / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in m["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["n"] = 16
        cfg["nslice"] = 4 if "elements" in cfg else 8
        for s in cfg["series"].values():
            s["angles"]["num"] = max(6, s["angles"]["num"] // 8)
        sv = cfg["solvers"]
        for k in ("fista", "asd_pocs", "chemical_tomography",
                  "data_fusion"):
            if k in sv:
                sv[k]["Niter"] = 4
        if "DynamicReconstructor" in sv:
            sv["DynamicReconstructor"]["nray"] = 16
            sv["DynamicReconstructor"]["max_angles"] = \
                cfg["series"]["haadf"]["angles"]["num"]
        path.write_text(json.dumps(cfg))
    for path in (root / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if t["driver"] == "live":
            # one acquisition of the tiny tilts
            t["warmup_steps"] = max(6, t["warmup_steps"] // 8)
        path.write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root
