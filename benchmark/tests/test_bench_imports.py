"""Nothing the harness runs loads jax, jaxlib, flax or tomojax (top-level
names compared whole: tomojax_torch begins with tomojax), and the
reference loads nothing of tomojax_torch."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark.tests.tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "tomojax"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    top = _loaded("import benchmark.reference, benchmark.reference.plain")
    assert not top & (FORBIDDEN | {"tomojax_torch"})


def test_a_whole_run_loads_no_jax():
    code = (
        "import time, tempfile, pathlib, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "from benchmark.tests.tiny import tiny_root\n"
        "root = tiny_root(pathlib.Path(tempfile.mkdtemp()))\n"
        "for cell in ('haadf256.fista', 'haadf256.live_cs'):\n"
        "    harness.run(cell, 3, 0.2, False, 'cpu', time.perf_counter(),\n"
        "                root=root, bench=root / 'benchmark',\n"
        "                log=lambda s: None)\n")
    top = _loaded(code)
    assert "tomojax_torch" in top
    assert not top & FORBIDDEN


def test_no_source_of_the_benchmark_imports_them():
    for path in (REPO / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & FORBIDDEN, (path, tops)
            if "reference" in path.parts:
                assert "tomojax_torch" not in tops, path
