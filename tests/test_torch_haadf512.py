"""The 512-class deployment `haadf512` and its cell `haadf512.asd_pocs`.

On the CPU: K8's route at the cell's shape (resident (16, 2) at 512²,
(8, 4) at 256²); the `solvers.sart` span and its `sart_launches` counter,
against a stand-in for the kernel library on the CUDA branch of
`sart_sweep_sl`; the reader `sart.launches_per_sweep.recon` on a
synthetic store; the cell at the tiny size of `benchmark/tests/tiny.py`
through `harness.run`, in this process and in a clean interpreter (no
module of jax loaded); the bfloat16 control against the cell's limits;
the configuration file's cut. On the card (`cuda`): `TomoTorch.asd_pocs`
at a shape of each of the routes that no 256² cell takes, resident (16, 2)
and streaming, against the benchmark's plain reference under the cell's
limits.

This file imports no jax, so that its `cuda` test runs on the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import calibrate, check, data, harness, run
from benchmark.tests.tiny import REPO, tiny_root
from tomojax_torch import _build, profiling
from tomojax_torch.geometry import Geometry
from tomojax_torch.solvers import cuda_sart

CELL = "haadf512.asd_pocs"
METRIC = "sart.launches_per_sweep.recon"
SEED = 2**31 + 29  # a seed past 32 signed bits
CONFIG = REPO / "benchmark" / "configs" / "haadf512.json"
LIMITS = json.loads((REPO / "benchmark" / "cells" /
                     f"{CELL}.json").read_text())["limits"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


# ------------------------------------------------------------- the route


@pytest.mark.parametrize("n, shape", [(512, (16, 2)), (256, (8, 4))])
def test_route_at_the_cells_planes(n, shape):
    assert cuda_sart.sart_route(n, n) == "resident"
    assert cuda_sart.sart_shape(n, n) == shape


# ------------------------------------------------- the span and counter


class _FakeLib:
    """Stands in for the kernel library: records each tj_sart_sweep call's
    steps and whether it was handed a scratch (the streaming route's
    residual plane or the spilling shape's band rows), launches
    nothing."""

    def __init__(self):
        self.calls = []

    def tj_sart_sweep(self, *args):
        # x, fp_tab, bp_tab, b, inv_row, inv_col_a, beta, order, steps,
        # scratch, out, n, nt, na, ns, stream
        self.calls.append((args[8], args[9] is not None))
        return 0


@pytest.fixture
def card_branch(monkeypatch):
    """`sart_sweep_sl` on its CUDA branch with CPU tensors: the operand
    check reports the card, the library is the stand-in."""
    fake = _FakeLib()
    monkeypatch.setattr(cuda_sart, "_checked_on_cpu", lambda *a: False)
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    return fake


def _operands(n, na=5, ns=2, steps=None):
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    f = torch.float32
    return (torch.zeros((n, n, ns), dtype=f),
            torch.zeros((na, n, ns), dtype=f), geom,
            torch.ones((na, n), dtype=f), torch.ones((na, n, n), dtype=f),
            torch.tensor(0.25),
            torch.arange(steps or na, dtype=torch.int32))


def _profiled(fn):
    profiling.recorded().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    spans = list(profiling.recorded().spans)
    profiling.recorded().clear()
    return spans


@pytest.mark.parametrize("n, steps, want, spilled",
                         [(1056, 5, 10, 0), (1056, 3, 6, 0), (256, 5, 1, 0),
                          (512, 5, 1, 0), (512, 3, 1, 0), (544, 5, 1, 0),
                          (1024, 5, 1, 13), (1024, 3, 1, 13)])
def test_a_sweep_counts_its_launches_in_its_span(card_branch, n, steps,
                                                 want, spilled):
    """1 launch a sweep on every resident shape (N <= 1052), 2 a step
    streaming; the streaming route is handed a residual plane and the
    spilling shape, where rows spill (N >= 919), its band rows; the span
    counts the rows a block spills."""
    args = _operands(n, steps=steps)
    before = cuda_sart.sart_sweep_sl.launches
    spans = _profiled(lambda: cuda_sart.sart_sweep_sl(*args))
    assert card_branch.calls == [(steps, n > 1052 or spilled > 0)]
    sart = [s for s in spans if s.name == "solvers.sart"]
    assert len(sart) == 1
    # a first sweep at a geometry also counts the angle tables' build
    assert sart[0].counts["sart_launches"] == want
    assert sart[0].counts["sart_spill_rows"] == spilled
    assert set(sart[0].counts) <= {"sart_launches", "sart_spill_rows",
                                   "plan_builds"}
    assert sum(s.counts.get("sart_launches", 0) for s in spans) == want
    assert cuda_sart.sart_sweep_sl.launches == before + want


def test_off_the_profiler_nothing_is_recorded(card_branch):
    args = _operands(1056)
    profiling.recorded().clear()
    before = cuda_sart.sart_sweep_sl.launches
    cuda_sart.sart_sweep_sl(*args)
    assert list(profiling.recorded().spans) == []
    assert cuda_sart.sart_sweep_sl.launches == before + 10


def test_off_the_profiler_a_resident_sweep_at_512_counts_one(card_branch):
    args = _operands(512)
    profiling.recorded().clear()
    before = cuda_sart.sart_sweep_sl.launches
    cuda_sart.sart_sweep_sl(*args)
    assert list(profiling.recorded().spans) == []
    assert card_branch.calls == [(5, False)]
    assert cuda_sart.sart_sweep_sl.launches == before + 1


def test_the_plain_path_counts_no_launch():
    args = _operands(16, na=3, ns=1)
    before = cuda_sart.sart_sweep_sl.launches
    spans = _profiled(lambda: cuda_sart.sart_sweep_sl(*args))
    assert not any(s.name == "solvers.sart" for s in spans)
    assert cuda_sart.sart_sweep_sl.launches == before


# ------------------------------------------------------------- the reader


def _span(name, sid, parent, **counts):
    return types.SimpleNamespace(name=name, id=sid, parent=parent, root=1,
                                 start_ns=0, end_ns=1, inner_ns=0,
                                 counts=counts)


def _iterations(launches, iters=3):
    """`iters` iterations of a host loop, a sweep of `launches` each."""
    out = [_span("api.asd_pocs", 1, None)]
    for i in range(iters):
        it = 10 + 3 * i
        out += [_span("solvers.iteration", it, 1),
                _span("solvers.sart", it + 1, it, sart_launches=launches),
                _span("solvers.read", it + 2, it, reads=5)]
    return out


@pytest.fixture
def store(monkeypatch):
    fake = types.SimpleNamespace(spans=[], spans_dropped=0)
    monkeypatch.setattr(profiling, "recorded", lambda: fake)
    return fake


def _ctx(device="cuda", traced=True):
    trace = types.SimpleNamespace(window_s=1.0) if traced else None
    return types.SimpleNamespace(trace=trace, calls={},
                                 device=torch.device(device))


@pytest.mark.parametrize("launches", [154, 1])
def test_reader_gives_launches_per_sweep(store, launches):
    store.spans = _iterations(launches)
    assert harness.reader(METRIC).read(_ctx()) == float(launches)


def test_reader_gives_none_where_there_is_nothing_to_read(store,
                                                          monkeypatch):
    read = harness.reader(METRIC).read
    store.spans = _iterations(154)
    assert read(_ctx(device="cpu")) is None
    assert read(_ctx(traced=False)) is None
    store.spans = [s for s in _iterations(154) if s.name != "solvers.sart"]
    assert read(_ctx()) is None  # a port that records no such span
    store.spans = []
    assert read(_ctx()) is None
    monkeypatch.delattr(profiling, "recorded")
    assert read(_ctx()) is None


# ----------------------------------------------- the cell on the CPU


def test_cell_runs_and_is_correct_at_the_tiny_size(root, capsys):
    result = harness.run(CELL, SEED, 0.5, False, "cpu", time.perf_counter(),
                         root=root, bench=root / "benchmark",
                         log=lambda s: None)
    run.emit(result)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"recon_s", "setup_s"}
    assert set(line["checks"]) == set(LIMITS)
    cell = harness.load(CELL, root, root / "benchmark")
    assert METRIC in {p["name"] for p in cell.per_layer}


def test_cell_loads_no_jax_in_a_clean_interpreter(root):
    """The tiny cell run in a fresh interpreter: correct, and no module of
    jax, jaxlib, flax or tomojax loaded (this test process has jax)."""
    code = (
        "import json, sys, time, torch\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "torch.set_num_threads(2)\n"
        "root = Path(sys.argv[1])\n"
        f"r = harness.run({CELL!r}, {SEED}, 0.2, True, 'cpu', "
        "time.perf_counter(), root=root, bench=root / 'benchmark', "
        "log=lambda s: None)\n"
        "print(json.dumps({'correct': r['correct'], "
        "'metrics': sorted(r['metrics']), "
        "'forbidden': harness.forbidden_modules()}))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    done = subprocess.run([sys.executable, "-c", code, str(root)],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=env)
    assert done.returncode == 0, done.stderr[-2000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    # traced off the card: no trace, so no per-layer metric
    assert got == {"correct": True, "metrics": [], "forbidden": []}


def test_control_is_not_correct_under_the_cells_limits(root):
    spec = harness.load(CELL, root, root / "benchmark")
    assert spec.limits == LIMITS
    lines = []
    calibrate.readings(spec, [7, 8], [7, 8], torch.device("cpu"),
                       lines.append)
    kinds = [line["kind"] for line in lines if "kind" in line]
    assert kinds == ["program"] * 2 + ["control"] * 2
    for line in lines:
        if "kind" in line:
            ok, _ = check.verdict(line["numbers"], spec.limits, 0)
            assert ok is (line["kind"] == "program"), line


# ----------------------------------------------- the configuration


def test_configuration_states_its_cut():
    cfg = json.loads(CONFIG.read_text())
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in manifest["configs"] if c["name"] == "haadf512")
    assert cfg["reduced"] == entry["reduced"] == ["nslice"]
    assert cfg["source"] == entry["source"]
    assert (cfg["nslice"], cfg["n"]) == (128, 512)
    assert cfg["published"] == {"nslice": 512}
    assert "512 x 512^2" in cfg["deployment"]
    assert cfg["series"]["haadf"]["angles"] == {"start": -76.0,
                                                "stop": 76.0, "num": 77}
    haadf256 = json.loads((REPO / "benchmark" / "configs" /
                           "haadf256.json").read_text())
    assert cfg["solvers"] == {"TomoTorch": {},
                              "asd_pocs": haadf256["solvers"]["asd_pocs"]}
    assert set(cfg["assumed"]) == {"tilts", "snr", "detector"}
    w = next(w for w in manifest["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("haadf512",
                                                       "asd_pocs", 1)


# ------------------------------------------------------------ the card


def _small_job_on_card(n: int, shape, launches_a_sweep: int) -> None:
    """TomoTorch.asd_pocs (4 iterations) at 8 x n^2 x 13 tilts, where K8
    takes cluster shape `shape` (None: streaming), against the
    benchmark's plain reference under the cell's limits, with
    `launches_a_sweep` kernel launches a sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from benchmark import found
    from tomojax_torch import TomoTorch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = json.loads(CONFIG.read_text())
    cfg["nslice"], cfg["n"] = 8, n
    cfg["series"]["haadf"]["angles"]["num"] = 13
    cfg["solvers"]["asd_pocs"]["Niter"] = 4
    assert cuda_sart.sart_shape(n, n) == shape
    inp, = data.make(cfg, SEED, 1, dev)
    before = cuda_sart.sart_sweep_sl.launches
    tomo = TomoTorch(inp["angles"], inp["series"], device=dev)
    tomo.asd_pocs(**cfg["solvers"]["asd_pocs"])
    prog = {"recon": tomo.get_recon(), "dd_vec": np.asarray(tomo.dd_vec),
            "tv_vec": np.asarray(tomo.tv_vec)}
    assert cuda_sart.sart_sweep_sl.launches == before + 4 * launches_a_sweep
    ref = found.module("reference", "asd_pocs").run(
        inp, cfg["solvers"], dev, torch.float32)
    ok, checks = check.verdict(check.numbers([(prog, ref)]), LIMITS, 0)
    assert ok, checks


@pytest.mark.cuda
def test_asd_pocs_on_the_streaming_route_matches_the_reference_on_card():
    """At 8 x 1056^2 x 13, above every resident shape: 2 launches a tilt
    step."""
    _small_job_on_card(1056, None, 2 * 13)


@pytest.mark.cuda
def test_asd_pocs_on_the_spilling_16_1_route_matches_the_reference_on_card():
    """At 8 x 1024^2 x 13, on K8's (16, 1) shape with 13 band rows a block
    in device memory: 1 launch a sweep."""
    _small_job_on_card(1024, (16, 1), 1)


@pytest.mark.cuda
def test_asd_pocs_on_the_resident_16_2_route_matches_the_reference_on_card():
    """At 8 x 320^2 x 13, on K8's (16, 2) cluster shape: 1 launch a
    sweep."""
    _small_job_on_card(320, (16, 2), 1)
