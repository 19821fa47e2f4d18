"""The 1024-class deployment `haadf1024` and its cells `haadf1024.fista`
and `haadf1024.asd_pocs`.

On the CPU: K8's route at the cells' planes (resident at all three: the
spilling (16, 1) shape at 1024², 13 band rows a block in device memory);
K1's plan at 77 tilts (31 angle groups at 1024², 10 at
256²); the counters `fp_angles` and `fp_groups` that each K1 launch makes
in the innermost open span, against a stand-in for the kernel library on
the CUDA branch of `fp_sl` and `fp_resid_sl`, and their absence off the
profiler and on the plain path; the reader
`projector.fp_angles_per_group.recon` on a synthetic store; both cells at
the tiny size of `benchmark/tests/tiny.py` through `harness.run`, in this
process and in a clean interpreter (no module of jax loaded); the
bfloat16 control against the cells' limits; the configuration file's cut.
On the card (`cuda`): `TomoTorch.fista` and `TomoTorch.asd_pocs` at 1024²
planes over a few slices, at the cells' 77 tilts, against the benchmark's
plain reference under the cells' limits.

This file imports no jax, so that its `cuda` tests run on the card."""

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
from tomojax_torch.projector import cuda_joseph
from tomojax_torch.solvers import cuda_sart

CELLS = ["haadf1024.fista", "haadf1024.asd_pocs"]
METRIC = "projector.fp_angles_per_group.recon"
SEED = 2**31 + 31  # a seed past 32 signed bits
CONFIG = REPO / "benchmark" / "configs" / "haadf1024.json"
TILTS = np.linspace(-76, 76, 77)


def _limits(cell):
    return json.loads((REPO / "benchmark" / "cells" /
                       f"{cell}.json").read_text())["limits"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


# ------------------------------------------------- the route and the plan


@pytest.mark.parametrize("n, shape, spilled", [(1024, (16, 1), 13),
                                              (512, (16, 2), 0),
                                              (256, (8, 4), 0)])
def test_k8_route_at_the_cells_planes(n, shape, spilled):
    """No staged cluster shape holds a 1024² plane's share (825,344 B at
    (16, 2) against 227 KB), so K8 runs the spilling (16, 1) shape there:
    51 band rows a block in shared memory (230,192 B), 13 in device
    memory."""
    assert cuda_sart.sart_route(n, n) == "resident"
    assert cuda_sart.sart_shape(n, n) == shape
    assert cuda_sart.route_spill_rows(n, n) == spilled
    staged = (cuda_sart.resident_smem_bytes(n, n, 16, 2)
              <= cuda_sart.RESIDENT_SMEM_MAX)
    assert staged is (n <= 512)
    spill = cuda_sart.K8_SPILL[cuda_sart.K8_SHAPES.index(shape)]
    assert spill is (n == 1024)
    assert (cuda_sart.resident_smem_bytes(n, n, *shape, spill)
            <= cuda_sart.RESIDENT_SMEM_MAX)


@pytest.mark.parametrize("n, groups", [(1024, 31), (512, 17), (256, 10)])
def test_k1_plan_at_77_tilts(n, groups):
    """Fewer angles share a window of x as the planes widen: 7.7 angles a
    group at 256², 2.48 at 1024²; every window within K1's ring."""
    plan = cuda_joseph.fp_plan(Geometry.make(n, np.deg2rad(TILTS)),
                               torch.device("cpu"))
    assert plan.ng == groups
    assert plan.groups[:, 1].sum() == len(TILTS)
    assert plan.width <= cuda_joseph.FP_WINDOW


# ------------------------------------------------- the counters in a span


class _FakeLib:
    """Stands in for the kernel library: records K1's launches (plan
    groups handed over), launches nothing."""

    def __init__(self):
        self.calls = []

    def tj_fp(self, *args):
        # x, tab, plan, ng, width, ax, n, nt, na, ns, stream
        self.calls.append(("tj_fp", args[3]))
        return 0

    def tj_fp_resid_partials(self, nt, na, ns):
        return 1

    def tj_fp_resid(self, *args):
        # x, tab, plan, ng, width, b, ax_old, inv_row, beta, ax, resid,
        # partials, ddsq, n, nt, na, ns, stream
        self.calls.append(("tj_fp_resid", args[3]))
        return 0


@pytest.fixture
def card_branch(monkeypatch):
    """K1's wrappers on their CUDA branch with CPU tensors: the device
    check reports the card, the library is the stand-in."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "on_cpu", lambda *a: False)
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    return fake


def _k1_calls(n, ns=1):
    """Both K1 wrappers once at n² planes and the cells' 77 tilts."""
    geom = Geometry.make(n, np.deg2rad(TILTS))
    f = torch.float32
    x = torch.zeros((n, n, ns), dtype=f)
    sino = torch.zeros((len(TILTS), n, ns), dtype=f)

    def calls():
        cuda_joseph.fp_sl(x, geom)
        cuda_joseph.fp_resid_sl(x, geom, sino, sino,
                                torch.ones((len(TILTS), n), dtype=f),
                                torch.tensor(0.5))
    return calls


def _profiled(fn):
    profiling.recorded().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("solvers.iteration"):
            fn()
    spans = list(profiling.recorded().spans)
    profiling.recorded().clear()
    return spans


@pytest.mark.parametrize("n, groups", [(1024, 31), (256, 10)])
def test_each_k1_launch_counts_its_angles_and_groups(card_branch, n,
                                                     groups):
    calls = _k1_calls(n)
    calls()  # the plan's build, outside any span
    spans = _profiled(calls)
    assert card_branch.calls == [("tj_fp", groups),
                                 ("tj_fp_resid", groups)] * 2
    it, = spans
    assert it.counts == {"fp_angles": 2 * len(TILTS),
                         "fp_groups": 2 * groups}


def test_off_the_profiler_nothing_is_counted(card_branch):
    calls = _k1_calls(256)
    profiling.recorded().clear()
    before = cuda_joseph.fp_sl.launches, cuda_joseph.fp_resid_sl.launches
    calls()
    assert list(profiling.recorded().spans) == []
    assert (cuda_joseph.fp_sl.launches,
            cuda_joseph.fp_resid_sl.launches) == (before[0] + 1,
                                                  before[1] + 1)


def test_the_plain_path_counts_nothing():
    calls = _k1_calls(16)
    before = cuda_joseph.fp_sl.launches, cuda_joseph.fp_resid_sl.launches
    it, = _profiled(calls)
    assert "fp_angles" not in it.counts and "fp_groups" not in it.counts
    assert (cuda_joseph.fp_sl.launches,
            cuda_joseph.fp_resid_sl.launches) == before


# ------------------------------------------------------------- the reader


def _span(name, sid, parent, **counts):
    return types.SimpleNamespace(name=name, id=sid, parent=parent, root=1,
                                 start_ns=0, end_ns=1, inner_ns=0,
                                 counts=counts)


def _job(per_launch, launches=3):
    """A job of `launches` iterations, each one K1 launch counting
    `per_launch` (angles, groups)."""
    out = [_span("api.fista", 1, None)]
    angles, groups = per_launch
    for i in range(launches):
        out.append(_span("solvers.iteration", 10 + i, 1, fp_angles=angles,
                         fp_groups=groups, reads=0))
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


@pytest.mark.parametrize("per_launch, want", [((77, 31), 77 / 31),
                                              ((77, 10), 7.7),
                                              ((9, 6), 1.5)])
def test_reader_gives_angles_per_group(store, per_launch, want):
    store.spans = _job(per_launch)
    assert harness.reader(METRIC).read(_ctx()) == pytest.approx(want)


def test_reader_weighs_launches_of_two_geometries(store):
    """A fusion job: 77 HAADF tilts in 10 groups and 9 chemistry tilts in
    6, so Σ angles ÷ Σ groups lies between the two."""
    store.spans = _job((77, 10), 1) + [
        _span("solvers.iteration", 20, 1, fp_angles=9, fp_groups=6)]
    assert harness.reader(METRIC).read(_ctx()) == pytest.approx(86 / 16)


def test_reader_gives_none_where_there_is_nothing_to_read(store,
                                                          monkeypatch):
    read = harness.reader(METRIC).read
    store.spans = _job((77, 31))
    assert read(_ctx(device="cpu")) is None
    assert read(_ctx(traced=False)) is None
    store.spans = [_span("solvers.iteration", 2, None, reads=1)]
    assert read(_ctx()) is None  # a port that counts no groups
    store.spans = []
    assert read(_ctx()) is None
    store.spans, store.spans_dropped = _job((77, 31)), 1
    assert read(_ctx()) is None  # the window's spans are not all there
    monkeypatch.delattr(profiling, "recorded")
    assert read(_ctx()) is None


# ----------------------------------------------- the cells on the CPU


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_at_the_tiny_size(root, cell, capsys):
    result = harness.run(cell, SEED, 0.5, False, "cpu", time.perf_counter(),
                         root=root, bench=root / "benchmark",
                         log=lambda s: None)
    run.emit(result)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"recon_s", "setup_s"}
    assert set(line["checks"]) == set(_limits(cell))
    spec = harness.load(cell, root, root / "benchmark")
    per = {p["name"] for p in spec.per_layer}
    assert (METRIC in per) is (cell == "haadf1024.fista")
    assert ("sart.launches_per_sweep.recon" in per) is (
        cell == "haadf1024.asd_pocs")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_no_jax_in_a_clean_interpreter(root, cell):
    """The tiny cell, traced, in a fresh interpreter: correct, and no
    module of jax, jaxlib, flax or tomojax loaded (this test process has
    jax)."""
    code = (
        "import json, sys, time, torch\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "torch.set_num_threads(2)\n"
        "root = Path(sys.argv[1])\n"
        f"r = harness.run({cell!r}, {SEED}, 0.2, True, 'cpu', "
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


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_under_the_cells_limits(root, cell):
    spec = harness.load(cell, root, root / "benchmark")
    assert spec.limits == _limits(cell)
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
    entry = next(c for c in manifest["configs"] if c["name"] == "haadf1024")
    assert cfg["reduced"] == entry["reduced"] == ["nslice"]
    assert cfg["source"] == entry["source"]
    assert "results/bench_1024.json" in cfg["source"]
    assert (cfg["nslice"], cfg["n"]) == (64, 1024)
    assert cfg["published"] == {"nslice": 1024}
    assert "1024 x 1024^2" in cfg["deployment"]
    assert cfg["series"]["haadf"] == {
        "angles": {"start": -76.0, "stop": 76.0, "num": 77},
        "snr": 200, "background": 1.0}
    assert cfg["phantom"] == {"kind": "nanocube", "seed": 0}
    haadf256 = json.loads((REPO / "benchmark" / "configs" /
                           "haadf256.json").read_text())
    haadf512 = json.loads((REPO / "benchmark" / "configs" /
                           "haadf512.json").read_text())
    assert cfg["precision"] == haadf256["precision"]
    assert cfg["solvers"] == {
        "TomoTorch": {},
        "fista": {"Niter": 50, "lambda_param": 0.1, "nTViter": 10},
        "asd_pocs": haadf512["solvers"]["asd_pocs"]}
    assert set(cfg["assumed"]) == {"tilts", "snr", "detector"}
    cells = {w["name"]: w for w in manifest["workloads"]}
    for cell, traffic in zip(CELLS, ("fista", "asd_pocs")):
        w = cells[cell]
        assert (w["config"], w["traffic"], w["chips"]) == ("haadf1024",
                                                           traffic, 1)


# ------------------------------------------------------------ the card


def _card_inputs(nslice: int, solver: str, niter: int):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = json.loads(CONFIG.read_text())
    cfg["nslice"] = nslice
    cfg["solvers"][solver]["Niter"] = niter
    inp, = data.make(cfg, SEED, 1, dev)
    return cfg, inp, dev


def _against_reference(cfg, inp, dev, prog, reference, cell):
    from benchmark import found

    ref = found.module("reference", reference).run(
        inp, cfg["solvers"], dev, torch.float32)
    ok, checks = check.verdict(check.numbers([(prog, ref)]), _limits(cell),
                               0)
    assert ok, checks


@pytest.mark.cuda
def test_fista_at_1024_planes_matches_the_reference_on_card():
    """TomoTorch.fista (10 iterations) at 8 x 1024^2 x 77: K1 on its 31
    angle groups, as the traced spans count them."""
    from tomojax_torch import TomoTorch

    cfg, inp, dev = _card_inputs(8, "fista", 10)
    def k1_launches():
        return cuda_joseph.fp_sl.launches + cuda_joseph.fp_resid_sl.launches

    profiling.recorded().clear()
    before = k1_launches()
    with profile(activities=[ProfilerActivity.CPU]):
        tomo = TomoTorch(inp["angles"], inp["series"], device=dev)
        tomo.fista(**cfg["solvers"]["fista"])
        prog = {"recon": tomo.get_recon(), "cost": np.asarray(tomo.cost)}
    spans = list(profiling.recorded().spans)
    profiling.recorded().clear()
    launches = k1_launches() - before
    assert launches >= 10
    assert sum(s.counts.get("fp_groups", 0) for s in spans) == 31 * launches
    assert sum(s.counts.get("fp_angles", 0) for s in spans) == 77 * launches
    _against_reference(cfg, inp, dev, prog, "fista", "haadf1024.fista")


@pytest.mark.cuda
def test_asd_pocs_at_1024_planes_matches_the_reference_on_card():
    """TomoTorch.asd_pocs (4 iterations) at 8 x 1024^2 x 77: K8 on its
    spilling (16, 1) shape, 1 launch a sweep, 13 band rows a block in
    device memory as the traced spans count them."""
    from tomojax_torch import TomoTorch

    cfg, inp, dev = _card_inputs(8, "asd_pocs", 4)
    assert cuda_sart.sart_shape(1024, 1024) == (16, 1)
    profiling.recorded().clear()
    before = cuda_sart.sart_sweep_sl.launches
    with profile(activities=[ProfilerActivity.CPU]):
        tomo = TomoTorch(inp["angles"], inp["series"], device=dev)
        tomo.asd_pocs(**cfg["solvers"]["asd_pocs"])
        prog = {"recon": tomo.get_recon(),
                "dd_vec": np.asarray(tomo.dd_vec),
                "tv_vec": np.asarray(tomo.tv_vec)}
    spans = [s for s in profiling.recorded().spans
             if s.name == "solvers.sart"]
    profiling.recorded().clear()
    assert cuda_sart.sart_sweep_sl.launches == before + 4 * 1
    assert len(spans) == 4
    assert [s.counts["sart_launches"] for s in spans] == [1] * 4
    assert [s.counts["sart_spill_rows"] for s in spans] == [13] * 4
    _against_reference(cfg, inp, dev, prog, "asd_pocs",
                       "haadf1024.asd_pocs")
