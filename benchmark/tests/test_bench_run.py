"""End-to-end runs of every cell at a tiny size on the CPU, through the
port's plain path: the result line, correctness under the cells' own
limits, and each fault a cell can have coming out not correct."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.tests.tiny import tiny_root

CELLS = ["haadf256.fista", "haadf256.asd_pocs", "chem2el128.fusion",
         "haadf256.live_cs"]
SEED = 2**31 + 17  # past 32 signed bits, as the driver's seeds are


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, traced=False, seconds=0.5):
    return harness.run(cell, SEED, seconds, traced, "cpu",
                       time.perf_counter(), root=root,
                       bench=root / "benchmark", log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(root, cell, capsys):
    result = _run(root, cell)
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    cellspec = harness.load(cell, root, root / "benchmark")
    assert set(line["metrics"]) == {e["name"] for e in cellspec.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert err.strip().splitlines()[-1].startswith("check ")
    assert harness.forbidden_modules() == []


def test_traced_run_reports_no_device_metric_off_the_card(root):
    result = _run(root, "haadf256.fista", traced=True)
    assert result["correct"] is True
    assert result["metrics"] == {}  # no card: no trace, no roofline
    assert "busy_s" not in result["device"]


def _broken_batch(monkeypatch, fault):
    from tomojax_torch import api

    if fault == "unchanged":  # each step returns the state it was given
        monkeypatch.setattr(api, "fista_run_sl", lambda st, b, s, lam, n,
                            *a, **k: (st, torch.zeros(n, 3)))
        monkeypatch.setattr(api, "asd_pocs_host_loop", lambda x, b, s, w, p,
                            *a: (x, *np.zeros((3, p.niter), np.float32)))
        zero = torch.zeros(())
        monkeypatch.setattr(api, "data_fusion_step",
                            lambda x, *a: (x, zero, zero))
        return
    get_t, get_c = api.TomoTorch.get_recon, api.ChemicalTomo.get_recon

    def wrap(get, axis):
        def broken(self):
            v = np.array(get(self))
            n = v.shape[axis]
            if fault == "half":  # half of the slices left out
                np.moveaxis(v, axis, 0)[n // 2:] = 0
            else:  # one slice altered where the answer is produced
                np.moveaxis(v, axis, 0)[n // 2] *= 1.05
            return v
        return broken

    monkeypatch.setattr(api.TomoTorch, "get_recon", wrap(get_t, 0))
    monkeypatch.setattr(api.ChemicalTomo, "get_recon", wrap(get_c, 1))


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS[:3])
def test_batch_faults_are_not_correct(root, cell, fault, monkeypatch):
    _broken_batch(monkeypatch, fault)
    assert _run(root, cell)["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_live_faults_are_not_correct(root, fault, monkeypatch):
    from tomojax_torch import stream

    orig = stream.DynamicReconstructor.iterate_cs

    def broken(self, **kw):
        if fault == "unchanged":  # the round leaves the volume as it was
            self._system()
            self._volume()
            return 1.0
        dd = orig(self, **kw)
        if fault == "half":  # half of the slices left out
            self._x[..., self._x.shape[-1] // 2:] = 0
            return dd
        return dd * 1.05  # the round's answer altered

    monkeypatch.setattr(stream.DynamicReconstructor, "iterate_cs", broken)
    assert _run(root, "haadf256.live_cs")["correct"] is False
