"""The work counts of the roofline metrics against hand-computed values at
small shapes, and the roofline arithmetic on recorded calls."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import layers, work


class G:
    """A geometry as the port's functions take it."""

    def __init__(self, n, angles_deg, nray=None):
        self.n, self.nray = n, nray or n
        self.angles = np.deg2rad(np.asarray(angles_deg, np.float64))
        self.nproj = len(self.angles)


def test_nnz_of_axis_aligned_views():
    # at 0 and 90 degrees every pixel centre falls on a bin centre: one
    # tap of weight 1 (the other has weight 0 and is no nonzero)
    assert work.nnz(G(4, [0.0])) == 16
    assert work.nnz(G(4, [0.0, 90.0])) == 32
    # at 45 degrees J* = (x - y) / sqrt(2) + 1.5: every pixel has two
    # nonzero taps except where a tap falls outside the 4 bins
    n = work.nnz(G(4, [45.0]))
    assert 16 < n <= 32


def test_projector_counts():
    g = G(4, [0.0, 90.0])
    x = torch.zeros(4, 4, 3)
    v, s, p, nnz = 48, 24, 16, 32
    assert work.fp_sl(x, g) == (4 * (v + s), 2 * nnz * 3)
    assert work.bp_sl(torch.zeros(2, 4, 3), g) == (4 * (s + v), 2 * nnz * 3)
    assert work.fp_resid_sl(x, g) == (4 * (v + 4 * s + 8 + 1),
                                      2 * nnz * 3 + 8 * s)
    assert work.bp_sirt_sl(torch.zeros(2, 4, 3), g) == \
        (4 * (s + 2 * v + p), 2 * nnz * 3 + 3 * v)
    sweep = work.sart_sweep_sl(x, None, g, None, None, None, None)
    assert sweep == (4 * (2 * 16 * 3 + 2 * 4 * 4 + 2 * 16 + 2 + 1),
                     4 * nnz * 3 + 4 * 2 * 16 * 3)


def test_tv_counts():
    x = torch.zeros(2, 3, 5)
    assert work.tv_fgp_fused(x, 10, 0.1) == (8 * 30, (9 * 27 + 8) * 30)
    mom = (x, torch.tensor(0.5))
    assert work.tv_fgp_fused(x, 10, 0.1, mom=mom) == \
        (16 * 30 + 4, (9 * 27 + 8 + 3) * 30)
    assert work.tv_descent(x, 10, 0.1) == (8 * 30, 10 * 29 * 30 + 30)


def test_bound_is_the_larger_of_the_two():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_capture_counts_the_calls_a_caller_makes(monkeypatch):
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.solvers import base

    geom = Geometry.make(8, np.deg2rad(np.linspace(-60, 60, 5)))
    spec = {("tomojax_torch.projector.cuda_joseph", name): work.WORK[name]
            for name in ("fp_sl", "bp_sl")}
    calls = {}
    with layers.capturing(spec, calls):
        base.make_system(geom, "cpu")  # one fp_sl, two bp_sl
    assert base.fp_sl.__name__ == "fp_sl"  # the names are put back
    counts = sorted((k[0], c.count) for k, c in calls.items())
    assert counts == [("bp_sl", 2), ("fp_sl", 1)]

    monkeypatch.setattr(layers, "batch_s", lambda fn, a, kw: 1.0)
    least = sum(c.count * work.bound_s(*c.work(*c.args, **c.kwargs))
                for c in calls.values())
    assert layers.roofline_pct(calls, spec) == pytest.approx(100 * least / 3)
