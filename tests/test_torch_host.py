"""The port's host boundary (`tomojax_torch.host`) and the slab rule
(`tomojax_torch.dist.slab`) on the CPU: `read_scalars` gives the floats
``float()`` gives, in one counted read; every public read site goes through
`to_host`, one ``api.d2h`` span and one read each; `slab` is the cut that
`pad_slices` and `shard_global` make."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tomojax_torch import (
    DynamicReconstructor, Simulator, TomoTorch, host, profiling,
)
from tomojax_torch.dist import (
    Slab, SlabGroup, init_distributed, pad_slices, shard_global, slab,
)

NS, N, NA = 4, 16, 6
DEG = np.linspace(-60.0, 60.0, NA)
SUBNORMAL = float(np.float32(1e-40))


def _recorded(call):
    """(call's result, the spans recorded while it ran under the CPU
    profiler)."""
    profiling.recorded().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = call()
    spans = list(profiling.recorded().spans)
    profiling.recorded().clear()
    return out, spans


def _bits(values) -> np.ndarray:
    return np.asarray(values, np.float64).view(np.uint64)


@pytest.mark.parametrize("values", [
    (1.5,),
    (-2.25, 0.0),
    (SUBNORMAL, -0.0, 3.0e38),
    (float("inf"), -float("inf"), 1.0 / 3.0, -7.0),
    (0.1, -SUBNORMAL, 2.0 ** -126, 12345.678, float("inf")),
])
def test_read_scalars_gives_float_of_each_in_one_read(values):
    ts = [torch.tensor(v, dtype=torch.float32) for v in values]
    want = tuple(float(t) for t in ts)
    got, spans = _recorded(lambda: host.read_scalars(*ts))
    assert isinstance(got, tuple) and len(got) == len(values)
    assert all(type(v) is float for v in got)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert [(s.name, s.counts) for s in spans] == [("solvers.read",
                                                    {"reads": 1})]


def _series(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (NS, N, NA)).astype(np.float32)


def _tomo():
    return TomoTorch(DEG, _series(1), device="cpu")


def _simulator(group=None):
    vol = np.random.default_rng(2).uniform(0.0, 1.0, (NS, N, N))
    sim = (Simulator(vol, DEG, device="cpu") if group is None
           else Simulator(vol, DEG, group=group))
    return sim.sirt(Niter=2)


def _live(tmp_path):
    rec = DynamicReconstructor(N, NA, device="cpu",
                               checkpoint_path=str(tmp_path / "live.h5"))
    series = _series(3)
    rec.add_projections([(float(DEG[k]), series[:, :, k])
                         for k in range(NA)])
    rec.iterate(2)
    return rec


# public read site -> (the call, from what is built outside the profiler;
# its "api.d2h" spans)
SITES = {
    "data_distance": (lambda tmp: _tomo().sirt(Niter=2).data_distance, 1),
    "tv": (lambda tmp: _tomo().sirt(Niter=2).tv, 1),
    "lipschitz": (lambda tmp: _tomo().lipschitz, 1),
    "cgls": (lambda tmp: (lambda t=_tomo(): t.cgls(Niter=2)), 1),
    # the sinogram's maximum, then the cost vector
    "kl_divergence": (
        lambda tmp: (lambda t=_tomo(): t.kl_divergence(Niter=2)), 2),
    "Simulator.rmse": (lambda tmp: _simulator().rmse, 1),
    "DynamicReconstructor.get_recon": (lambda tmp: _live(tmp).get_recon,
                                       1),
    "DynamicReconstructor.checkpoint": (lambda tmp: _live(tmp).checkpoint,
                                        1),
}


def _check_reads(spans, n_d2h: int) -> None:
    d2h = [s for s in spans if s.name == "api.d2h"]
    assert len(d2h) == n_d2h
    assert all(s.counts == {"reads": 1} for s in d2h)
    assert sum(s.counts.get("reads", 0) for s in spans) == n_d2h


@pytest.mark.parametrize("site", list(SITES))
def test_public_read_sites_read_through_to_host(site, tmp_path):
    make, n_d2h = SITES[site]
    call = make(tmp_path)
    _, spans = _recorded(call)
    _check_reads(spans, n_d2h)


def test_simulator_rmse_with_a_group_reads_through_to_host(tmp_path):
    """The group branch of `Simulator.rmse` (gloo, world size 1): its real
    slices cut by `slab`, one read, the unsharded value."""
    import torch.distributed as dist

    group = init_distributed(f"file://{tmp_path / 'store'}", 1, 0, "cpu")
    try:
        sim = _simulator(group)
        got, spans = _recorded(sim.rmse)
    finally:
        dist.destroy_process_group()
    _check_reads(spans, 1)
    assert got == pytest.approx(_simulator().rmse(), rel=1e-6)


@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("ns", range(1, 10))
def test_slab_is_the_cut_of_pad_slices_and_shard_global(ns, size):
    whole = torch.arange(1, ns + 1, dtype=torch.float32)
    padded = np.concatenate([whole.numpy(),
                             np.zeros((-ns) % size, np.float32)])
    blocks = np.split(padded, size)
    assert slab(ns, None) == Slab(0, ns, ns)
    for r in range(size):
        g = SlabGroup(r, size, torch.device("cpu"))
        s = slab(ns, g)
        cut = shard_global(pad_slices(whole, g)[0], g).numpy()
        np.testing.assert_array_equal(cut, blocks[r])
        assert (s.lo, s.n) == (r * len(blocks[r]), len(blocks[r]))
        want = np.zeros(s.n, np.float32)
        want[:s.real] = np.arange(s.lo + 1, s.lo + s.real + 1)
        np.testing.assert_array_equal(cut, want)
