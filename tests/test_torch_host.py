"""The port's host boundary (`tomojax_torch.host`) and the slab rule
(`tomojax_torch.dist.slab`) on the CPU: `read_scalars` gives the floats
``float()`` gives, in one counted read; every public read site goes through
`to_host`, one ``api.d2h`` span and one read each; on the card a read of
at least 1 MiB lands in pinned memory that the returned array owns; `slab`
is the cut that `pad_slices` and `shard_global` make."""

from __future__ import annotations

import gc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
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


def _same_array(got: np.ndarray, want: np.ndarray) -> None:
    """`got` is `want` bit for bit, with its shape, dtype and strides, and
    writable."""
    assert (got.shape, got.dtype, got.strides) == (want.shape, want.dtype,
                                                   want.strides)
    assert got.flags.writeable
    assert got.tobytes() == want.tobytes()


# (shape, dtype, layout): a cost vector, a single value, a 1 MiB volume
# and a permuted view of 4 MiB
CPU_READS = [((5,), torch.float32, "contiguous"),
             ((), torch.float64, "contiguous"),
             ((64, 64, 64), torch.float32, "contiguous"),
             ((64, 128, 128), torch.float32, "permuted")]


def _tensor(shape, dtype, layout, device="cpu", seed=0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=g, dtype=dtype).to(device)
    return t.permute(2, 0, 1) if layout == "permuted" else t


@pytest.mark.parametrize("shape,dtype,layout", CPU_READS)
def test_to_host_of_a_cpu_tensor_is_its_numpy(shape, dtype, layout):
    t = _tensor(shape, dtype, layout)
    got, spans = _recorded(lambda: host.to_host(t))
    _same_array(got, t.cpu().numpy())
    assert [(s.name, s.counts) for s in spans] == [("api.d2h",
                                                    {"reads": 1})]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (shape, layout): 2**26 B, and 1 MiB + 4 KiB (not a power of two) with
# its strides permuted
PINNED_READS = [((256, 256, 256), "contiguous"),
                ((257, 32, 32), "permuted")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", PINNED_READS)
def test_to_host_of_a_large_cuda_tensor_lands_in_pinned_memory(shape,
                                                                layout):
    t = _tensor(shape, torch.float32, layout, _cuda())
    assert t.numel() * t.element_size() >= host.PINNED_MIN_BYTES
    got, spans = _recorded(lambda: host.to_host(t))
    _same_array(got, t.cpu().numpy())
    assert torch.from_numpy(got).is_pinned()
    assert [(s.name, s.counts) for s in spans] == [
        ("api.d2h", {"reads": 1, "d2h_pinned": 1})]


@pytest.mark.cuda
def test_to_host_of_a_small_cuda_tensor_stays_pageable():
    t = _tensor((255, 32, 32), torch.float32, "contiguous", _cuda())
    assert t.numel() * t.element_size() < host.PINNED_MIN_BYTES
    got, spans = _recorded(lambda: host.to_host(t))
    _same_array(got, t.cpu().numpy())
    assert not torch.from_numpy(got).is_pinned()
    assert [(s.name, s.counts) for s in spans] == [("api.d2h",
                                                    {"reads": 1})]


@pytest.mark.cuda
def test_a_kept_result_is_not_reused_by_a_later_read():
    """The returned array owns its pinned block: a later read of the same
    size, once the device tensor is gone, writes elsewhere; after the
    array is dropped, its block may be reused and reads stay right."""
    dev = _cuda()
    shape = (64, 128, 128)
    t1 = _tensor(shape, torch.float32, "contiguous", dev, seed=1)
    want1 = t1.cpu().numpy()
    a = host.to_host(t1)
    del t1
    gc.collect()
    t2 = _tensor(shape, torch.float32, "contiguous", dev, seed=2)
    b = host.to_host(t2)
    _same_array(a, want1)
    _same_array(b, t2.cpu().numpy())
    del a
    gc.collect()
    t3 = _tensor(shape, torch.float32, "contiguous", dev, seed=3)
    c = host.to_host(t3)
    _same_array(c, t3.cpu().numpy())
    _same_array(b, t2.cpu().numpy())


PINNED_METRIC = "api.d2h_pinned_per_job.recon"


def _jobs(pinned: list) -> list:
    """The spans of one job per entry of `pinned`: a FISTA call with a
    cost read, then get_recon's read, pinned where the entry is true."""
    out = []
    for k, p in enumerate(pinned):
        i = 10 * k
        recon = {"reads": 1, "d2h_pinned": 1} if p else {"reads": 1}
        for name, sid, parent, counts in (
                ("api.d2h", i + 2, i + 1, {"reads": 1}),
                ("api.fista", i + 1, None, {}),
                ("api.d2h", i + 4, i + 3, recon),
                ("api.get_recon", i + 3, None, {})):
            out.append(types.SimpleNamespace(name=name, id=sid,
                                             parent=parent, counts=counts))
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


@pytest.mark.parametrize("pinned,want", [([True] * 3, 1.0),
                                         ([True, False], 0.5)])
def test_reader_gives_pinned_reads_per_job(store, pinned, want):
    store.spans = _jobs(pinned)
    assert harness.reader(PINNED_METRIC).read(_ctx()) == want


def test_pinned_reader_gives_none_where_there_is_nothing_to_read(
        store, monkeypatch):
    read = harness.reader(PINNED_METRIC).read
    store.spans = _jobs([True, True])
    assert read(_ctx(device="cpu")) is None
    assert read(_ctx(traced=False)) is None
    store.spans = _jobs([False, False])
    assert read(_ctx()) is None  # a port without the pinned route
    store.spans = [s for s in _jobs([True]) if s.name != "api.get_recon"]
    assert read(_ctx()) is None
    store.spans = []
    assert read(_ctx()) is None
    monkeypatch.delattr(profiling, "recorded")
    assert read(_ctx()) is None


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
