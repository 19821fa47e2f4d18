"""tomojax_torch's auxiliary modules held against tomojax: the TV extras
(`tv.extras`), `profiling`, `viz` and the reconstructors' plotting
methods, the package helpers `device_count` / `determine_config`, and
`projector.sharded` on a gloo group of one, and the autograd pair
`fp_adjointable` / `bp_adjointable`. All on the CPU.

The extras compute the reference's float32 operations on the slice-last
layout, in another axis order: the denoised volumes are held at rtol
1e-5 and 1e-6 of their largest magnitude (measured 2.7e-7 relative), the
TV value of the input at rtol 1e-5 (measured 7.7e-8).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import tomojax  # noqa: E402
from tomojax import profiling as j_profiling  # noqa: E402
from tomojax import viz as j_viz  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector import (  # noqa: E402
    bp_adjointable as j_bp_adj, fp_adjointable as j_fp_adj,
)
from tomojax.tv import extras as j_extras  # noqa: E402

import tomojax_torch  # noqa: E402
from tomojax_torch import ChemicalTomo, Simulator, TomoTorch  # noqa: E402
from tomojax_torch import profiling, viz  # noqa: E402
from tomojax_torch import tv as ttv  # noqa: E402
from tomojax_torch.dist import SlabGroup, init_distributed  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector import (  # noqa: E402
    bp, bp_adjointable, fp, fp_adjointable,
)
from tomojax_torch.projector.sharded import (  # noqa: E402
    bp_sharded, fp_sharded,
)
from tomojax_torch.sim import nanocube_phantom  # noqa: E402
from tomojax_torch.tv.extras import (  # noqa: E402
    tv_chambolle, tv_split_bregman,
)

EXTRAS = {"chambolle": (tv_chambolle, j_extras.tv_chambolle,
                        {"n_iter": 12, "lam": 0.15}),
          "split_bregman": (tv_split_bregman, j_extras.tv_split_bregman,
                            {"n_iter": 6, "lam": 0.15, "n_inner": 3})}
SHAPES = {"3d": (6, 12, 10), "4d": (2, 5, 12, 10)}  # (..., Ns, N, M)


def _sl(a: np.ndarray) -> torch.Tensor:
    """(..., Ns, A, B) -> slice-last (..., A, B, Ns), contiguous."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -3, -1)))


def _public(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.numpy(), -1, -3)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", EXTRAS)
def test_extras_match_reference(name, shape):
    port, ref, kw = EXTRAS[name]
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, SHAPES[shape]).astype(np.float32)
    want, want_tv = ref(jnp.asarray(x), **kw)
    got, got_tv = port(_sl(x), **kw)
    want = np.asarray(want)
    np.testing.assert_allclose(_public(got), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(got_tv), float(want_tv), rtol=1e-5)


def _noisy_blocks(seed=0):
    """tests/test_extras.py's blocks, slice-last."""
    rng = np.random.default_rng(seed)
    clean = np.zeros((8, 16, 16), np.float32)
    clean[:, 4:12, 4:12] = 1.0
    noisy = clean + 0.2 * rng.standard_normal(clean.shape).astype(np.float32)
    return _sl(clean), _sl(noisy)


@pytest.mark.parametrize("fn,kw", [
    (tv_chambolle, dict(n_iter=30, lam=0.15)),
    (tv_split_bregman, dict(n_iter=10, lam=0.15)),
])
def test_extra_denoisers(fn, kw):
    """tests/test_extras.py:22-35 on the port: the TV of the input, a
    smaller TV after, and closer to the clean blocks."""
    clean, noisy = _noisy_blocks()
    den, tv0 = fn(noisy, **kw)
    assert float(tv0) == pytest.approx(float(ttv.tv(noisy)), rel=1e-5)
    assert float(ttv.tv(den.contiguous())) < float(tv0)
    assert torch.sqrt(torch.mean((den - clean) ** 2)) < torch.sqrt(
        torch.mean((noisy - clean) ** 2))


# ------------------------------------------------------------- profiling


def test_iteration_meter_matches_reference():
    """The same injected laps give the same mean (the first lap skipped),
    rate and summary line."""
    laps = [0.5, 0.012, 0.010, 0.011]
    for times in (laps, laps[:1], []):
        got = profiling.IterationMeter(voxels=256 ** 3, name="fista")
        want = j_profiling.IterationMeter(voxels=256 ** 3, name="fista")
        got.times, want.times = list(times), list(times)
        assert got.mean_s == want.mean_s
        assert got.voxel_iters_per_s == want.voxel_iters_per_s
        assert got.summary() == want.summary()


def test_iteration_meter_laps_on_the_host_clock():
    m = profiling.IterationMeter(voxels=1000, name="cpu",
                                 device=torch.device("cpu")).start()
    for _ in range(3):
        torch.ones(1000).sum()
        m.lap()
    assert len(m.times) == 3 and all(t > 0 for t in m.times)
    assert "Mvoxel" in m.summary()


def test_trace_writes_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("tomojax_torch_region"):
            torch.ones(64, 64).sum()
    assert "tomojax_torch_region" in {e.name for e in prof.events()}
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "tomojax_torch_region" in names


# ------------------------------------------------------------------ viz


@pytest.fixture
def agg():
    """matplotlib without a display; imported here, so that the other tests
    of this file collect where it is not installed."""
    pytest.importorskip("matplotlib").use("Agg", force=True)


def _volume() -> np.ndarray:
    rng = np.random.default_rng(3)
    return rng.uniform(0, 1, (6, 12, 10)).astype(np.float32)


VIZ_CALLS = {
    "plot_convergence": lambda p: viz.plot_convergence(
        torch.linspace(3, 1, 5), "SIRT", path=p),
    "plot_fusion_costs": lambda p: viz.plot_fusion_costs(
        torch.ones(4), np.arange(4.0), [3.0, 2.0, 1.0, 0.5], path=p),
    "show_volume": lambda p: viz.show_volume(torch.from_numpy(_volume()),
                                             path=p),
    "show_volume_interactive": lambda p: viz.show_volume(
        torch.from_numpy(_volume()), path=p, interactive=True),
    "live_monitor": lambda p: viz.LiveMonitor(p, eps=0.1).update(
        torch.from_numpy(_volume()), [3.0, 2.0, 1.0],
        sinogram=torch.ones(5, 12), tv_history=[10.0, 9.0]),
    "show_elements": lambda p: viz.show_elements(
        torch.from_numpy(np.stack([_volume(), 2 * _volume()])), ["c", "zn"],
        path=p),
}


@pytest.mark.parametrize("name", VIZ_CALLS)
def test_viz_writes_png(name, tmp_path, agg):
    path = tmp_path / f"{name}.png"
    VIZ_CALLS[name](str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_volume_viewer_planes_match_reference(agg):
    vol = _volume()
    got, want = viz.VolumeViewer(torch.from_numpy(vol)), j_viz.VolumeViewer(
        vol)
    for k in range(3):
        for i in (0, vol.shape[k] // 2, vol.shape[k] - 1):
            np.testing.assert_array_equal(got._plane(k, i),
                                          want._plane(k, i))
    got.set_slices(xy=4, xz=2, yz=7)
    assert got.idx == [4, 2, 7]
    np.testing.assert_array_equal(got.ims[0].get_array(), vol[4])


def _series(n=16, ns=4, angles=np.linspace(-60, 60, 9)):
    vol = torch.from_numpy(nanocube_phantom(ns, n, seed=2))
    b = fp(vol, Geometry.make(n, np.deg2rad(angles)))
    return vol.numpy(), b.permute(0, 2, 1).numpy(), angles


def test_reconstructor_plots(tmp_path, agg):
    """TomoTorch.plot_convergence / show_recon (Simulator inherits them)
    and ChemicalTomo.display_recon on CPU reconstructors."""
    vol, series, angles = _series()
    tomo = TomoTorch(angles, series, device="cpu").sirt(Niter=3)
    sim = Simulator(vol, angles, device="cpu").sirt(Niter=2)
    chem = ChemicalTomo(series, angles, {"c": series, "zn": 0.5 * series},
                        angles, device="cpu").chemical_tomography(Niter=2)
    outs = {"conv": tomo.plot_convergence(str(tmp_path / "conv.png")),
            "recon": tomo.show_recon(str(tmp_path / "recon.png")),
            "sim": sim.show_recon(str(tmp_path / "sim.png")),
            "sim_conv": sim.plot_convergence(str(tmp_path / "sim_conv.png")),
            "elements": chem.display_recon(str(tmp_path / "elements.png"))}
    for name, out in outs.items():
        assert out == str(tmp_path / f"{name}.png")
        assert (tmp_path / f"{name}.png").stat().st_size > 0


# ------------------------------------------------------- package helpers


@pytest.mark.parametrize("count", [0, 1, 2, 4])
def test_device_count_and_determine_config(monkeypatch, count):
    assert tomojax_torch.device_count() == torch.cuda.device_count()
    monkeypatch.setattr(tomojax_torch, "device_count", lambda: count)
    monkeypatch.setattr(tomojax, "device_count", lambda: count)
    for device_id in (-1, 0, 3):
        assert (tomojax_torch.determine_config(device_id)
                == tomojax.determine_config(device_id))
    assert tomojax_torch.determine_config() == (
        "multidevice" if count > 1 else "singledevice")


# ----------------------------------------------------- projector.sharded


def test_sharded_projector_on_a_group_of_one(tmp_path, agg):
    """fp_sharded / bp_sharded on the slab of a gloo group of one equal fp
    / bp; a slab of the wrong shape or device, or not the group's cut of
    the stated slice count, raises. With the group,
    TomoTorch.show_recon and ChemicalTomo.display_recon gather the slabs
    before they plot."""
    import torch.distributed as dist

    vol, series, angles = _series()
    geom = Geometry.make(vol.shape[1], np.deg2rad(angles))
    x = torch.from_numpy(vol)
    group = init_distributed(f"file://{tmp_path / 'store'}", 1, 0, "cpu")
    try:
        y = fp_sharded(x, geom, group)
        assert torch.equal(y, fp(x, geom))
        assert torch.equal(bp_sharded(y, geom, group), bp(y, geom))
        ns = x.shape[0]
        assert torch.equal(fp_sharded(x, geom, group, ns), y)
        assert torch.equal(bp_sharded(y, geom, group, ns), bp(y, geom))
        with pytest.raises(ValueError):
            fp_sharded(x[:, :-1], geom, group)
        with pytest.raises(ValueError):
            bp_sharded(x, geom, group)
        with pytest.raises(ValueError):  # not the group's cut of ns + 1
            fp_sharded(x, geom, group, ns + 1)
        with pytest.raises(ValueError):
            bp_sharded(y[:-1], geom, group, ns)
        tomo = TomoTorch(angles, series, group=group).sirt(Niter=2)
        assert tomo.show_recon(str(tmp_path / "r.png")) == str(
            tmp_path / "r.png")
        chem = ChemicalTomo(series, angles, {"c": series}, angles,
                            group=group).chemical_tomography(Niter=1)
        assert chem.display_recon(str(tmp_path / "e.png")) == str(
            tmp_path / "e.png")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ns, n_loc, ok", [(6, 2, True), (8, 2, True),
                                             (6, 6, False), (8, 3, False)])
def test_sharded_projector_checks_the_groups_cut(ns, n_loc, ok):
    """On a group of 4 ranks, a slab of n_loc slices passes with nslice=ns
    only where n_loc = ceil(ns / 4), the cut of `pad_slices` and
    `shard_global`: a whole unsharded volume raises. The check needs no
    collective, so the group is a SlabGroup of rank 1 with no process
    group behind it."""
    geom = Geometry.make(8, np.deg2rad(np.linspace(-60.0, 60.0, 5)))
    group = SlabGroup(1, 4, torch.device("cpu"))
    x = torch.rand(n_loc, 8, 8, generator=torch.Generator().manual_seed(0))
    y = fp(x, geom)
    if ok:
        assert torch.equal(fp_sharded(x, geom, group, ns), y)
        assert torch.equal(bp_sharded(y, geom, group, ns), bp(y, geom))
    else:
        with pytest.raises(ValueError, match="slab"):
            fp_sharded(x, geom, group, ns)
        with pytest.raises(ValueError, match="slab"):
            bp_sharded(y, geom, group, ns)


def test_adjointable_pair_gradients_match_reference():
    """The gradient of <fp_adjointable(x), w> is bp(w), and of
    <bp_adjointable(y), v> is fp(v), as jax.grad gives them through the
    reference's custom_vjp pair; the projector pair's bound of
    tests/test_torch_projector.py (1e-4 of the largest magnitude)."""
    rng = np.random.default_rng(5)
    n, ns, angles = 16, 3, np.deg2rad(np.linspace(-60, 60, 7))
    geom, jgeom = Geometry.make(n, angles), JGeometry.make(n, angles)
    x = rng.uniform(0, 1, (ns, n, n)).astype(np.float32)
    w = rng.uniform(0, 1, (ns, len(angles), n)).astype(np.float32)
    for port, ref, arg, weight in ((fp_adjointable, j_fp_adj, x, w),
                                   (bp_adjointable, j_bp_adj, w, x)):
        t = torch.from_numpy(arg).requires_grad_(True)
        torch.sum(port(t, geom) * torch.from_numpy(weight)).backward()
        want = np.asarray(jax.grad(lambda a: jnp.sum(ref(a, jgeom) * weight))(
            jnp.asarray(arg)))
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
