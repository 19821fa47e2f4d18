"""TomoTorch held against TomoTPU, and the port's import boundary."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import TomoTPU  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402

import tomojax_torch.config  # noqa: E402
from tomojax_torch import TomoTorch  # noqa: E402

N = 32
ANGLES = np.linspace(-70, 70, 20)
REPO = Path(__file__).resolve().parents[1]


def _series(ns=8):
    """(Nslice, Nray, Nangles) tilt series of scaled Shepp-Logan slices.
    Nslice = 8 divides the test suite's 8-device mesh, so TomoTPU runs
    unpadded."""
    from tomojax.sim import shepp_logan

    rng = np.random.default_rng(1)
    ph = np.stack([shepp_logan(N)] * ns) * rng.uniform(
        0.8, 1.2, size=(ns, 1, 1)).astype(np.float32)
    b = np.asarray(j_fp(jnp.asarray(ph), JGeometry.make(N,
                                                        np.deg2rad(ANGLES)),
                        mode="gather"))
    return np.transpose(b, (0, 2, 1))


@pytest.mark.parametrize("momentum", [True, False])
def test_fista_matches_tomotpu(monkeypatch, momentum):
    monkeypatch.setattr(tomojax_torch.config, "fgp_dual_dtype",
                        torch.float32)
    ts = _series()
    ref = TomoTPU(ANGLES, ts).fista(Niter=5, momentum=momentum,
                                    lambda_param=0.05, nTViter=5)
    got = TomoTorch(ANGLES, ts, device="cpu").fista(
        Niter=5, momentum=momentum, lambda_param=0.05, nTViter=5)
    assert got.get_recon().shape == (8, N, N)
    np.testing.assert_allclose(got.get_recon(), ref.get_recon(), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-3, atol=1e-4)


def test_import_leaves_jax_out():
    code = ("import sys, tomojax_torch, tomojax_torch.convert, "
            "tomojax_torch.solvers.asd_pocs, tomojax_torch.solvers.cuda_sart, "
            "tomojax_torch.solvers.iterative, tomojax_torch.tv.cuda_tvgd, "
            "tomojax_torch.dist, tomojax_torch.tv.cuda_fgp_sharded, "
            "tomojax_torch.tv.cuda_tvgd_sharded; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'tomojax' not in sys.modules, 'tomojax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TomoTorch(ANGLES, device="cuda")


def test_tilt_series_angle_mismatch_raises():
    with pytest.raises(ValueError):
        TomoTorch(ANGLES, np.zeros((2, N, len(ANGLES) - 1), np.float32),
                  device="cpu")


def test_device_and_group_together_raise():
    from tomojax_torch.dist import SlabGroup

    group = SlabGroup(rank=0, size=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="device or a group"):
        TomoTorch(ANGLES, device="cpu", group=group)
    assert TomoTorch(ANGLES, group=group).device == torch.device("cpu")


def test_fista_fused_runs_the_same_loop(monkeypatch):
    """fused=True (the reference's one-program scan) runs the slice-last
    loop of fused=False: the same cost and volume, bit for bit."""
    monkeypatch.setattr(tomojax_torch.config, "fgp_dual_dtype",
                        torch.float32)
    ts = _series(2)
    a, b = (TomoTorch(ANGLES, ts, device="cpu").fista(
        Niter=3, lambda_param=0.05, nTViter=3, fused=fused)
        for fused in (False, True))
    np.testing.assert_array_equal(a.cost, b.cost)
    np.testing.assert_array_equal(a.get_recon(), b.get_recon())


def _host_sinogram(a) -> np.ndarray:
    """The slice-last sinogram as numpy reorders it on the host."""
    return np.ascontiguousarray(np.transpose(np.asarray(a, np.float32),
                                             (2, 1, 0)))


def _host_normalised(a) -> np.ndarray:
    """Clamped to >= 0 and over its maximum on the host, then reordered."""
    c = np.maximum(np.asarray(a, np.float32), 0)
    return _host_sinogram(c / max(c.max(), 1e-30))


def _layout(base: np.ndarray, layout: str) -> np.ndarray:
    """`base` as the caller may hand it over: float32 C-contiguous, float64,
    a transposed view or a view with a negative stride."""
    if layout == "float64":
        return base.astype(np.float64)
    if layout == "transposed":
        return np.ascontiguousarray(base.transpose(2, 1, 0)).transpose(2, 1,
                                                                       0)
    if layout == "reversed":
        return np.ascontiguousarray(base[::-1])[::-1]
    return base


@pytest.mark.parametrize("case, copies", [
    ("float32", 0), ("float64", 1), ("transposed", 1), ("reversed", 1),
    ("chemical", 0)])
def test_sinograms_equal_the_host_reorder_bit_for_bit(case, copies):
    """The series cross to the device in the caller's layout and are
    reordered (ChemicalTomo: clamped and normalised) there: the sinograms
    equal numpy's host transpose and normalisation bit for bit, and
    "series_host_copies" counts the series numpy had to copy first."""
    from torch.profiler import ProfilerActivity, profile

    from tomojax_torch import ChemicalTomo, profiling

    rng = np.random.default_rng(5)
    base = rng.uniform(-0.5, 2.0, (5, N, len(ANGLES))).astype(np.float32)
    profiling.recorded().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        if case == "chemical":
            chem_deg = np.linspace(-60, 60, 7)
            maps = {"c": rng.uniform(-0.5, 3.0, (5, N, 7)).astype(np.float32),
                    "zn": np.zeros((5, N, 7), np.float32)}
            got = ChemicalTomo(base, ANGLES, maps, chem_deg, device="cpu")
        else:
            got = TomoTorch(ANGLES, _layout(base, case), device="cpu")
    spans = list(profiling.recorded().spans)
    profiling.recorded().clear()
    if case == "chemical":
        pairs = [(got.b_haadf, _host_normalised(base)),
                 (got.b_chem, np.stack([_host_normalised(m)
                                        for m in maps.values()]))]
    else:
        pairs = [(got.b_sl, _host_sinogram(base))]
    for t, want in pairs:
        assert t.is_contiguous()
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      want.view(np.uint32))
    counted = [s for s in spans if "series_host_copies" in s.counts]
    assert sum(s.counts["series_host_copies"] for s in counted) == copies
    assert all(s.name == "api.h2d" for s in counted)
