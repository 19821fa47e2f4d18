"""tomojax_torch simulation pieces held against tomojax: the rest of
``Geometry`` and ``ops``, Poisson noise, ``create_projections(snr)`` and
``Simulator``.

Poisson noise equals the reference's numpy branch bit for bit: the
reference's native module is made to raise (``tomojax.native.lib``
monkeypatched), so it takes tomojax/ops.py:124-128, and the sinograms
are integer-valued, so that the float32 total is exact in any summation
order. The sharded branch runs on a 2-device slice of the suite's
virtual CPU mesh against the port's per-rank function.

Projections with noise go through each package's own projector (the
reference's 'mxu' contraction on the CPU, the port's 2-tap gathers),
which differ in the last digits: a Poisson draw whose mean moved that
much may land one count higher or lower. So the noisy sinograms are held
count for count, with at most one element in 10^4 (rounded up) one count
apart, and equal to rtol 1e-5 elsewhere. When these tests were written
the count found was 0 in every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import tomojax.native  # noqa: E402
from tomojax import ops as j_ops  # noqa: E402
from tomojax.api import Simulator as JSimulator  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.sim import create_projections as j_project  # noqa: E402

from tomojax_torch import Simulator, ops  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.sim import (  # noqa: E402
    create_projections, nanocube_phantom,
)
from tomojax_torch.solvers import from_sl, to_sl  # noqa: E402

SNR = 200


@pytest.fixture
def numpy_branch(monkeypatch):
    """The reference's poisson_noise without its native module."""
    def no_native():
        raise RuntimeError("native module off for the numpy branch")

    monkeypatch.setattr(tomojax.native, "lib", no_native)


def _counts_held(got, ref, scale):
    """Noisy sinograms equal count for count but for at most one element in
    10^4 (rounded up), which may sit one count apart; returns that count."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    counts = np.rint(np.abs(got - ref) * scale)
    assert counts.max() <= 1.0
    off = int((counts == 1).sum())
    assert off <= -(-got.size // 10**4), off
    same = counts == 0
    np.testing.assert_allclose(got[same], ref[same], rtol=1e-5)
    return off


@pytest.mark.parametrize("angles_deg", [np.linspace(-70, 70, 9),
                                        np.array([40.0, -10.0, 90.0, 0.0])])
def test_geometry_bookkeeping_matches_reference(angles_deg):
    ang = np.deg2rad(angles_deg)
    g, jg = Geometry.make(20, ang, nray=23), JGeometry.make(20, ang, nray=23)
    np.testing.assert_array_equal(g.perm, jg.perm)
    np.testing.assert_array_equal(g.inv_perm, jg.inv_perm)
    more = np.deg2rad([71.0, 80.0])
    for got, ref in ((g.with_angles(more), jg.with_angles(more)),
                     (g.extended(more), jg.extended(more))):
        assert (got.n, got.nray, got.angles_key) == (ref.n, ref.nray,
                                                     ref.angles_key)


def test_ops_match_reference():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 7, 5)).astype(np.float32)
    b = rng.normal(size=(3, 7, 5)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(ops.soft_threshold(ta, 0.3).numpy(),
                               np.asarray(j_ops.soft_threshold(ja, 0.3)),
                               rtol=1e-6, atol=1e-7)
    for name in ("norm2", "l1_norm"):
        np.testing.assert_allclose(float(getattr(ops, name)(ta)),
                                   float(getattr(j_ops, name)(ja)),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(ops.euclidean_dist(ta, tb)),
                               float(j_ops.euclidean_dist(ja, jb)),
                               rtol=1e-6)


def _int_sinogram(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 60, size=shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
@pytest.mark.parametrize("shape", [(4, 6, 16), (3, 9, 21)])
def test_poisson_noise_equals_reference_numpy_branch(numpy_branch, seed,
                                                     shape):
    b = _int_sinogram(shape, 1)
    ref = np.asarray(j_ops.poisson_noise(jax.random.PRNGKey(seed),
                                         jnp.asarray(b), SNR))
    got = ops.poisson_noise(to_sl(torch.from_numpy(b)), SNR, seed)
    assert got.shape == (shape[1], shape[2], shape[0])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(from_sl(got).numpy(), ref)


def test_poisson_noise_sharded_branch_per_rank(numpy_branch):
    """The reference's sharded branch on 2 CPU devices against the port's
    per-rank function (each rank's slab, its offset, the whole total)."""
    ranks, seed = 2, 11
    b = _int_sinogram((6, 5, 12), 2)
    mesh = Mesh(np.asarray(jax.devices()[:ranks]), ("z",))
    jb = jax.device_put(jnp.asarray(b),
                        NamedSharding(mesh, PartitionSpec("z")))
    ref = np.asarray(j_ops.poisson_noise(jax.random.PRNGKey(seed), jb, SNR))
    total, n_loc = float(b.sum()), b.shape[0] // ranks
    for rank in range(ranks):
        slab = torch.from_numpy(b[rank * n_loc:(rank + 1) * n_loc])
        got = ops.poisson_noise_slab(to_sl(slab), SNR, seed, total, b.size,
                                     rank * n_loc)
        np.testing.assert_array_equal(
            from_sl(got).numpy(), ref[rank * n_loc:(rank + 1) * n_loc])
    # the unsharded draw differs: the seeds are per slab
    whole = from_sl(ops.poisson_noise(to_sl(torch.from_numpy(b)), SNR,
                                      seed)).numpy()
    assert not np.array_equal(whole, ref)


def test_slab_seed_formula():
    assert ops.slab_seed(5, ()) == 5
    s = (5 * 1000003 + 3 * 7919 + 1) & 0x7FFFFFFF
    for _ in range(2):
        s = (s * 1000003 + 1) & 0x7FFFFFFF
    assert ops.slab_seed(5, (3, 0, 0)) == s


@pytest.mark.parametrize("snr", [0, SNR])
def test_create_projections_matches_reference(numpy_branch, snr):
    ns, n, na, nt = 4, 24, 7, 27
    geom_args = (n, np.deg2rad(np.linspace(-76, 76, na)), nt)
    vol = nanocube_phantom(ns, n, seed=2)
    ref = np.asarray(j_project(vol, JGeometry.make(*geom_args), snr=snr,
                               seed=3))
    got = create_projections(torch.from_numpy(vol),
                             Geometry.make(*geom_args), snr=snr,
                             seed=3).numpy()
    assert got.shape == (ns, na, nt)
    if snr:
        scale = snr * ref.size / float(ref.sum())
        _counts_held(got, ref, scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("snr", [0, SNR])
def test_simulator_matches_reference(numpy_branch, snr):
    ns, n = 8, 24
    angles = np.linspace(-70, 70, 9)
    vol = nanocube_phantom(ns, n, seed=4)
    ref = JSimulator(vol, angles, snr=snr)
    got = Simulator(vol, angles, snr=snr, device="cpu")
    np.testing.assert_array_equal(got.original, ref.original)
    if snr:
        assert not (got.original == 0).any()  # background filled
    pr, pg = ref.get_projections(), got.get_projections()
    assert pg.shape == (ns, len(angles), n)
    if snr:
        _counts_held(pg, pr, snr * pr.size / float(pr.sum()))
    else:
        np.testing.assert_allclose(pg, pr, rtol=1e-5,
                                   atol=1e-5 * np.abs(pr).max())
    assert got.rmse() == pytest.approx(ref.rmse(), rel=1e-6)  # x = 0
    ref.sirt(Niter=3)
    got.sirt(Niter=3)
    assert got.rmse() == pytest.approx(ref.rmse(), rel=1e-4)
    assert got.rmse() < float(np.sqrt(np.mean(got.original ** 2)))
