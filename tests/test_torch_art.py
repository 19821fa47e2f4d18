"""tomojax_torch ART (A1's plain version, ``art_sweep``, ``TomoTorch.art``)
held against tomojax, and A1 against its plain version on the card.

The reference's ``art_sweep`` is an XLA scan of one ray a step; the port's
plain version computes the same float32 positions, weights and updates
(batched over the rays) and sums each ray's dot product in another order,
so one sweep is held at 1e-5 of the largest magnitude of the result. The
kernel on the card rounds like the plain version but for the order of its
sums: one ray step is held at 1e-6, one sweep at 1e-4 of the largest
magnitude, and two kernel sweeps must agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import TomoTPU  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.solvers import make_system as j_sys  # noqa: E402
from tomojax.solvers.iterative import art_sweep as j_art  # noqa: E402

from tomojax_torch import TomoTorch  # noqa: E402
from tomojax_torch.convert import system_from_numpy  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector.cuda_joseph import fp_sl  # noqa: E402
from tomojax_torch.sim import nanocube_phantom, shepp_logan  # noqa: E402
from tomojax_torch.solvers import (  # noqa: E402
    art_sweep, art_sweep_sl, cuda_art, row_norms_sq, to_sl,
)

# (N, Na, Ns, Nt, span): a ragged detector (Nt != N), exact 0/90 degree
# views among others, and a row- and column-driven mix
SHAPES = [(16, 6, 3, 16, 70), (20, 7, 4, 27, 76), (17, 5, 3, 17, 90)]


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


def _problem(n, na, ns, nt, span, seed=0):
    ang = np.deg2rad(np.linspace(-span, span, na))
    jgeom, geom = JGeometry.make(n, ang, nt), Geometry.make(n, ang, nt)
    jsys = j_sys(jgeom)
    sysd = system_from_numpy(geom, np.asarray(jsys.row_sum),
                             np.asarray(jsys.col_sum),
                             np.asarray(jsys.lipschitz), "cpu")
    rng = np.random.default_rng(seed)
    vol = nanocube_phantom(ns, n, seed=seed)
    b = np.array(j_fp(jnp.asarray(vol), jgeom))
    b += rng.uniform(0.0, 0.05, size=b.shape).astype(np.float32)
    return jsys, sysd, vol, b


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("start", ["zero", "random"])
def test_art_sweep_sequential_matches_reference(shape, start):
    jsys, sysd, vol, b = _problem(*shape)
    rng = np.random.default_rng(1)
    x0 = (np.zeros_like(vol) if start == "zero"
          else rng.uniform(0, 1, size=vol.shape).astype(np.float32))
    ref = np.asarray(j_art(jnp.asarray(x0), jnp.asarray(b), jsys, 1.0))
    got = art_sweep(torch.from_numpy(x0), torch.from_numpy(b), sysd, 1.0)
    assert got.shape == vol.shape and got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_art_sweep_permutation_matches_reference(shape):
    jsys, sysd, vol, b = _problem(*shape, seed=2)
    rays = shape[1] * shape[3]
    perm = np.random.default_rng(3).permutation(rays).astype(np.int32)
    x0 = np.zeros_like(vol)
    ref = np.asarray(j_art(jnp.asarray(x0), jnp.asarray(b), jsys, 0.7,
                           jnp.asarray(perm)))
    got = art_sweep(torch.from_numpy(x0), torch.from_numpy(b), sysd, 0.7,
                    perm)
    _close(got.numpy(), ref, 1e-5)
    # a partial order: every other ray
    ref = np.asarray(j_art(jnp.asarray(x0), jnp.asarray(b), jsys, 1.0,
                           jnp.asarray(perm[::2])))
    got = art_sweep(torch.from_numpy(x0), torch.from_numpy(b), sysd, 1.0,
                    perm[::2])
    _close(got.numpy(), ref, 1e-5)


def test_art_taps_are_the_joseph_rows():
    """The rows the sweep walks are A's rows: the taps of every ray give
    the forward projection (K1's plain version), and nsq their squared
    norms (solvers.base.row_norms_sq)."""
    n, na, ns, nt, span = SHAPES[1]
    _, sysd, vol, _ = _problem(n, na, ns, nt, span)
    p0, p1, w0, w1, nsq = cuda_art.art_taps(sysd.geom, "cpu")
    xf = to_sl(torch.from_numpy(vol)).reshape(n * n, ns)
    ax = (xf[p0] * w0[..., None] + xf[p1] * w1[..., None]).sum(1)
    _close(ax.reshape(na, nt, ns).numpy(),
           fp_sl(to_sl(torch.from_numpy(vol)), sysd.geom).numpy(), 1e-5)
    _close(nsq.reshape(na, nt).numpy(),
           row_norms_sq(sysd.geom, "cpu").numpy(), 1e-5)


def test_art_plain_version_rejects_bad_orders():
    _, sysd, vol, b = _problem(*SHAPES[0])
    x, bs = to_sl(torch.from_numpy(vol)), to_sl(torch.from_numpy(b))
    rays = SHAPES[0][1] * SHAPES[0][3]
    for bad in ([rays], [-1]):
        with pytest.raises(ValueError, match="outside"):
            art_sweep_sl(x, bs, sysd.geom, 1.0,
                         torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(ValueError, match="order"):
        art_sweep_sl(x, bs, sysd.geom, 1.0, torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        art_sweep_sl(x, bs, sysd.geom, 1.0, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="slices"):
        art_sweep_sl(x, bs, sysd.geom, 1.0,
                     torch.zeros(3, dtype=torch.int32), slices=6)
    assert cuda_art.art_max_n(8) == 512 and cuda_art.art_max_n(1) == 4096
    assert [cuda_art.art_slices(n) for n in (33, 1024, 4096)] == [
        cuda_art.ART_SLICES, 4, 1]
    with pytest.raises(ValueError, match="N <= 4096"):
        cuda_art.art_slices(4097)


def _series(ns=8, n=24, angles=np.linspace(-70, 70, 11)):
    rng = np.random.default_rng(1)
    ph = np.stack([shepp_logan(n)] * ns) * rng.uniform(
        0.8, 1.2, size=(ns, 1, 1)).astype(np.float32)
    b = np.asarray(j_fp(jnp.asarray(ph), JGeometry.make(n,
                                                        np.deg2rad(angles))))
    return angles, np.transpose(b, (0, 2, 1))


def test_tomotorch_art_matches_tomotpu():
    angles, ts = _series()
    ref = TomoTPU(angles, ts).art(Niter=2, beta=0.8)
    got = TomoTorch(angles, ts, device="cpu").art(Niter=2, beta=0.8)
    _close(got.get_recon(), ref.get_recon(), 1e-5)
    np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-4)
    assert got.cost[-1] < got.cost[0]
    quiet = TomoTorch(angles, ts, device="cpu").art(show_convergence=False)
    np.testing.assert_array_equal(quiet.cost, np.zeros(1, np.float32))


def test_tomotorch_randart_draws_permutations_from_seed_zero():
    """randART: each sweep a permutation of the rays from the instance's
    torch generator (seed 0, as the reference's PRNGKey(0); the streams
    differ), each sweep equal to the reference's sweep over that order."""
    angles, ts = _series()
    tomo = TomoTorch(angles, ts, device="cpu").art(Niter=2,
                                                   random_order=True)
    gen = torch.Generator().manual_seed(0)
    rays = len(angles) * ts.shape[1]
    orders = [torch.randperm(rays, generator=gen).numpy().astype(np.int32)
              for _ in range(2)]
    assert not np.array_equal(orders[0], orders[1])
    jgeom = JGeometry.make(ts.shape[1], np.deg2rad(angles))
    jsys = j_sys(jgeom)
    x = jnp.zeros((ts.shape[0], ts.shape[1], ts.shape[1]), jnp.float32)
    b = jnp.asarray(np.transpose(ts, (0, 2, 1)))
    for order in orders:
        x = j_art(x, b, jsys, 1.0, jnp.asarray(order))
    _close(tomo.get_recon(), np.asarray(x), 1e-5)


@pytest.mark.cuda
def test_art_kernel_matches_plain_on_card():
    """A1 against its plain version on the card: one ray step from random
    x (1e-6 max|x|), one sweep from zero (1e-4 max|x|), two sweeps bit for
    bit, out-of-range rays skipped, every slices-a-block instantiation, at
    N 33 / Na 7 / Ns 5 and on a ragged detector."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for n, na, ns, nt in ((33, 7, 5, 33), (24, 9, 19, 31)):
        geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)), nt)
        vol = to_sl(torch.from_numpy(nanocube_phantom(ns, n)).to(dev))
        b = fp_sl(vol, geom)
        x = torch.rand((n, n, ns), generator=gen, device=dev)
        seq = torch.arange(na * nt, dtype=torch.int32, device=dev)
        x0 = torch.zeros_like(vol)
        ref_sweep = cuda_art.art_sweep_sl_ref(x0, b, geom, 1.0, seq)
        for slices in cuda_art.SLICES:
            for r in (0, nt // 2, (na // 2) * nt + 3):
                one = seq[r:r + 1]
                got = art_sweep_sl(x, b, geom, 1.0, one, slices)
                ref = cuda_art.art_sweep_sl_ref(x, b, geom, 1.0, one)
                assert float((got - ref).abs().max()) <= \
                    1e-6 * float(ref.abs().max())
            got = art_sweep_sl(x0, b, geom, 1.0, seq, slices)
            assert float((got - ref_sweep).abs().max()) <= \
                1e-4 * float(ref_sweep.abs().max())
            assert torch.equal(art_sweep_sl(x0, b, geom, 1.0, seq, slices),
                               got)
            skip = torch.tensor([na * nt, -1], dtype=torch.int32, device=dev)
            assert torch.equal(art_sweep_sl(x, b, geom, 1.0, skip, slices), x)
