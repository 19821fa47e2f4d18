"""The variant kernels' plain versions held against tomojax's Pallas
kernels in interpret mode: K10 (angle-blocked BP, ``bp_sl`` /
``bp_sirt_sl`` with ab > 1) against ``bp_pallas_sl(..., ab=)``, K11 (two
FGP iterations per launch, ``tv_fgp_fused(fuse_pairs=True)``) against
``tv_fgp_pallas_fused(fuse_pairs=True)``, and K12 (the two-pass FGP,
``tv_fgp_two_pass``) against ``tv_fgp_pallas``.

K11 runs at (8, 16, 16) and (12, 16, 16), where the reference's VMEM gate
lets ``fuse_pairs=True`` reach its paired kernel
(tests/test_pallas_tv.py:138-155). With f32 duals the bound is that
test's 3e-6; with bf16 duals both packages round the duals once per pair,
at the same points, and the bound is tests/test_pallas_tv.py's bf16 bound,
lam * 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.pallas_joseph import bp_pallas_sl  # noqa: E402
from tomojax.tv.pallas_fgp import (  # noqa: E402
    tv_fgp_pallas, tv_fgp_pallas_fused,
)

from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector import cuda_joseph  # noqa: E402
from tomojax_torch.projector.cuda_joseph import bp_sirt_sl, bp_sl  # noqa: E402
from tomojax_torch.tv import cuda_fgp  # noqa: E402
from tomojax_torch.tv.cuda_fgp import (  # noqa: E402
    fgp_grad, fgp_iter2, tv_fgp_fused, tv_fgp_two_pass,
)

HI = jax.lax.Precision.HIGHEST
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_projector.py's


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _vol(shape, seed, offset=0.5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32) + offset


# ---------------------------------------------------------------- K10


@pytest.mark.parametrize("ab", [3, 4])
@pytest.mark.parametrize("fused", [False, True])
def test_bp_ab_matches_pallas(ab, fused):
    """Na = 13 is a multiple of neither ab: the last group holds padded
    angles."""
    ns, n, na = 5, 19, 13
    ang = np.deg2rad(np.linspace(-76, 76, na))
    geom, jgeom = Geometry.make(n, ang), JGeometry.make(n, ang)
    rng = np.random.default_rng(ab)
    y = rng.normal(size=(na, n, ns)).astype(np.float32)
    y_vol = rng.normal(size=(n, n, ns)).astype(np.float32)
    inv_col = rng.uniform(0.0, 0.5, size=(n, n)).astype(np.float32)
    kw = dict(y_vol=jnp.asarray(y_vol), inv_col2d=jnp.asarray(inv_col)) \
        if fused else {}
    ref = bp_pallas_sl(jnp.asarray(y), jgeom, precision=HI, interpret=True,
                       ab=ab, **kw)
    if fused:
        got = bp_sirt_sl(_t(y), geom, _t(y_vol), _t(inv_col), ab=ab)
        same = bp_sirt_sl(_t(y), geom, _t(y_vol), _t(inv_col))
    else:
        got, same = bp_sl(_t(y), geom, ab=ab), bp_sl(_t(y), geom)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the padded angles add exactly 0: the plain version equals K2's
    np.testing.assert_array_equal(got.numpy(), same.numpy())


@pytest.mark.parametrize("ab", [0, -1, 33, 2.0, True])
def test_bp_ab_rejects_bad_ab(ab):
    geom = Geometry.make(8, np.deg2rad(np.linspace(-60, 60, 5)))
    y = torch.zeros((5, 8, 2))
    with pytest.raises(ValueError):
        bp_sl(y, geom, ab=ab)
    with pytest.raises(ValueError):
        bp_sirt_sl(y, geom, torch.zeros((8, 8, 2)), torch.zeros((8, 8)),
                   ab=ab)


# ---------------------------------------------------------------- K11


@pytest.mark.parametrize("iters", [3, 4, 5, 9])
@pytest.mark.parametrize("shape", [(8, 16, 16), (12, 16, 16)])
def test_fuse_pairs_matches_pallas_f32(iters, shape):
    x = _vol(shape, 7)
    ref, _ = tv_fgp_pallas_fused(jnp.asarray(x), iters, 0.2, interpret=True,
                                 dual_dtype=jnp.float32, fuse_pairs=True)
    got = tv_fgp_fused(_t(x), iters, 0.2, dual_dtype=torch.float32,
                       fuse_pairs=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-6,
                               atol=3e-6)


@pytest.mark.parametrize("iters", [3, 4, 5, 9])
@pytest.mark.parametrize("shape", [(8, 16, 16), (12, 16, 16)])
def test_fuse_pairs_matches_pallas_bf16(iters, shape):
    lam = 0.2
    x = _vol(shape, 8)
    ref, _ = tv_fgp_pallas_fused(jnp.asarray(x), iters, lam, interpret=True,
                                 dual_dtype=jnp.bfloat16, fuse_pairs=True)
    got = tv_fgp_fused(_t(x), iters, lam, dual_dtype=torch.bfloat16,
                       fuse_pairs=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=lam * 3e-2)


def test_fuse_pairs_launch_order():
    """m = n_iter - 1 iterations: m // 2 pairs, then one single iteration
    when m is odd; m < 2 runs no pair."""
    x = _t(_vol((4, 6, 5), 9))
    counts = {}
    real = (cuda_fgp.fgp_iter2_ref, cuda_fgp.fgp_iter_ref)

    def count(name, fn):
        def wrapped(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    try:
        cuda_fgp.fgp_iter2_ref = count("pair", real[0])
        cuda_fgp.fgp_iter_ref = count("single", real[1])
        for n_iter, want in ((2, (0, 1)), (3, (1, 0)), (6, (2, 1)),
                             (10, (4, 1))):
            counts.clear()
            tv_fgp_fused(x, n_iter, 0.1, fuse_pairs=True)
            assert (counts.get("pair", 0), counts.get("single", 0)) == want
    finally:
        cuda_fgp.fgp_iter2_ref, cuda_fgp.fgp_iter_ref = real


def test_fgp_iter2_is_two_iterations_in_f32():
    """With f32 duals one K11 step is two K3 steps exactly; with bf16
    duals it is two K3 steps whose middle duals are not rounded."""
    x = _t(_vol((6, 10, 9), 10))
    rng = np.random.default_rng(11)
    p = tuple(_t(rng.uniform(-0.5, 0.5, size=x.shape)) for _ in range(3))
    two = cuda_fgp.fgp_iter_ref(x, *cuda_fgp.fgp_iter_ref(x, *p, 0.1), 0.1)
    for a, b in zip(fgp_iter2(x, *p, 0.1), two):
        assert torch.equal(a, b)
    pb = tuple(v.bfloat16() for v in p)
    got = fgp_iter2(x, *pb, 0.1)
    assert all(v.dtype == torch.bfloat16 for v in got)
    mid = cuda_fgp.fgp_iter_ref(x, *(v.float() for v in pb), 0.1)
    want = cuda_fgp.fgp_iter_ref(x, *mid, 0.1)
    for a, b in zip(got, want):
        assert torch.equal(a, b.bfloat16())


# ---------------------------------------------------------------- K12


@pytest.mark.parametrize("iters,shape", [(1, (8, 16, 16)), (4, (12, 16, 16)),
                                         (10, (16, 24, 24)), (7, (5, 12, 12))])
def test_two_pass_matches_pallas(iters, shape):
    x = _vol(shape, 3)
    ref, tv_ref = tv_fgp_pallas(jnp.asarray(x), iters, 0.2, interpret=True)
    got, tv0 = tv_fgp_two_pass(_t(x), iters, 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # the TV value is a float32 sum taken in another order by each package
    # (1.2e-6 apart at 16 x 24 x 24): tests/test_torch_tv.py's rtol
    np.testing.assert_allclose(float(tv0), float(tv_ref), rtol=1e-5)


def test_two_pass_matches_fused_f32():
    x = _t(_vol((10, 14, 12), 4))
    d, _ = tv_fgp_two_pass(x, 6, 0.15)
    want = tv_fgp_fused(x, 6, 0.15, dual_dtype=torch.float32)
    np.testing.assert_allclose(d.numpy(), want.numpy(), atol=2e-6)


def test_fgp_grad_rejects_bad_operands():
    d = torch.ones((4, 5, 6))
    p = torch.zeros((4, 5, 6))
    with pytest.raises(ValueError):
        fgp_grad(d, p.bfloat16(), p.bfloat16(), p.bfloat16(), 0.1)
    with pytest.raises(ValueError):
        fgp_grad(d, p, p, torch.zeros((4, 5, 7)), 0.1)
    with pytest.raises(ValueError):
        tv_fgp_two_pass(d, 0, 0.1)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_variant_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    # K10 at every ab, on a regular and two ragged shapes (N off the
    # 16-pixel tiles, Ns % 4 != 0: scalar copies and stores)
    for n, na, ns in ((40, 13, 36), (33, 7, 5), (48, 13, 37)):
        geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
        y = _t(rng.normal(size=(na, n, ns))).to(dev)
        y_vol = _t(rng.normal(size=(n, n, ns))).to(dev)
        inv_col = _t(rng.uniform(0, 0.5, size=(n, n))).to(dev)
        k2 = bp_sl(y, geom)
        k2f = bp_sirt_sl(y, geom, y_vol, inv_col)
        for ab in range(2, cuda_joseph.AB_MAX + 1):
            assert torch.equal(bp_sl(y, geom, ab=ab), k2), (n, ab)
            got = bp_sirt_sl(y, geom, y_vol, inv_col, ab=ab)
            assert torch.equal(got, k2f), (n, ab)
            ref = cuda_joseph.bp_sirt_sl_ref(y, geom, y_vol, inv_col, ab)
            np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                       atol=1e-5 * float(ref.abs().max()))
    # a ring and tables beyond the card's shared memory per block
    many = Geometry.make(8, np.linspace(0, np.pi, 2000, endpoint=False))
    assert cuda_joseph.bp_smem_bytes(2000, 32) > 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        bp_sl(torch.zeros((2000, 8, 4), device=dev), many, ab=32)
    # K11's march across its boundaries: n0 below and above TV_C, ragged
    # n1 and n2, n2 = 1, one plane
    for shape in ((21, 30, 37), (5, 11, 37), (40, 16, 1), (70, 33, 130),
                  (1, 8, 32)):
        x = torch.from_numpy(_vol(shape, 13)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            p = tuple((torch.rand(x.shape, device=dev) - 0.5).to(dt)
                      for _ in range(3))
            for a, b in zip(fgp_iter2(x, *p, 0.1),
                            cuda_fgp.fgp_iter2_ref(x, *p, 0.1)):
                assert torch.equal(a, b), (shape, dt)
    x = torch.from_numpy(_vol((21, 30, 37), 13)).to(dev)
    d = torch.from_numpy(_vol((21, 30, 37), 14)).to(dev)
    p = tuple(torch.rand(x.shape, device=dev) - 0.5 for _ in range(3))
    for a, b in zip(fgp_grad(d, *p, 0.1), cuda_fgp.fgp_grad_ref(d, *p, 0.1)):
        assert torch.equal(a, b)
