"""tomojax_torch Joseph projector (K1, K2 and their plain versions) held
against tomojax's Pallas kernels and 'gather' mode.

The Pallas kernels run as tests/test_pallas_projector.py runs them: in
interpret mode at Precision.HIGHEST, with the tolerance used there. The
reference works on padded sinogram operands (angles to a multiple of 16,
slices to its slice block); its padding is cut off before comparing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import config as tjconfig  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import bp as j_bp, fp as j_fp  # noqa: E402
from tomojax.projector.pallas_joseph import (  # noqa: E402
    _round_up, _slice_block, bp_pallas_sl, fp_resid_pallas_sl,
)

from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector import (  # noqa: E402
    bp, bp_sirt_sl, bp_sl, fp, fp_resid_sl, fp_sl,
)
from tomojax_torch.projector import cuda_joseph  # noqa: E402

HI = jax.lax.Precision.HIGHEST
TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(5, 33, 7), (8, 32, 12), (3, 16, 1), (130, 24, 9)]


def _geoms(n, na):
    ang = np.deg2rad(np.linspace(-76, 76, na))
    return Geometry.make(n, ang), JGeometry.make(n, ang)


def _pad(a, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("ns,n,na", SHAPES)
def test_fp_resid_matches_pallas(ns, n, na):
    geom, jgeom = _geoms(n, na)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, n, ns)).astype(np.float32)
    b = rng.normal(size=(na, n, ns)).astype(np.float32)
    ax_old = rng.normal(size=(na, n, ns)).astype(np.float32)
    inv_row = rng.uniform(0.1, 1.0, size=(na, n)).astype(np.float32)
    beta = 0.37
    sino_pad = (_round_up(na, 16), n, _round_up(ns, _slice_block(ns)))
    ax_r, resid_r, ddsq_r = fp_resid_pallas_sl(
        jnp.asarray(x), jgeom, jnp.asarray(_pad(b, sino_pad)),
        jnp.asarray(_pad(ax_old, sino_pad)),
        jnp.asarray(_pad(inv_row, sino_pad[:2])), beta, precision=HI,
        interpret=True)
    ax, resid, ddsq = fp_resid_sl(_t(x), geom, _t(b), _t(ax_old),
                                  _t(inv_row), torch.tensor(beta))
    np.testing.assert_allclose(ax.numpy(), np.asarray(ax_r)[:na, :, :ns],
                               **TOL)
    np.testing.assert_allclose(resid.numpy(),
                               np.asarray(resid_r)[:na, :, :ns], **TOL)
    np.testing.assert_allclose(float(ddsq), float(jnp.sum(ddsq_r)),
                               rtol=1e-4)


@pytest.mark.parametrize("ns,n,na", SHAPES)
def test_bp_sirt_matches_pallas(ns, n, na):
    geom, jgeom = _geoms(n, na)
    rng = np.random.default_rng(1)
    resid = rng.normal(size=(na, n, ns)).astype(np.float32)
    y_vol = rng.normal(size=(n, n, ns)).astype(np.float32)
    inv_col = rng.uniform(0.0, 0.5, size=(n, n)).astype(np.float32)
    ref = bp_pallas_sl(jnp.asarray(resid), jgeom, precision=HI,
                       interpret=True, y_vol=jnp.asarray(y_vol),
                       inv_col2d=jnp.asarray(inv_col))
    got = bp_sirt_sl(_t(resid), geom, _t(y_vol), _t(inv_col))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bp_sirt_matches_banded_pallas():
    """K2 has no banded split: one kernel covers the reference's banded BP
    (engaged here by set_banded_projector('on') at n = 128)."""
    ns, n, na = 4, 128, 9
    geom, jgeom = _geoms(n, na)
    rng = np.random.default_rng(2)
    resid = rng.normal(size=(na, n, ns)).astype(np.float32)
    y_vol = rng.normal(size=(n, n, ns)).astype(np.float32)
    inv_col = rng.uniform(0.0, 0.5, size=(n, n)).astype(np.float32)
    prev = tjconfig.banded_projector
    try:
        tjconfig.set_banded_projector("on")
        ref = bp_pallas_sl(jnp.asarray(resid), jgeom, precision=HI,
                           interpret=True, y_vol=jnp.asarray(y_vol),
                           inv_col2d=jnp.asarray(inv_col))
    finally:
        tjconfig.set_banded_projector(prev)
    got = bp_sirt_sl(_t(resid), geom, _t(y_vol), _t(inv_col))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("ns,n,na", SHAPES)
def test_fp_bp_match_gather(ns, n, na):
    geom, jgeom = _geoms(n, na)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(ns, n, n)).astype(np.float32)
    y = rng.normal(size=(ns, na, n)).astype(np.float32)
    np.testing.assert_allclose(
        fp(_t(x), geom).numpy(),
        np.asarray(j_fp(jnp.asarray(x), jgeom, mode="gather")), **TOL)
    np.testing.assert_allclose(
        bp(_t(y), geom).numpy(),
        np.asarray(j_bp(jnp.asarray(y), jgeom, mode="gather")), **TOL)


def test_adjointness():
    geom, _ = _geoms(32, 11)
    rng = np.random.default_rng(4)
    x = _t(rng.normal(size=(6, 32, 32)))
    y = _t(rng.normal(size=(6, 11, 32)))
    lhs = float(torch.sum(fp(x, geom).double() * y.double()))
    rhs = float(torch.sum(x.double() * bp(y, geom).double()))
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs), 1.0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided"])
def test_wrappers_reject_bad_operands(bad):
    geom, _ = _geoms(16, 5)
    x = torch.zeros((16, 16, 3))
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        x = torch.zeros((16, 15, 3))
    else:
        x = torch.zeros((16, 16, 6))[:, :, ::2]
    with pytest.raises(ValueError):
        fp_sl(x, geom)
    with pytest.raises(ValueError):
        bp_sl(x.permute(2, 0, 1), geom)


@pytest.mark.cuda
@pytest.mark.parametrize("n,na,ns", [(48, 13, 40), (33, 7, 5)])
def test_kernels_match_plain_on_card(n, na, ns):
    """K1 and K2 against their plain versions; (33, 7, 5) has N off K1's
    and K2's tiles and Ns % 4 != 0 (their 4-byte copies and stores)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    geom, _ = _geoms(n, na)
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    x = _t(rng.normal(size=(n, n, ns))).to(dev)
    b = _t(rng.normal(size=(na, n, ns))).to(dev)
    ax_old = _t(rng.normal(size=(na, n, ns))).to(dev)
    inv_row = _t(rng.uniform(0.1, 1, size=(na, n))).to(dev)
    beta = torch.tensor(0.3, device=dev)
    got = fp_resid_sl(x, geom, b, ax_old, inv_row, beta)
    ref = cuda_joseph.fp_resid_sl_ref(x, geom, b, ax_old, inv_row, beta)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=2e-5, atol=1e-5 * float(r.abs().max()))
    y_vol = _t(rng.normal(size=(n, n, ns))).to(dev)
    inv_col = _t(rng.uniform(0, 0.5, size=(n, n))).to(dev)
    z = bp_sirt_sl(b, geom, y_vol, inv_col)
    z_ref = cuda_joseph.bp_sirt_sl_ref(b, geom, y_vol, inv_col)
    np.testing.assert_allclose(z.cpu().numpy(), z_ref.cpu().numpy(),
                               atol=1e-5 * float(z_ref.abs().max()))
