"""tomojax_torch TV value (K5) and FGP prox (K3, K4) held against tomojax.

The reference's Pallas kernels run in interpret mode, as
tests/test_pallas_tv.py runs them; its XLA stencils run as they are.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import tv as jtv  # noqa: E402
from tomojax.tv.pallas_fgp import tv_fgp_pallas_fused  # noqa: E402
from tomojax.tv.pallas_tv_value import tv_value_pallas  # noqa: E402

from tomojax_torch.tv import tv, tv_fgp, tv_fgp_fused  # noqa: E402
from tomojax_torch.tv.cuda_fgp import (  # noqa: E402
    fgp_iter, fgp_iter_ref, fgp_obj_mom, fgp_obj_mom_ref,
)
from tomojax_torch.tv.cuda_tv_value import (  # noqa: E402
    tv_value, tv_value_ref,
)

VOLS = [(8, 16, 16), (5, 12, 7), (16, 32, 24)]


def _vol(shape, seed, offset=0.5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32) + offset


@pytest.mark.parametrize("shape", VOLS)
def test_tv_value_matches_pallas(shape):
    x = _vol(shape, 0)
    ref = float(tv_value_pallas(jnp.asarray(x), interpret=True))
    got = tv_value(torch.from_numpy(x))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 8, 16, 16), (3, 5, 12, 7)])
def test_tv_value_4d_matches_pallas(shape):
    """A (nel, n0, n1, n2) stack: the summed per-element value, one K5
    launch on the card."""
    x = _vol(shape, 11)
    ref = float(tv_value_pallas(jnp.asarray(x), interpret=True))
    got = tv_value(torch.from_numpy(x))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)


def test_tv_4d_matches_reference():
    x = _vol((2, 6, 10, 9), 1)
    np.testing.assert_allclose(float(tv(torch.from_numpy(x))),
                               float(jtv.tv(jnp.asarray(x))), rtol=1e-5)


@pytest.mark.parametrize("shape,n_iter,lam", [((8, 16, 16), 6, 0.2),
                                              ((5, 12, 7), 10, 0.05)])
def test_fgp_fused_mom_matches_pallas_f32(shape, n_iter, lam):
    x, x_old = _vol(shape, 2), _vol(shape, 3)
    beta = 0.4
    d_r, y_r, _ = tv_fgp_pallas_fused(
        jnp.asarray(x), n_iter, lam, interpret=True, dual_dtype=jnp.float32,
        mom=(jnp.asarray(x_old), beta))
    d, y = tv_fgp_fused(torch.from_numpy(x), n_iter, lam,
                        dual_dtype=torch.float32,
                        mom=(torch.from_numpy(x_old), torch.tensor(beta)))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=1e-5)


@pytest.mark.parametrize("shape,n_iter,lam", [((8, 16, 16), 6, 0.2),
                                              ((5, 12, 7), 10, 0.05)])
def test_fgp_fused_mom_matches_pallas_bf16(shape, n_iter, lam):
    x, x_old = _vol(shape, 4), _vol(shape, 5)
    beta = 0.4
    d_r, y_r, _ = tv_fgp_pallas_fused(
        jnp.asarray(x), n_iter, lam, interpret=True,
        dual_dtype=jnp.bfloat16, mom=(jnp.asarray(x_old), beta))
    d, y = tv_fgp_fused(torch.from_numpy(x), n_iter, lam,
                        dual_dtype=torch.bfloat16,
                        mom=(torch.from_numpy(x_old), torch.tensor(beta)))
    assert d.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), atol=lam * 2e-2)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=lam * 2e-2)


@pytest.mark.parametrize("shape,n_iter,lam", [((8, 16, 16), 5, 0.1),
                                              ((6, 9, 13), 1, 0.3)])
def test_tv_fgp_matches_xla(shape, n_iter, lam):
    x = _vol(shape, 6)
    d_r, tv0_r = jtv.tv_fgp(jnp.asarray(x), n_iter, lam)
    d, tv0 = tv_fgp(torch.from_numpy(x), n_iter, lam,
                    dual_dtype=torch.float32)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), atol=1e-5)
    np.testing.assert_allclose(float(tv0), float(tv0_r), rtol=1e-5)


def test_fgp_wrappers_reject_bad_operands():
    x = torch.ones((4, 5, 6))
    p16 = torch.zeros((4, 5, 6), dtype=torch.float16)
    with pytest.raises(ValueError):
        fgp_iter(x, p16, p16, p16, 0.1)
    p = torch.zeros((4, 5, 6))
    with pytest.raises(ValueError):
        fgp_obj_mom(x, p, p, p, 0.1, x_old=x)  # beta missing
    with pytest.raises(ValueError):
        tv_value(torch.ones((5, 6)))
    with pytest.raises(ValueError):
        tv_fgp_fused(x, 0, 0.1)


@pytest.mark.cuda
def test_tv_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    x = torch.from_numpy(_vol((24, 40, 36), 7)).to(dev)
    x_old = torch.from_numpy(_vol((24, 40, 36), 8)).to(dev)
    beta = torch.tensor(0.3, device=dev)
    np.testing.assert_allclose(float(tv_value(x)), float(tv_value_ref(x)),
                               rtol=2e-5)
    # K5's march across its boundaries, with and without a right halo, and
    # a 4D stack in one launch
    for shape in [(5, 11, 37), (40, 16, 1), (70, 33, 130), (1, 8, 32)]:
        xs = torch.from_numpy(_vol(shape, 15)).to(dev)
        for hi in (None, torch.from_numpy(_vol(shape[:2], 16)).to(dev)):
            np.testing.assert_allclose(float(tv_value(xs, hi)),
                                       float(tv_value_ref(xs, hi)),
                                       rtol=2e-5)
    stack = torch.from_numpy(_vol((3, 24, 40, 36), 17)).to(dev)
    before = tv_value.launches
    np.testing.assert_allclose(float(tv_value(stack)),
                               float(tv_value_ref(stack)), rtol=2e-5)
    assert tv_value.launches == before + 1
    for dt in (torch.float32, torch.bfloat16):
        p = tuple(torch.zeros(x.shape, dtype=dt, device=dev)
                  for _ in range(3))
        q = p
        for _ in range(4):
            p = fgp_iter(x, *p, 0.1)
            q = fgp_iter_ref(x, *q, 0.1)
        d, y = fgp_obj_mom(x, *p, 0.1, x_old, beta)
        d_r, y_r = fgp_obj_mom_ref(x, *q, 0.1, x_old, beta)
        tol = 1e-4 if dt == torch.float32 else 0.1 * 2e-2
        assert float((d - d_r).abs().max()) <= tol
        assert float((y - y_r).abs().max()) <= 2 * tol
    # K3's march across its boundaries: n0 below and above TV_C, ragged n1
    # and n2, n2 = 1; one iteration from random duals
    for shape in [(5, 11, 37), (40, 16, 1), (70, 33, 130)]:
        x = torch.from_numpy(_vol(shape, 9)).to(dev)
        for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2 ** -7)):
            p = tuple(torch.from_numpy(_vol(shape, 10 + k, -0.5)).to(dev, dt)
                      for k in range(3))
            for a, b in zip(fgp_iter(x, *p, 0.1), fgp_iter_ref(x, *p, 0.1)):
                assert float((a.float() - b.float()).abs().max()) <= tol
