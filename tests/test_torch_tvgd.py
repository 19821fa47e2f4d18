"""tomojax_torch TV-GD (K7's plain version and tv_gd) held against tomojax.

The reference's XLA stencils (``_tv_grad``, ``tv_gd``) run as they are on
the CPU, its Pallas gradient in interpret mode, as tests/test_pallas_tv.py
runs it. The port works slice-last, so every volume crosses over as
``x.transpose(1, 2, 0)``. Both keep the same summation order, so the
subgradient agrees to a few ulp; atol 1e-5 on g and on the descended
volume, rtol 1e-5 on the TV value and on ||g||^2 (summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import tv as jtv  # noqa: E402
from tomojax.tv.pallas_tvgd import tv_gd_pallas, tv_grad_pallas  # noqa: E402

from tomojax_torch.tv import tv_gd  # noqa: E402
from tomojax_torch.tv.cuda_tvgd import (  # noqa: E402
    tv_grad, tv_grad_ref, tv_step, tv_step_ref,
)

VOLS = [(6, 16, 16), (5, 12, 7), (8, 9, 13)]


def _vol(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32) + 0.5


def _sl(a: np.ndarray) -> torch.Tensor:
    """Reference (Ns, N, N) -> port slice-last (N, N, Ns)."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(1, 2, 0)))


def _public(t: torch.Tensor) -> np.ndarray:
    return t.permute(2, 0, 1).numpy()


@pytest.mark.parametrize("shape", VOLS)
def test_tv_grad_matches_reference(shape):
    x = _vol(shape, 0)
    g_xla = np.asarray(jtv._tv_grad(jnp.asarray(x)))
    g_pallas = np.asarray(tv_grad_pallas(jnp.asarray(x), interpret=True))
    g, gsq = tv_grad_ref(_sl(x))
    np.testing.assert_allclose(_public(g), g_xla, atol=1e-5)
    np.testing.assert_allclose(_public(g), g_pallas, atol=1e-5)
    assert gsq.shape == ()
    np.testing.assert_allclose(float(gsq), float(np.sum(g_xla * g_xla)),
                               rtol=1e-5)
    g_w, gsq_w = tv_grad(_sl(x))  # CPU tensor: the wrapper is the plain one
    assert torch.equal(g_w, g) and torch.equal(gsq_w, gsq)


@pytest.mark.parametrize("shape", VOLS)
@pytest.mark.parametrize("ng", [1, 5])
def test_tv_gd_matches_reference(shape, ng):
    x = _vol(shape, 1)
    dpocs = 0.3
    x_xla, tv_xla = jtv.tv_gd(jnp.asarray(x), ng, dpocs)
    x_pallas, tv_pallas = tv_gd_pallas(jnp.asarray(x), ng, dpocs,
                                       interpret=True)
    got, tv0 = tv_gd(_sl(x), ng, dpocs)
    np.testing.assert_allclose(_public(got), np.asarray(x_xla), atol=1e-5)
    np.testing.assert_allclose(_public(got), np.asarray(x_pallas), atol=1e-5)
    np.testing.assert_allclose(float(tv0), float(tv_xla), rtol=1e-5)
    np.testing.assert_allclose(float(tv0), float(tv_pallas), rtol=1e-5)
    # dpocs as a 0-dim tensor (asd_pocs_run carries it on the device)
    got_t, _ = tv_gd(_sl(x), ng, torch.tensor(dpocs))
    assert torch.equal(got_t, got)


def test_tv_gd_zero_steps_only_clamps():
    x = _sl(_vol((4, 6, 5), 2))
    got, tv0 = tv_gd(x, 0, 0.5)
    assert torch.equal(got, torch.clamp_min(x, 0.0))
    np.testing.assert_allclose(float(tv0),
                               float(jtv.tv(jnp.asarray(_public(x)))),
                               rtol=1e-5)


def test_tv_grad_rejects_bad_operands():
    with pytest.raises(ValueError):
        tv_grad(torch.ones((5, 6)))
    with pytest.raises(ValueError):
        tv_grad(torch.ones((4, 5, 6), dtype=torch.float64))
    with pytest.raises(ValueError):
        tv_grad(torch.ones((4, 5, 6)).transpose(0, 2))
    with pytest.raises(ValueError):
        tv_gd(torch.ones((2, 4, 5, 6)), 1, 0.1)


@pytest.mark.cuda
def test_tv_grad_kernel_matches_plain_on_card():
    """K7 and the step at shapes across the march's boundaries (n0 below
    and above TV_C, ragged n1 and n2, n2 = 1), then tv_gd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tomojax_torch import _build
    from tomojax_torch.tv import march

    for shape in [(24, 40, 36), (5, 11, 37), (40, 16, 1), (70, 33, 130)]:
        x = _sl(_vol(shape, 3)).cuda()
        assert _build.lib().tj_tv_grad_partials(*x.shape) == \
            march.grad_partials(*x.shape)
        g, gsq = tv_grad(x)
        g_r, gsq_r = tv_grad_ref(x)
        assert float((g - g_r).abs().max()) <= 1e-5 * float(g_r.abs().max())
        np.testing.assert_allclose(float(gsq), float(gsq_r), rtol=2e-5)
        g2, gsq2 = tv_grad(x)
        assert torch.equal(g2, g) and float(gsq2) == float(gsq)
        for dp in (0.3, torch.tensor(0.3, device=x.device)):
            for clamp in (False, True):
                assert torch.equal(tv_step(x, g, gsq, dp, clamp),
                                   tv_step_ref(x, g, gsq, dp, clamp))
    x = _sl(_vol((24, 40, 36), 3)).cuda()
    before = tv_step.launches
    got, tv0 = tv_gd(x, 5, 0.3)
    assert tv_step.launches == before + 5
    ref, tv0_r = tv_gd(x.cpu(), 5, 0.3)
    assert float((got.cpu() - ref).abs().max()) <= 1e-5
    np.testing.assert_allclose(float(tv0), float(tv0_r), rtol=2e-5)
