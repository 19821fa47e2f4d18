"""tomojax_torch SIRT (astra, landweber, cimmino), Poisson-ML and the
least-squares step held against tomojax, and ``TomoTorch.sirt`` /
``.kl_divergence`` against ``TomoTPU``'s.

The reference runs its XLA paths on the CPU, where it projects in 'mxu'
mode (a dense float32 contraction); the port runs the 2-tap gathers of its
plain versions. The two round differently in the last digits, so results
are held at 1e-4 relative (1e-4 of the largest magnitude, as
tests/test_torch_projector.py holds the projectors).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import TomoTPU  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.solvers import (  # noqa: E402
    least_squares_step as j_lsq, make_system as j_sys,
    poisson_ml_step as j_poisson, sirt_sweep as j_sirt,
)
from tomojax.solvers.base import row_norms_sq as j_row_norms_sq  # noqa: E402

from tomojax_torch import TomoTorch  # noqa: E402
from tomojax_torch.convert import system_from_numpy  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector.cuda_joseph import bp_sirt_sl, fp_sl  # noqa: E402
from tomojax_torch.sim import shepp_logan  # noqa: E402
from tomojax_torch.solvers import (  # noqa: E402
    least_squares_step, poisson_ml_step, row_norms_sq, sirt_sweep,
    sirt_sweep_sl, to_sl,
)

N, NA, NS = 24, 17, 8
ANGLES = np.linspace(-70, 70, NA)


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def problem():
    ang = np.deg2rad(ANGLES)
    jgeom = JGeometry.make(N, ang)
    jsys = j_sys(jgeom)
    sysd = system_from_numpy(Geometry.make(N, ang), np.asarray(jsys.row_sum),
                             np.asarray(jsys.col_sum),
                             np.asarray(jsys.lipschitz), "cpu")
    rng = np.random.default_rng(0)
    ph = (np.stack([shepp_logan(N)] * NS)
          * rng.uniform(0.8, 1.2, size=(NS, 1, 1))).astype(np.float32)
    b = np.array(j_fp(jnp.asarray(ph), jgeom))
    return jgeom, jsys, sysd, ph, b


def test_row_norms_sq_matches_reference(problem):
    jgeom, _, sysd, _, _ = problem
    got = row_norms_sq(sysd.geom, "cpu")
    assert got.shape == (NA, N) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_row_norms_sq(jgeom))[0])


@pytest.mark.parametrize("variant,nonneg", [("astra", None), ("astra", False),
                                            ("landweber", None),
                                            ("landweber", True),
                                            ("cimmino", None)])
def test_sirt_sweep_matches_reference(problem, variant, nonneg):
    jgeom, jsys, sysd, _, b = problem
    rng = np.random.default_rng(1)
    x0 = rng.uniform(0.0, 0.5, size=(NS, N, N)).astype(np.float32)
    jkw, kw = {}, {}
    if variant == "cimmino":
        jkw["row_nsq"] = j_row_norms_sq(jgeom)
        kw["row_nsq"] = row_norms_sq(sysd.geom, "cpu")
    ref = j_sirt(jnp.asarray(x0), jnp.asarray(b), jsys, 4, variant=variant,
                 nonneg=nonneg, **jkw)
    got = sirt_sweep(torch.from_numpy(x0), torch.from_numpy(b), sysd, 4,
                     variant=variant, nonneg=nonneg, **kw)
    _close(got.numpy(), ref)


def test_sirt_sweep_ab_and_errors(problem):
    """The ASTRA-SIRT loop written on bp_sirt_sl(ab=4) (K10's plain
    version) gives sirt_sweep_sl's result; unknown variants and a cimmino
    call without row norms raise."""
    _, _, sysd, _, b = problem
    b_sl = to_sl(torch.from_numpy(b))
    x = torch.zeros((N, N, NS))
    geom = sysd.geom
    v = x
    for _ in range(3):
        resid = (b_sl - fp_sl(v, geom)) * sysd.inv_row[:, :, None]
        v = bp_sirt_sl(resid, geom, v, sysd.inv_col, ab=4)
    assert torch.equal(v, sirt_sweep_sl(x, b_sl, sysd, 3, "astra"))
    with pytest.raises(ValueError):
        sirt_sweep_sl(x, b_sl, sysd, 1, "kaczmarz")
    with pytest.raises(ValueError):
        sirt_sweep_sl(x, b_sl, sysd, 1, "cimmino")


def test_poisson_and_least_squares_match_reference(problem):
    _, jsys, sysd, _, b = problem
    bn = b / b.max()
    rng = np.random.default_rng(2)
    x0 = rng.uniform(0.0, 0.3, size=(NS, N, N)).astype(np.float32)
    xj, cj = jnp.asarray(x0), None
    xt = torch.from_numpy(x0)
    for _ in range(3):
        xj, cj = j_poisson(xj, jnp.asarray(bn), jsys, 0.5)
        xt, ct = poisson_ml_step(xt, torch.from_numpy(bn), sysd, 0.5)
    _close(xt.numpy(), xj)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    ref = j_lsq(jnp.asarray(x0), jnp.asarray(b), jsys)
    got = least_squares_step(torch.from_numpy(x0), torch.from_numpy(b), sysd)
    _close(got.numpy(), ref)


def _series():
    """(Nslice, Nray, Nangles); Nslice = 8 divides the suite's 8-device
    mesh, so TomoTPU runs unpadded."""
    rng = np.random.default_rng(3)
    ph = (np.stack([shepp_logan(N)] * NS)
          * rng.uniform(0.8, 1.2, size=(NS, 1, 1))).astype(np.float32)
    geom = JGeometry.make(N, np.deg2rad(ANGLES))
    b = np.asarray(j_fp(jnp.asarray(ph), geom))
    return np.ascontiguousarray(np.transpose(b, (0, 2, 1)))


@pytest.mark.parametrize("variant", ["astra", "landweber", "cimmino"])
def test_tomotorch_sirt_matches_tomotpu(variant):
    ts = _series()
    ref = TomoTPU(ANGLES, ts).sirt(Niter=5, variant=variant)
    got = TomoTorch(ANGLES, ts, device="cpu").sirt(Niter=5, variant=variant)
    np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-4)
    _close(got.get_recon(), ref.get_recon())
    assert got.cost[-1] < got.cost[0]


def test_tomotorch_kl_divergence_matches_tomotpu():
    ts = _series()
    ref = TomoTPU(ANGLES, ts).kl_divergence(Niter=5, lambda_param=0.5)
    got = TomoTorch(ANGLES, ts, device="cpu")
    b_before = got.b_sl.clone()
    got.kl_divergence(Niter=5, lambda_param=0.5)
    np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-4)
    _close(got.get_recon(), ref.get_recon())
    assert torch.equal(got.b_sl, b_before)  # the stored data are untouched
