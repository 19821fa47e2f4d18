"""tomojax_torch slice-last FISTA-TV (the slice as a whole) held against
tomojax's fista_run_sl and the recorded CPU golden trace.

The reference runs its Pallas path in interpret mode with f32 duals and
Precision.HIGHEST, as tests/test_solvers.py runs it; the port runs its
plain versions with f32 duals. Both start from the same System
(convert.system_from_numpy) and the same sinogram.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import config as tjconfig  # noqa: E402
from tomojax import ops as j_ops  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.solvers import (  # noqa: E402
    fista_init as j_init_sf, fista_init_sl as j_init,
    fista_run as j_run_sf, fista_run_sl as j_run, fista_step as j_step_sf,
    make_system as j_sys, to_sl as j_to_sl,
)

import tomojax_torch.config  # noqa: E402
from tomojax_torch import ops  # noqa: E402
from tomojax_torch.convert import (  # noqa: E402
    state_sl_from_numpy, system_from_numpy,
)
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.sim import create_projections, shepp_logan  # noqa: E402
from tomojax_torch.solvers import (  # noqa: E402
    fista_init, fista_init_sl, fista_run, fista_run_sl, fista_step,
    fista_step_sl, from_sl, make_system,
)
from test_golden_traces import (  # noqa: E402
    GOLDEN_FISTA_DD, GOLDEN_FISTA_RMSE,
)

X_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def f32_duals(monkeypatch):
    """Both packages store FGP duals in f32; the reference projector runs
    at HIGHEST. The reference config is restored afterwards."""
    monkeypatch.setattr(tomojax_torch.config, "fgp_dual_dtype",
                        torch.float32)
    prev = (tjconfig.tv_impl, tjconfig.fgp_dual_dtype,
            tjconfig.pallas_precision)
    tjconfig.set_tv_impl("auto", dual_dtype=jnp.float32)
    tjconfig.pallas_precision = jax.lax.Precision.HIGHEST
    try:
        yield
    finally:
        tjconfig.set_tv_impl(prev[0], dual_dtype=prev[1])
        tjconfig.pallas_precision = prev[2]


def _problem(ns=8, n=32, na=15):
    ang = np.deg2rad(np.linspace(-70, 70, na))
    jgeom = JGeometry.make(n, ang)
    jsys = j_sys(jgeom)
    geom = Geometry.make(n, ang)
    sysd = system_from_numpy(geom, np.asarray(jsys.row_sum),
                             np.asarray(jsys.col_sum),
                             np.asarray(jsys.lipschitz), "cpu")
    rng = np.random.default_rng(0)
    gt = np.stack([shepp_logan(n)] * ns) * rng.uniform(
        0.8, 1.2, size=(ns, 1, 1)).astype(np.float32)
    b_sl = np.array(j_to_sl(j_fp(jnp.asarray(gt), jgeom, mode="gather")))
    return jsys, sysd, b_sl


def _j_run(jsys, st, b_sl, lam, n_iter, n_tv, momentum, compat):
    run = jax.jit(lambda s, bb: j_run(s, bb, jsys, lam, n_iter, n_tv,
                                      momentum, compat))
    return run(st, jnp.asarray(b_sl))


@pytest.mark.parametrize("momentum,compat", [(True, "correct"),
                                             (False, "correct"),
                                             (True, "reference")])
def test_fista_run_sl_matches_reference(f32_duals, momentum, compat):
    ns, n = 8, 32
    jsys, sysd, b_sl = _problem(ns, n)
    jst = j_init(jnp.zeros((ns, n, n), jnp.float32), jsys,
                 jnp.asarray(b_sl))
    jst, jm = _j_run(jsys, jst, b_sl, 0.05, 4, 5, momentum, compat)
    b = torch.from_numpy(b_sl)
    st = fista_init_sl(torch.zeros((ns, n, n)), sysd, b)
    st, m = fista_run_sl(st, b, sysd, 0.05, 4, 5, momentum, compat)
    assert m.shape == (4, 3)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), **X_TOL)
    np.testing.assert_allclose(st.yk.numpy(), np.asarray(jst.yk), **X_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-4)


@pytest.mark.parametrize("momentum,compat", [(True, "correct"),
                                             (False, "correct"),
                                             (True, "reference"),
                                             (False, "reference")])
def test_slice_first_fista_matches_reference(f32_duals, momentum, compat):
    """fista_init / fista_run (3 iterations), then one fista_step, in the
    reference's layout and state, against tomojax.solvers' slice-first
    functions (its XLA path): every field at X_TOL, the atol scaled by
    the field's largest magnitude where that exceeds 1 (the projections
    ax, ay); the metrics at rtol 2e-4."""
    ns, n = 6, 32
    jsys, sysd, b_sl = _problem(ns, n)
    b = np.ascontiguousarray(b_sl.transpose(2, 0, 1))  # (Ns, Na, Nt)
    x0 = np.zeros((ns, n, n), np.float32)
    jst = j_init_sf(jnp.asarray(x0), jsys)
    jst, jm = jax.jit(lambda s, bb: j_run_sf(s, bb, jsys, 0.05, 3, 5,
                                             momentum, compat))(
        jst, jnp.asarray(b))
    jst, jm1 = jax.jit(lambda s, bb: j_step_sf(s, bb, jsys, 0.05, 5,
                                               momentum, compat))(
        jst, jnp.asarray(b))
    bt = torch.from_numpy(b)
    st = fista_init(torch.from_numpy(x0), sysd)
    st, m = fista_run(st, bt, sysd, 0.05, 3, 5, momentum, compat)
    st, m1 = fista_step(st, bt, sysd, 0.05, 5, momentum, compat)
    assert m.shape == (3, 3) and len(m1) == 3
    for name in ("x", "x_old", "yk", "ax", "ay"):
        got, want = getattr(st, name).numpy(), np.asarray(getattr(jst, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=name)
    np.testing.assert_allclose(float(st.t), float(jst.t), rtol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-4)
    np.testing.assert_allclose([float(v) for v in m1],
                               [float(v) for v in jm1], rtol=2e-4)


def test_slice_first_fista_without_metrics_and_zero_iterations(f32_duals):
    jsys, sysd, b_sl = _problem(2, 32)
    b = torch.from_numpy(np.ascontiguousarray(b_sl.transpose(2, 0, 1)))
    st0 = fista_init(torch.zeros((2, 32, 32)), sysd)
    st, m = fista_run(st0, b, sysd, 0.05, 0)
    assert m.shape == (0, 3) and torch.equal(st.x, st0.x)
    assert torch.equal(st.ay, st0.ay)
    _, m1 = fista_step(st0, b, sysd, 0.05, 5, compute_metrics=False)
    assert all(float(v) == 0.0 for v in m1)


def test_state_carried_across_from_reference(f32_duals):
    """One reference step, convert its padded state, then one more step
    in each package from the same state."""
    ns, n, na = 6, 32, 15  # ns and na both get padded by the reference
    jsys, sysd, b_sl = _problem(ns, n, na)
    jst = j_init(jnp.zeros((ns, n, n), jnp.float32), jsys,
                 jnp.asarray(b_sl))
    jst, _ = _j_run(jsys, jst, b_sl, 0.05, 1, 5, True, "correct")
    st = state_sl_from_numpy(
        np.asarray(jst.x), np.asarray(jst.x_old), np.asarray(jst.yk),
        np.asarray(jst.t), np.asarray(jst.ax), np.asarray(jst.resid), na, ns,
        "cpu")
    assert st.ax.shape == (na, n, ns) and np.asarray(jst.ax).shape[0] == 16
    jst, jm = _j_run(jsys, jst, b_sl, 0.05, 1, 5, True, "correct")
    st, m = fista_step_sl(st, torch.from_numpy(b_sl), sysd, 0.05, 5)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), **X_TOL)
    np.testing.assert_allclose(float(st.t), float(jst.t), rtol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[0], rtol=2e-4)


def test_golden_fista_trace(f32_duals):
    """The port alone (its own geometry, weights and projections) replays
    the reference's CPU golden trace (tests/test_golden_traces.py)."""
    n = 32
    geom = Geometry.make(n, np.deg2rad(np.linspace(-70, 70, 20)))
    sysd = make_system(geom, "cpu")
    ph = torch.from_numpy(shepp_logan(n)[None])
    b_sl = create_projections(ph, geom).permute(1, 2, 0).contiguous()
    st = fista_init_sl(torch.zeros_like(ph), sysd, b_sl)
    dd, rmse = [], []
    for _ in range(10):
        st, m = fista_step_sl(st, b_sl, sysd, 0.01, 5, True)
        dd.append(float(m[1]))
        rmse.append(float(ops.rmse(from_sl(st.x), ph)))
    np.testing.assert_allclose(dd, GOLDEN_FISTA_DD, rtol=2e-3)
    np.testing.assert_allclose(rmse, GOLDEN_FISTA_RMSE, rtol=2e-3)


@pytest.mark.parametrize("name", ["positivity", "set_background", "nesterov",
                                  "rmse", "data_distance"])
def test_ops_match_reference(name):
    rng = np.random.default_rng(7)
    a = rng.normal(size=(3, 5, 6)).astype(np.float32)
    a[0, 0, :3] = 0.0
    b = rng.normal(size=(3, 5, 6)).astype(np.float32)
    args = {"positivity": (a,), "set_background": (a, 1.0),
            "nesterov": (a, b, 0.3), "rmse": (a, b),
            "data_distance": (a, b)}[name]
    ref = getattr(j_ops, name)(*(jnp.asarray(v) if isinstance(v, np.ndarray)
                                  else v for v in args))
    got = getattr(ops, name)(*(torch.from_numpy(v)
                               if isinstance(v, np.ndarray) else v
                               for v in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
