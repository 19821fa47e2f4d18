"""tomojax_torch SART weights and sweep (K8's plain version) held against
tomojax.

The reference's sweep runs both ways it has on the CPU: the XLA branch of
``sart_sweep`` and the windowed Pallas kernel in interpret mode (n = 32,
so the resident kernel's 128-bin gate keeps it out), as
tests/test_solvers.py runs them. The bounds are theirs: rtol 2e-4 and
atol 2e-5 for one sweep of random data through 9 sequential clamped
steps, rtol 1e-5 for the weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import ops as j_ops  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.solvers import (  # noqa: E402
    make_sart_weights as j_weights, make_system as j_sys,
)
from tomojax.solvers.base import bp_single_angle as j_bp1  # noqa: E402
from tomojax.solvers.iterative import sart_sweep as j_sweep  # noqa: E402
from tomojax.solvers.pallas_sart import sart_sweep_pallas  # noqa: E402

from tomojax_torch import ops  # noqa: E402
from tomojax_torch.convert import (  # noqa: E402
    sart_weights_from_numpy, system_from_numpy,
)
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.sim import shepp_logan  # noqa: E402
from tomojax_torch.solvers import (  # noqa: E402
    bp_single_angle, make_sart_weights, make_system, sart_sweep,
    sart_sweep_sl, to_sl,
)
from tomojax_torch.solvers.cuda_sart import sart_sweep_sl_ref  # noqa: E402

X_TOL = dict(rtol=2e-4, atol=2e-5)
NS, N, NA = 5, 32, 9


def _problem(ns=NS, n=N, na=NA, span=70):
    ang = np.deg2rad(np.linspace(-span, span, na))
    jgeom = JGeometry.make(n, ang)
    jsys = j_sys(jgeom)
    geom = Geometry.make(n, ang)
    sysd = system_from_numpy(geom, np.asarray(jsys.row_sum),
                             np.asarray(jsys.col_sum),
                             np.asarray(jsys.lipschitz), "cpu")
    gt = np.stack([shepp_logan(n)] * ns).astype(np.float32)
    b = np.array(j_fp(jnp.asarray(gt), jgeom))  # (Ns, Na, Nt)
    return jsys, sysd, gt, b


def _orders(na=NA):
    perm = np.random.default_rng(5).permutation(na).astype(np.int32)
    return [None, perm]


def test_make_sart_weights_matches_reference():
    jsys, sysd, _, _ = _problem()
    ref = np.asarray(j_weights(jsys))
    got = make_sart_weights(sysd)
    assert got.shape == (NA, N, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    # the port's own System gives the same weights: they depend only on
    # the geometry
    own = make_sart_weights(make_system(sysd.geom, "cpu"))
    np.testing.assert_allclose(own.numpy(), ref, rtol=1e-5)


def test_bp_single_angle_one_angle_matches_reference():
    rng = np.random.default_rng(2)
    y = rng.normal(size=(3, N)).astype(np.float32)
    c, s = np.float32(np.cos(0.4)), np.float32(np.sin(0.4))
    ref = np.asarray(j_bp1(jnp.asarray(y), c, s, N))
    got = bp_single_angle(torch.from_numpy(y), float(c), float(s), N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("order_kind", ["sequential", "permuted"])
def test_sart_sweep_matches_reference(order_kind):
    jsys, sysd, _, b = _problem()
    order = _orders()[order_kind == "permuted"]
    w = j_weights(jsys)
    x0 = np.random.default_rng(0).random((NS, N, N)).astype(np.float32)
    j_order = None if order is None else jnp.asarray(order)
    ref_xla = np.asarray(j_sweep(jnp.asarray(x0), jnp.asarray(b), jsys, w,
                                 beta=0.7, order=j_order))
    ref_pallas = np.asarray(sart_sweep_pallas(
        jnp.asarray(x0), jnp.asarray(b), jsys.geom, jsys.inv_row[0], w,
        beta=0.7, order=j_order, interpret=True))
    got = sart_sweep(torch.from_numpy(x0), torch.from_numpy(b), sysd,
                     make_sart_weights(sysd), 0.7,
                     None if order is None else torch.from_numpy(order))
    np.testing.assert_allclose(got.numpy(), ref_xla, **X_TOL)
    np.testing.assert_allclose(got.numpy(), ref_pallas, **X_TOL)


def test_sart_sweep_tensor_beta_and_carried_weights():
    """A 0-dim tensor beta gives the float's sweep, and weights carried
    across with convert give the port's own."""
    jsys, sysd, _, b = _problem()
    w_carried = sart_weights_from_numpy(np.asarray(j_weights(jsys)), "cpu")
    assert w_carried.shape == (NA, N, N) and w_carried.is_contiguous()
    w = make_sart_weights(sysd)
    np.testing.assert_allclose(w_carried.numpy(), w.numpy(), rtol=1e-5)
    x0 = torch.from_numpy(
        np.random.default_rng(1).random((NS, N, N)).astype(np.float32))
    bt = torch.from_numpy(b)
    by_float = sart_sweep(x0, bt, sysd, w_carried, 0.7)
    by_tensor = sart_sweep(x0, bt, sysd, w_carried, torch.tensor(0.7))
    assert torch.equal(by_float, by_tensor)
    ref = np.asarray(j_sweep(jnp.asarray(x0.numpy()), jnp.asarray(b), jsys,
                             j_weights(jsys), beta=0.7))
    np.testing.assert_allclose(by_tensor.numpy(), ref, **X_TOL)
    with pytest.raises(ValueError):
        sart_weights_from_numpy(np.zeros((NA, N, N + 1)), "cpu")


def test_sart_five_sweeps_converge_like_reference():
    """Convergence: rmse against the phantom after 5 sweeps from zero on a
    consistent problem within 1e-4 of the reference's."""
    ns, n, na = 4, 32, 20
    jsys, sysd, gt, b = _problem(ns, n, na, span=76)
    w_j = j_weights(jsys)
    w = make_sart_weights(sysd)
    x_j = jnp.zeros((ns, n, n), jnp.float32)
    x = torch.zeros((ns, n, n))
    for _ in range(5):
        x_j = j_sweep(x_j, jnp.asarray(b), jsys, w_j, beta=1.0)
        x = sart_sweep(x, torch.from_numpy(b), sysd, w, 1.0)
    rmse_j = float(j_ops.rmse(x_j, jnp.asarray(gt)))
    rmse = float(ops.rmse(x, torch.from_numpy(gt)))
    assert rmse < 0.5 * float(np.sqrt(np.mean(gt * gt)))  # it converges
    assert abs(rmse - rmse_j) < 1e-4


def test_sart_sweep_sl_single_step_and_visits():
    """An order of one angle is one block-Kaczmarz step, and a repeated
    angle is visited twice."""
    _, sysd, _, b = _problem()
    w = make_sart_weights(sysd)
    b_sl = to_sl(torch.from_numpy(b))
    x = torch.zeros((N, N, NS))
    beta = torch.tensor(1.0)
    one = sart_sweep_sl(x, b_sl, sysd.geom, sysd.inv_row, w, beta,
                        torch.tensor([3], dtype=torch.int32))
    assert float(one.abs().max()) > 0.0
    two = sart_sweep_sl(x, b_sl, sysd.geom, sysd.inv_row, w, beta,
                        torch.tensor([3, 3], dtype=torch.int32))
    again = sart_sweep_sl(one, b_sl, sysd.geom, sysd.inv_row, w, beta,
                          torch.tensor([3], dtype=torch.int32))
    assert torch.equal(two, again)


def test_sart_sweep_sl_rejects_bad_operands():
    _, sysd, _, b = _problem()
    w = make_sart_weights(sysd)
    b_sl = to_sl(torch.from_numpy(b))
    x = torch.zeros((N, N, NS))
    beta = torch.tensor(1.0)
    order = torch.arange(NA, dtype=torch.int32)
    g, ir = sysd.geom, sysd.inv_row
    with pytest.raises(ValueError):  # order not int32
        sart_sweep_sl(x, b_sl, g, ir, w, beta, order.long())
    with pytest.raises(ValueError):  # empty order
        sart_sweep_sl(x, b_sl, g, ir, w, beta, order[:0])
    with pytest.raises(ValueError):  # beta not 0-dim
        sart_sweep_sl(x, b_sl, g, ir, w, beta.reshape(1), order)
    with pytest.raises(ValueError):  # weights of another geometry
        sart_sweep_sl(x, b_sl, g, ir, w[:-1], beta, order)
    with pytest.raises(ValueError):  # sinogram of another slice count
        sart_sweep_sl(x, b_sl[:, :, :-1], g, ir, w, beta, order)
    with pytest.raises(IndexError):  # the plain version indexes the angle
        sart_sweep_sl_ref(x, b_sl, g, ir, w, beta,
                          torch.tensor([NA], dtype=torch.int32))


@pytest.mark.cuda
def test_sart_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    _, sysd, _, b = _problem(6, 40, 15)
    sys_c = system_from_numpy(sysd.geom, sysd.row_sum, sysd.col_sum,
                              sysd.lipschitz, dev)
    w = make_sart_weights(sys_c)
    b_sl = to_sl(torch.from_numpy(b)).to(dev)
    x = to_sl(torch.from_numpy(np.random.default_rng(3).random(
        (6, 40, 40)).astype(np.float32))).to(dev)
    beta = torch.tensor(0.7, device=dev)
    for order in (torch.tensor([4], dtype=torch.int32, device=dev),
                  torch.arange(15, dtype=torch.int32, device=dev)):
        got = sart_sweep_sl(x, b_sl, sys_c.geom, sys_c.inv_row, w, beta,
                            order)
        ref = sart_sweep_sl_ref(x, b_sl, sys_c.geom, sys_c.inv_row, w, beta,
                                order)
        tol = (1e-5 if order.numel() == 1 else 1e-3) * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol
    assert torch.equal(x, to_sl(torch.from_numpy(np.random.default_rng(
        3).random((6, 40, 40)).astype(np.float32))).to(dev))  # input kept


@pytest.mark.cuda
def test_sart_routes_match_plain_on_card():
    """Both routes of csrc/sart.cu against the plain version: resident
    (8, 4) at N 33, Na 7, Ns 5 (a ragged slab, empty last band) and N 40
    with 5 extra bins, resident (16, 2) at N 320, Ns 3 (an odd slab),
    resident (16, 1) in the spilling layout at N 544 (no row spilled) and
    N 1024 (13 rows a block in device memory), streaming at N 1056; the C
    route and spilled rows are the Python helpers' (at the turns 288/289,
    528/529, 918/919 and 1052/1053 too), an out-of-range order entry
    leaves x as it was, and two runs agree bit for bit (no float atomics),
    as does the spilling shape's FP walked one round after another."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tomojax_torch import _build
    from tomojax_torch.projector.cuda_joseph import fp_sl
    from tomojax_torch.solvers import cuda_sart

    dev = torch.device("cuda")
    lib = _build.lib()
    for n, nt in ((16, 16), (256, 256), (256, 263), (288, 288), (289, 289),
                  (320, 320), (512, 512), (528, 528), (529, 529),
                  (544, 544), (918, 918), (919, 919), (1024, 1024),
                  (1024, 1031), (1052, 1052), (1053, 1053), (1056, 1056)):
        shape = cuda_sart.sart_shape(n, nt)
        want = 0 if shape is None else cuda_sart.K8_SHAPES.index(shape) + 1
        assert lib.tj_sart_route(n, nt) == want, (n, nt)
        assert lib.tj_sart_spill_rows(n, nt) == cuda_sart.route_spill_rows(
            n, nt), (n, nt)
    rng = np.random.default_rng(4)
    for n, na, ns, extra, shape in ((33, 7, 5, 0, (8, 4)),
                                    (40, 15, 4, 5, (8, 4)),
                                    (320, 5, 3, 0, (16, 2)),
                                    (544, 5, 3, 0, (16, 1)),
                                    (1024, 5, 3, 0, (16, 1)),
                                    (1056, 5, 3, 0, None)):
        geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)),
                             nray=n + extra)
        assert cuda_sart.sart_shape(n, geom.nray) == shape
        route = cuda_sart.sart_route(n, geom.nray)
        sys_c = make_system(geom, dev)
        w = make_sart_weights(sys_c)
        vol = to_sl(torch.from_numpy(
            np.stack([shepp_logan(n)] * ns).astype(np.float32))).to(dev)
        b_sl = fp_sl(vol, geom)
        x = torch.from_numpy(rng.random((n, n, ns), np.float32)).to(dev)
        keep = x.clone()
        beta = torch.tensor(1.0, device=dev)
        args = (b_sl, geom, sys_c.inv_row, w, beta)
        for a in (0, na // 2):
            order = torch.tensor([a], dtype=torch.int32, device=dev)
            got = sart_sweep_sl(x, *args, order)
            ref = sart_sweep_sl_ref(x, *args, order)
            assert float((got - ref).abs().max()) <= 1e-5 * float(
                ref.abs().max()), (shape, a)
        seq = torch.arange(na, dtype=torch.int32, device=dev)
        x0 = torch.zeros_like(x)
        got = sart_sweep_sl(x0, *args, seq)
        ref = sart_sweep_sl_ref(x0, *args, seq)
        assert float((got - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max()), shape
        assert torch.equal(sart_sweep_sl(x0, *args, seq), got)
        skip = torch.tensor([na, -1], dtype=torch.int32, device=dev)
        assert torch.equal(sart_sweep_sl(x, *args, skip), x)
        assert torch.equal(x, keep)
        if route == "resident":  # the timed instantiation walks every step
            for serial_fp in (False, True):
                timed = torch.empty_like(x0)
                phases = cuda_sart.resident_phases(x0, *args, seq, serial_fp,
                                                   timed)
                assert sum(v["steps"] for v in phases.values()) == na
                assert all(v["FP"] > 0 for v in phases.values()
                           if v["steps"])
                assert torch.equal(timed, got), (shape, serial_fp)
            launch = cuda_sart.resident_clusters(n, geom.nray, ns)
            assert (launch["blocks"], launch["slices"]) == shape
            assert launch["active"] > 0
            assert launch["spill_rows"] == cuda_sart.route_spill_rows(
                n, geom.nray)
