"""tomojax_torch K9a/K9b/K9c and K5's right halo on emulated slabs, in one
process, held against tomojax's sharded TV kernels.

A volume is cut into k slice-last slabs and each slab is driven with the
halo planes its neighbours would send: a chain with zeros at its ends for
the FGP prox, a ring for TV-GD and the TV value. The reference runs
``tv_fgp_sharded`` and ``tv_gd_sharded`` on ``tomojax.dist.make_mesh(k)``
(interpret mode, as tests/test_pallas_tv.py runs them). The port works
slice-last, so volumes cross over as ``x.transpose(1, 2, 0)``.

Bounds: the slab chains of the plain versions equal the port's unsharded
plain versions exactly (the same per-element arithmetic) with f32 and bf16
duals, and the subgradient g exactly; the TV value and ||g||^2 (summed in
another order) at rtol 1e-6. Against the reference: atol 1e-5 on the
denoised and descended volumes with f32 duals and rtol 1e-5 on TV values
(test_torch_tv.py's bounds unsharded), lam * 2e-2 with bf16 duals (the
bound of the unsharded bf16 test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import config as tjconfig  # noqa: E402
from tomojax import dist as jdist  # noqa: E402
from tomojax import tv as jtv  # noqa: E402
from tomojax.tv.pallas_fgp_sharded import tv_fgp_sharded  # noqa: E402
from tomojax.tv.pallas_tvgd_sharded import tv_gd_sharded  # noqa: E402

from tomojax_torch.tv import tv_gd  # noqa: E402
from tomojax_torch.tv.cuda_fgp import tv_fgp_fused  # noqa: E402
from tomojax_torch.tv.cuda_fgp_sharded import (  # noqa: E402
    fgp_iter_halo, fgp_iter_halo_ref, fgp_obj_halo, fgp_obj_halo_ref,
)
from tomojax_torch.tv.cuda_tv_value import (  # noqa: E402
    tv_value, tv_value_ref,
)
from tomojax_torch.tv.cuda_tvgd import tv_grad, tv_grad_ref  # noqa: E402
from tomojax_torch.tv.cuda_tvgd_sharded import (  # noqa: E402
    tv_grad_halo, tv_grad_halo_ref,
)

SHAPE = (16, 12, 16)  # (Ns, N0, N1): 8- and 4-slice slabs


def _vol(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32) + 0.5


def _sl(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(1, 2, 0)))


def _public(t: torch.Tensor) -> np.ndarray:
    return t.permute(2, 0, 1).cpu().numpy()


def _slabs(x: torch.Tensor, k: int):
    n = x.shape[2] // k
    return [x[:, :, i * n:(i + 1) * n].contiguous() for i in range(k)]


def _first(t):
    return t[:, :, 0].contiguous()


def _last(t):
    return t[:, :, -1].contiguous()


def fgp_chain(x, k, n_iter, lam, dual_dtype, mom=None):
    """The FGP prox of x on k emulated slabs: K9a n_iter - 1 times, each
    slab reading its neighbours' planes (zeros below slab 0, no right halo
    on slab k - 1), then K9b. Returns d (and y with mom), whole."""
    xs = _slabs(x, k)
    zero = torch.zeros(x.shape[:2], dtype=dual_dtype, device=x.device)
    p = [tuple(torch.zeros_like(s, dtype=dual_dtype) for _ in range(3))
         for s in xs]
    for _ in range(n_iter - 1):
        p = [fgp_iter_halo(
            xs[i], *p[i], lam, _last(p[i - 1][2]) if i else zero,
            None if i == k - 1 else (_first(xs[i + 1]),
                                     *(_first(q) for q in p[i + 1])))
             for i in range(k)]
    olds = [None] * k if mom is None else _slabs(mom[0], k)
    beta = None if mom is None else mom[1]
    out = [fgp_obj_halo(xs[i], *p[i], lam,
                        _last(p[i - 1][2]) if i else zero, olds[i], beta)
           for i in range(k)]
    d = torch.cat([o[0] for o in out], dim=2)
    return d if mom is None else (d, torch.cat([o[1] for o in out], dim=2))


def ring_halos(xs, i):
    k = len(xs)
    return _last(xs[i - 1]), _first(xs[(i + 1) % k])


def gd_chain(x, k, ng, dpocs):
    """TV-GD of x on k emulated slabs: K9c with ring halos per step, the
    slabs' ||g||^2 summed (the all-reduce), the PyTorch step and clamp."""
    xs = _slabs(x, k)
    for _ in range(ng):
        out = [tv_grad_halo(xs[i], *ring_halos(xs, i)) for i in range(k)]
        gsq = sum(o[1] for o in out)
        xs = [s - dpocs * o[0] / torch.sqrt(gsq) for s, o in zip(xs, out)]
    return torch.clamp_min(torch.cat(xs, dim=2), 0.0)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("iters", [1, 4])
def test_fgp_slab_chain_matches_jax_sharded_f32(k, iters):
    x = _vol(1)
    mesh = jdist.make_mesh(k)
    ref, _ = jax.jit(lambda v: tv_fgp_sharded(
        v, iters, 0.2, mesh, dual_dtype=jnp.float32))(
        jdist.shard_volume(jnp.asarray(x), mesh))
    got = fgp_chain(_sl(x), k, iters, 0.2, torch.float32)
    np.testing.assert_allclose(_public(got), np.asarray(ref), atol=1e-5)
    whole = tv_fgp_fused(_sl(x), iters, 0.2, torch.float32)
    np.testing.assert_array_equal(got.numpy(), whole.numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_fgp_slab_chain_bf16_with_momentum(k):
    x, x_old = _vol(2), _vol(3)
    lam, beta = 0.1, torch.tensor(0.4)
    mesh = jdist.make_mesh(k)
    ref, _ = jax.jit(lambda v: tv_fgp_sharded(
        v, 6, lam, mesh, dual_dtype=jnp.bfloat16))(
        jdist.shard_volume(jnp.asarray(x), mesh))
    d, y = fgp_chain(_sl(x), k, 6, lam, torch.bfloat16,
                     mom=(_sl(x_old), beta))
    np.testing.assert_allclose(_public(d), np.asarray(ref), atol=lam * 2e-2)
    d_w, y_w = tv_fgp_fused(_sl(x), 6, lam, torch.bfloat16,
                            mom=(_sl(x_old), beta))
    np.testing.assert_array_equal(d.numpy(), d_w.numpy())
    np.testing.assert_array_equal(y.numpy(), y_w.numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_tvgd_ring_matches_jax_sharded(k):
    x = _vol(4)
    mesh = jdist.make_mesh(k)
    ref, _ = jax.jit(lambda v, dp: tv_gd_sharded(v, 5, dp, mesh))(
        jdist.shard_volume(jnp.asarray(x), mesh), jnp.float32(0.07))
    got = gd_chain(_sl(x), k, 5, 0.07)
    np.testing.assert_allclose(_public(got), np.asarray(ref), atol=1e-5)
    # one step's subgradient: K7's on the whole volume, exactly
    xs = _slabs(_sl(x), k)
    parts = [tv_grad_halo(xs[i], *ring_halos(xs, i)) for i in range(k)]
    g, gsq = tv_grad_ref(_sl(x))
    np.testing.assert_array_equal(torch.cat([p[0] for p in parts], 2), g)
    np.testing.assert_allclose(float(sum(p[1] for p in parts)), float(gsq),
                               rtol=1e-6)


def test_tvgd_ring_wraps_across_the_seam():
    """Rank 0's plane below is the top slab's last slice: a field with a
    sharp wrap seam (tests/test_pallas_tv.py's) descends as the unsharded
    reference does."""
    x = np.ones((16, 8, 8), np.float32)
    x[0], x[-1] = 4.0, -2.0
    ref, _ = jtv.tv_gd(jnp.asarray(x), 3, 0.1)
    np.testing.assert_allclose(_public(gd_chain(_sl(x), 4, 3, 0.1)),
                               np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_tv_value_right_halo_sums_to_the_whole(k):
    x = _sl(_vol(5))
    xs = _slabs(x, k)
    total = sum(float(tv_value(xs[i], ring_halos(xs, i)[1]))
                for i in range(k))
    np.testing.assert_allclose(total, float(tv_value_ref(x)), rtol=1e-6)
    np.testing.assert_allclose(total, float(jtv.tv(jnp.asarray(_vol(5)))),
                               rtol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_reference_mpi_model_matches_jax(k):
    """compat='reference-mpi': every slab descends alone (K7 on the slab,
    its local norm and wrap) and the TV values add up; the result differs
    with k. With a group, tv_gd does this per rank
    (tests/test_torch_dist.py)."""
    x = _vol(7)
    mesh = jdist.make_mesh(k)
    with tjconfig.mesh_scope(mesh):
        ref, tv_ref = jax.jit(lambda v: jtv.tv_gd(
            v, 5, 0.05, compat="reference-mpi"))(
            jdist.shard_volume(jnp.asarray(x), mesh))
    outs = [tv_gd(s, 5, 0.05) for s in _slabs(_sl(x), k)]
    got = torch.cat([o[0] for o in outs], dim=2)
    np.testing.assert_allclose(_public(got), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(sum(float(o[1]) for o in outs), float(tv_ref),
                               rtol=1e-5)
    other = 2 if k == 4 else 4
    alt = torch.cat([tv_gd(s, 5, 0.05)[0] for s in _slabs(_sl(x), other)], 2)
    assert not np.allclose(got.numpy(), alt.numpy(), atol=1e-5)


def test_reference_mpi_is_3d_only():
    """The reference asserts a 3D volume for compat='reference-mpi'
    (tomojax/tv/__init__.py:129); the port raises for a 4D stack."""
    x = torch.from_numpy(np.stack([_sl(_vol(7))] * 2))
    with pytest.raises(ValueError, match="reference-mpi"):
        tv_gd(x, 1, 0.05, compat="reference-mpi", axis_norm=(1, 2, 3))
    with pytest.raises(AssertionError):
        jtv.tv_gd(jnp.asarray(np.stack([_vol(7)] * 2)), 1, 0.05,
                  axis_norm=(1, 2, 3), compat="reference-mpi")


def test_halo_wrappers_take_plain_versions_on_cpu_and_check_operands():
    x = _sl(_vol(8, (6, 5, 7)))
    p = tuple(torch.full(x.shape, 0.1) for _ in range(3))
    lo, hi = torch.full(x.shape[:2], 0.2), torch.full(x.shape[:2], 0.3)
    halo = (hi, hi, hi, hi)
    for a, b in zip(fgp_iter_halo(x, *p, 0.1, lo, halo),
                    fgp_iter_halo_ref(x, *p, 0.1, lo, halo)):
        assert torch.equal(a, b)
    assert torch.equal(fgp_obj_halo(x, *p, 0.1, lo)[0],
                       fgp_obj_halo_ref(x, *p, 0.1, lo)[0])
    assert all(torch.equal(a, b) for a, b in zip(tv_grad_halo(x, lo, hi),
                                                 tv_grad_halo_ref(x, lo, hi)))
    with pytest.raises(ValueError):  # a plane of the wrong shape
        fgp_iter_halo(x, *p, 0.1, lo[:-1])
    with pytest.raises(ValueError):  # a dual plane in another dtype
        fgp_iter_halo(x, *p, 0.1, lo, (hi, hi.bfloat16(), hi, hi))
    with pytest.raises(ValueError):
        fgp_obj_halo(x, *p, 0.1, lo, x_old=x)  # beta missing
    with pytest.raises(ValueError):
        tv_grad_halo(x, lo, hi.t())
    with pytest.raises(ValueError):
        tv_value(x, hi[:, :1])
    with pytest.raises(ValueError):
        tv_gd(x, 1, 0.1, compat="mpi")


def _k9_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k9_kernels_match_plain_on_card():
    """Each rank role (bottom, interior, top) with random halo planes."""
    dev = _k9_on_card()
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (40, 36, 24)
    x = torch.rand(shape, generator=gen, device=dev)
    plane = lambda dt=torch.float32: torch.rand(  # noqa: E731
        shape[:2], generator=gen, device=dev).to(dt) * 0.5
    for dt in (torch.float32, torch.bfloat16):
        p = tuple((torch.rand(shape, generator=gen, device=dev) - 0.5).to(dt)
                  for _ in range(3))
        for role in ("bottom", "interior", "top"):
            lo = torch.zeros(shape[:2], dtype=dt, device=dev) \
                if role == "bottom" else plane(dt)
            hi = None if role == "top" else (plane(), plane(dt), plane(dt),
                                             plane(dt))
            got = fgp_iter_halo(x, *p, 0.1, lo, hi)
            ref = fgp_iter_halo_ref(x, *p, 0.1, lo, hi)
            for a, b in zip(got, ref):
                # bf16: one rounding of a value < 1 apart at most
                assert float((a.float() - b.float()).abs().max()) <= 2 ** -7
            d, _ = fgp_obj_halo(x, *p, 0.1, lo)
            d_r, _ = fgp_obj_halo_ref(x, *p, 0.1, lo)
            assert float((d - d_r).abs().max()) <= 1e-6
    lo, hi = plane(), plane()
    g, gsq = tv_grad_halo(x, lo, hi)
    g_r, gsq_r = tv_grad_halo_ref(x, lo, hi)
    assert float((g - g_r).abs().max()) <= 1e-5 * float(g_r.abs().max())
    np.testing.assert_allclose(float(gsq), float(gsq_r), rtol=2e-5)
    np.testing.assert_allclose(float(tv_value(x, hi)),
                               float(tv_value_ref(x, hi)), rtol=2e-5)


@pytest.mark.cuda
def test_k9_slab_chains_equal_k3_k4_k7_on_card():
    """The bodies are shared: 4 emulated slabs give K3/K4's prox and K7's
    subgradient on the whole volume bit for bit."""
    dev = _k9_on_card()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((32, 24, 64), generator=gen, device=dev)
    x_old = torch.rand(x.shape, generator=gen, device=dev)
    beta = torch.tensor(0.3, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        d, y = fgp_chain(x, 4, 10, 0.1, dt, mom=(x_old, beta))
        d_w, y_w = tv_fgp_fused(x, 10, 0.1, dt, mom=(x_old, beta))
        assert torch.equal(d, d_w) and torch.equal(y, y_w)
    xs = _slabs(x, 4)
    g = torch.cat([tv_grad_halo(xs[i], *ring_halos(xs, i))[0]
                   for i in range(4)], dim=2)
    assert torch.equal(g, tv_grad(x)[0])
    # a slab chain that crosses the march's chunks (n0 above TV_C) with
    # ragged planes, and the descent with the step kernel on both sides
    x = torch.rand((40, 11, 36), generator=gen, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(fgp_chain(x, 4, 6, 0.1, dt),
                           tv_fgp_fused(x, 6, 0.1, dt))
    np.testing.assert_allclose(gd_chain(x, 4, 5, 0.07).cpu().numpy(),
                               tv_gd(x, 5, 0.07)[0].cpu().numpy(), atol=1e-6)
