"""tomojax_torch slab-sharded runs over gloo, held against tomojax under a
mesh.

Groups of 1, 2 and 4 ranks are spawned (torch.multiprocessing, start
method spawn) with a file-store rendezvous in a temporary directory. Each
rank runs ``tests/test_torch_dist_ranks.py``, which imports no jax, on its
slab of one problem saved by this process, and rank 0 saves what the
ranks gather. This process computes the JAX side on its 8 virtual CPU
devices (``tomojax.dist.make_mesh(k)``): the sharded Pallas kernels in
interpret mode (``tv_fgp_sharded``, ``tv_gd_sharded``; ``tv_impl='pallas'``
inside the solvers), as tests/test_pallas_tv.py and tests/test_dist.py run
them. Volumes cross over as ``x.transpose(1, 2, 0)`` (the port's slabs are
slice-last). All ranks are joined within 60 s or the test fails.

Bounds, each stated at its assertion: the TV stencils at atol 1e-5 and
rtol 1e-5 (test_torch_tv.py's bounds for the same functions unsharded);
sharded FISTA at tests/test_dist.py:268-271's (x rtol 1e-4 / atol 1e-5,
dd and tv rtol 1e-4, f32 duals); sharded ASD-POCS at test_dist.py:324-326's
(x atol 2e-3, dd rtol 1e-3); TomoTorch against TomoTPU at
test_torch_api.py's and test_torch_asd_pocs.py's; the sharded fusion at
test_dist.py:136-137's (x atol 1e-5, costs rtol 1e-4), against tomojax on
make_mesh(8) and against the unsharded port.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.multiprocessing as mp  # noqa: E402

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from tomojax import ChemicalTomo as JChemicalTomo  # noqa: E402
from tomojax import TomoTPU, dist as jdist  # noqa: E402
from tomojax import config as tjconfig  # noqa: E402
from tomojax import tv as jtv  # noqa: E402
from tomojax.fusion import (  # noqa: E402
    data_distance_chem as j_ddc, data_fusion_step as j_step,
    fp4d as j_fp4d, make_fusion_system as j_make_fsys,
    model_haadf as j_model, poisson_ml_step_4d as j_pml,
    rescale_projections as j_rescale, weights_for_elements as j_weights,
)
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.sim import shepp_logan  # noqa: E402
from tomojax.solvers import (  # noqa: E402
    fista_init, fista_step, make_asd_pocs_iteration, make_sart_weights,
    make_system,
)
from tomojax.tv.pallas_fgp_sharded import tv_fgp_sharded  # noqa: E402
from tomojax.tv.pallas_tvgd_sharded import tv_gd_sharded  # noqa: E402

import tomojax_torch.config  # noqa: E402
import test_torch_dist_ranks as rank_body  # noqa: E402
from tomojax_torch import TomoTorch  # noqa: E402
from tomojax_torch import io as tio  # noqa: E402
from tomojax_torch.stream import DynamicReconstructor  # noqa: E402
from tomojax_torch.tv import tv_fgp  # noqa: E402

WORLDS = (1, 2, 4)
JOIN_S = 60.0
TV_SHAPE = (16, 16, 16)  # (Ns, N, N): 4-slice slabs at 4 ranks
NS, N, NA = 8, 32, 20  # solvers: 2-slice slabs at 4 ranks
FGP_ITERS, FGP_LAM, GD_NG, GD_DPOCS = 5, 0.2, 5, 0.07
FISTA_LAM, FISTA_NTV, ASD_NG = 0.1, 4, 4
TOMO_NS = 6  # not a multiple of 4: padded to 8, as TomoTPU pads it
ANGLES_DEG = np.linspace(-70, 70, NA)
KL_NS, KL_LAM = 5, 0.5  # 5 slices over 2 ranks: one pad slice
# the streaming reconstructor (2 ranks): 16 angles in a dose-symmetric order
STREAM_ANGLES = np.asarray([0.0] + [s * k * 7.5 for k in range(1, 9)
                                     for s in (1, -1)][:15])
SHARD_ARRAY = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 2, 3)
# the sharded fusion (tests/test_dist.py:101-178): 2 elements at N 24, Ns 16
# (Ns 6 for the uneven case), HAADF 10 and chemistry 5 angles
FU_N, FU_NS, FU_UNEVEN_NS = 24, 16, 6
FU_H_DEG, FU_C_DEG = np.linspace(-70, 70, 10), np.linspace(-60, 60, 5)
FU_ELEMENTS = ["c", "zn"]


def _sl(a):
    return np.ascontiguousarray(np.asarray(a).transpose(1, 2, 0))


def _public(a):
    return np.asarray(a).transpose(2, 0, 1)


def _sl4(a):
    """(Nel, Ns, A, B) -> slice-last (Nel, A, B, Ns)."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def _fusion_system():
    w = j_weights(FU_ELEMENTS, 1.6, 3)
    return j_make_fsys(FU_N, np.deg2rad(FU_H_DEG), np.deg2rad(FU_C_DEG), w,
                       1.6)


def _fusion_problem() -> dict:
    """tests/test_dist.py's fusion problems (uniform ground truths from
    default_rng(3), Ns 16, and default_rng(5), Ns 6), projected by tomojax;
    its system as arrays; the series as ChemicalTomo takes them."""
    jf = _fusion_system()
    out = {"fu_n": FU_N, "fu_h_deg": FU_H_DEG, "fu_c_deg": FU_C_DEG,
           "fu_h_rad": np.deg2rad(FU_H_DEG), "fu_c_rad": np.deg2rad(FU_C_DEG),
           "fu_w": np.asarray(jf.weights), "fu_l_aps": np.asarray(jf.l_aps),
           "fu_l_asig": np.asarray(jf.l_asig),
           "fu_sart_w": np.asarray(make_sart_weights(jf.haadf))}
    for tag, s in (("h", jf.haadf), ("c", jf.chem)):
        out.update({f"fu_{tag}_row": np.asarray(s.row_sum),
                    f"fu_{tag}_col": np.asarray(s.col_sum),
                    f"fu_{tag}_lip": np.asarray(s.lipschitz)})
    for suffix, seed, ns in (("", 3, FU_NS), ("_uneven", 5, FU_UNEVEN_NS)):
        rng = np.random.default_rng(seed)
        gt = rng.uniform(0, 1, (2, ns, FU_N, FU_N)).astype(np.float32)
        bc = np.asarray(j_fp4d(jnp.asarray(gt), jf.chem))
        bh = np.asarray(j_fp(j_model(jnp.asarray(gt), jf), jf.haadf.geom))
        out.update({"fu_gt" + suffix: gt,
                    "ct_haadf" + suffix: bh.transpose(0, 2, 1),
                    "ct_chem" + suffix: bc.transpose(0, 1, 3, 2)})
        if not suffix:
            out.update(fu_gt_sl=_sl4(gt), fu_bc_sl=_sl4(bc), fu_bh_sl=_sl(bh))
    return out


def _problem() -> dict:
    rng = np.random.default_rng(11)
    tv_x = rng.normal(size=TV_SHAPE).astype(np.float32) + 0.5
    jgeom = JGeometry.make(N, np.deg2rad(ANGLES_DEG))
    jsys = make_system(jgeom)
    ph = np.stack([shepp_logan(N) * (0.5 + i / NS) for i in range(NS)])
    b = np.asarray(j_fp(jnp.asarray(ph, jnp.float32), jgeom, mode="gather"))
    series = np.transpose(b[:TOMO_NS], (0, 2, 1))
    sgeom = JGeometry.make(N, np.deg2rad(STREAM_ANGLES))
    sb = np.asarray(j_fp(jnp.asarray(ph[:4], jnp.float32), sgeom,
                         mode="gather"))
    return {
        "stream_angles": STREAM_ANGLES, "stream_b3": sb[:3],
        "stream_b4": sb, "poll_angles": np.asarray([-12.5, 3.0, 30.0]),
        "poll_images": rng.random((3, 4, 5)).astype(np.float32),
        "shard_array": SHARD_ARRAY, "kl_lam": KL_LAM,
        "kl_series": np.ascontiguousarray(series[:KL_NS], np.float32),
        "tv_x": tv_x, "tv_x_sl": _sl(tv_x), "fgp_iters": FGP_ITERS,
        "fgp_lam": FGP_LAM, "gd_ng": GD_NG, "gd_dpocs": GD_DPOCS,
        "angles_rad": np.deg2rad(ANGLES_DEG),
        "row_sum": np.asarray(jsys.row_sum), "col_sum": np.asarray(jsys.col_sum),
        "lipschitz": np.asarray(jsys.lipschitz),
        "sart_w": np.asarray(make_sart_weights(jsys)), "b": b, "b_sl": _sl(b),
        "fista_lam": FISTA_LAM, "fista_ntv": FISTA_NTV, "asd_ng": ASD_NG,
        "tomo_angles_deg": ANGLES_DEG,
        "tomo_series": np.ascontiguousarray(series, np.float32),
        **_fusion_problem(),
    }


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    """Starts every group at once; ``ranks(k)`` joins group k (failing
    the test past JOIN_S from the start) and loads rank 0's results."""
    tmp = tmp_path_factory.mktemp("torch_dist")
    problem_file = tmp / "problem.npz"
    w1 = tmp / "shards_w1"  # a world of one rank saves, two ranks load
    tio.save_sharded(str(w1), {"a": torch.from_numpy(SHARD_ARRAY)})
    np.savez(problem_file, shard_w1_dir=str(w1), **problem)
    start = time.monotonic()
    ctxs = {k: mp.start_processes(
        rank_body.run,
        args=(k, str(tmp / f"store{k}"), str(problem_file),
              str(tmp / f"out{k}.npz")),
        nprocs=k, join=False, start_method="spawn") for k in WORLDS}
    results = {}

    def join(k):
        if k not in results:
            ctx = ctxs[k]
            while not ctx.join(timeout=max(0.0, start + JOIN_S
                                           - time.monotonic())):
                if time.monotonic() >= start + JOIN_S:
                    pytest.fail(f"{k} ranks did not finish within {JOIN_S} s")
            with np.load(tmp / f"out{k}.npz") as f:
                results[k] = dict(f)
        return results[k]

    yield join
    for ctx in ctxs.values():
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _jax_tv(problem, k):
    """tomojax's sharded TV stencils on make_mesh(k), f32 duals."""
    mesh = jdist.make_mesh(k)
    xs = jdist.shard_volume(jnp.asarray(problem["tv_x"]), mesh)
    d, tv0 = jax.jit(lambda v: tv_fgp_sharded(
        v, FGP_ITERS, FGP_LAM, mesh, dual_dtype=jnp.float32))(xs)
    g, _ = jax.jit(lambda v, dp: tv_gd_sharded(v, GD_NG, dp, mesh))(
        xs, jnp.float32(GD_DPOCS))
    with tjconfig.mesh_scope(mesh):
        m, tv_m = jax.jit(lambda v: jtv.tv_gd(
            v, GD_NG, GD_DPOCS, compat="reference-mpi"))(xs)
    return [np.asarray(a) for a in (d, tv0, g, m, tv_m)]


@pytest.mark.parametrize("k", WORLDS)
def test_halo_exchange_chain_ring_and_rank0_value(ranks, k):
    """Row r: chain (from left, from right), ring (from left, from right),
    ring leftward only, process_zero_value of a tensor and of an object,
    the ring again with every P2P tag equal (from left, from right). Rank
    r sends 10 r + 1 to the left and 10 r + 2 to the right."""
    got = ranks(k)["exchange"]
    r = np.arange(k)
    left, right = (r - 1) % k, (r + 1) % k
    want = np.stack([
        np.where(r > 0, 10 * left + 2, 0), np.where(r < k - 1, 10 * right + 1, 0),
        10 * left + 2, 10 * right + 1, 10 * right + 1,
        np.ones(k), np.ones(k), 10 * left + 2, 10 * right + 1], axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 4])
def test_tv_fgp_gd_with_group_match_jax_sharded(problem, ranks, k):
    d_j, tv_j, g_j, m_j, tvm_j = _jax_tv(problem, k)
    got = ranks(k)
    tv_ref = float(jtv.tv(jnp.asarray(problem["tv_x"])))
    # the TV value: rtol 1e-5 (summed in another order)
    np.testing.assert_allclose(float(got["tv"]), tv_ref, rtol=1e-5)
    np.testing.assert_allclose(float(got["fgp_tv"]), float(tv_j), rtol=1e-5)
    np.testing.assert_allclose(float(got["gd_tv"]), tv_ref, rtol=1e-5)
    # stencils: atol 1e-5 (the port sums its divergence in another axis
    # order; the descent divides by a norm summed in another order)
    np.testing.assert_allclose(_public(got["fgp_d"]), d_j, atol=1e-5)
    np.testing.assert_allclose(_public(got["gd_x"]), g_j, atol=1e-5)
    # bf16 duals: the same plain arithmetic as the unsharded prox, exactly
    d16, _ = tv_fgp(torch.from_numpy(problem["tv_x_sl"]), FGP_ITERS, FGP_LAM,
                    torch.bfloat16)
    np.testing.assert_array_equal(got["fgp_d_bf16"], d16.numpy())
    # compat='reference-mpi': atol 1e-5 / rtol 1e-5, as above
    np.testing.assert_allclose(_public(got["mpi_x"]), m_j, atol=1e-5)
    np.testing.assert_allclose(float(got["mpi_tv"]), float(tvm_j), rtol=1e-5)


def test_reference_mpi_depends_on_rank_count(ranks):
    """The reference's multi-rank TV-GD differs with the number of ranks
    (slab-local wrap and norm), and from the global default."""
    x2, x4 = ranks(2)["mpi_x"], ranks(4)["mpi_x"]
    assert not np.allclose(x2, x4, atol=1e-5)
    assert not np.allclose(x2, ranks(2)["gd_x"], atol=1e-5)
    # one rank: reference-mpi is the default
    np.testing.assert_allclose(ranks(1)["mpi_x"], ranks(1)["gd_x"], atol=1e-6)


def _jax_fista(problem, k):
    """3 FISTA iterations of tomojax.fista_step under make_mesh(k), the FGP
    through the sharded Pallas kernels with f32 duals."""
    mesh = jdist.make_mesh(k)
    sysd = make_system(JGeometry.make(N, problem["angles_rad"]))
    prev = (tjconfig.tv_impl, tjconfig.fgp_dual_dtype)
    try:
        tjconfig.set_tv_impl("pallas", dual_dtype=jnp.float32)
        with tjconfig.mesh_scope(mesh):
            b = jdist.shard_volume(jnp.asarray(problem["b"]), mesh)
            st = fista_init(jdist.shard_volume(jnp.zeros((NS, N, N)), mesh),
                            sysd)
            step = jax.jit(lambda s, bb: fista_step(s, bb, sysd, FISTA_LAM,
                                                    FISTA_NTV, True))
            metrics = []
            for _ in range(3):
                st, m = step(st, b)
                metrics.append([float(v) for v in m])
    finally:
        tjconfig.set_tv_impl(prev[0], dual_dtype=prev[1])
    return np.asarray(st.x), np.asarray(metrics)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_fista_matches_jax_under_mesh(problem, ranks, k):
    x_j, m_j = _jax_fista(problem, k)
    got = ranks(k)
    # tests/test_dist.py:268-271: x rtol 1e-4 / atol 1e-5, dd and tv
    # rtol 1e-4
    np.testing.assert_allclose(_public(got["fista_x"]), x_j, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["fista_m"][:, 1:], m_j[:, 1:], rtol=1e-4)


def _jax_asd(problem, k):
    """3 host-loop ASD-POCS iterations of tomojax under make_mesh(k), TV-GD
    through the sharded Pallas kernel (test_dist.py's host loop)."""
    mesh = jdist.make_mesh(k)
    sysd = make_system(JGeometry.make(N, problem["angles_rad"]))
    order = jnp.arange(NA, dtype=jnp.int32)
    prev = tjconfig.tv_impl
    try:
        tjconfig.set_tv_impl("pallas")
        with tjconfig.mesh_scope(mesh):
            run = make_asd_pocs_iteration(sysd, make_sart_weights(sysd),
                                          ng=ASD_NG)
            x = jdist.shard_volume(jnp.zeros((NS, N, N)), mesh)
            b = jdist.shard_volume(jnp.asarray(problem["b"]), mesh)
            beta, dpocs, dds = 0.25, 0.0, []
            for i in range(3):
                x, dp, dd, dg, _, dpocs_eff = run(x, b, beta, dpocs, order,
                                                  i == 0, 0.2)
                beta *= 0.9985
                dpocs = float(dpocs_eff)
                dds.append(float(dd))
                if float(dg) > 0.95 * float(dp) and float(dd) > 0.025:
                    dpocs *= 0.95
    finally:
        tjconfig.set_tv_impl(prev)
    return np.asarray(x), np.asarray(dds)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_asd_pocs_matches_jax_under_mesh(problem, ranks, k):
    x_j, dd_j = _jax_asd(problem, k)
    got = ranks(k)
    # tests/test_dist.py:324-326: x atol 2e-3, dd rtol 1e-3
    np.testing.assert_allclose(_public(got["asd_x"]), x_j, atol=2e-3)
    np.testing.assert_allclose(got["asd_dd"], dd_j, rtol=1e-3)


def test_tomotorch_padded_slabs_match_tomotpu(problem, ranks):
    """Nslice = 6 over 4 ranks: both packages pad to 8 slices, and the
    periodic TV wrap then meets a zero slice (the padding caveat)."""
    ts = problem["tomo_series"]
    ref = TomoTPU(ANGLES_DEG, ts, mesh=jdist.make_mesh(4))
    got = ranks(4)
    ref.fista(Niter=3, lambda_param=FISTA_LAM, nTViter=FISTA_NTV)
    assert got["tomo_fista_recon"].shape == (TOMO_NS, N, N)
    # test_torch_api.py's bounds: rtol 1e-3, atol 1e-4
    np.testing.assert_allclose(got["tomo_fista_recon"], ref.get_recon(),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["tomo_fista_cost"], ref.cost, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(got["tomo_tv"]), ref.tv(), rtol=1e-3)
    np.testing.assert_allclose(float(got["tomo_dd"]), ref.data_distance(),
                               rtol=1e-3)
    ref.asd_pocs(Niter=3, nTViter=ASD_NG)
    # test_torch_asd_pocs.py's bounds: dd rtol 1e-3, x atol 2e-3
    np.testing.assert_allclose(got["tomo_asd_dd"], ref.dd_vec, rtol=1e-3)
    np.testing.assert_allclose(got["tomo_asd_recon"], ref.get_recon(),
                               atol=2e-3)
    ref.sart(Niter=2)
    np.testing.assert_allclose(got["tomo_sart_cost"], ref.cost, rtol=1e-3)
    np.testing.assert_allclose(got["tomo_sart_recon"], ref.get_recon(),
                               rtol=2e-4, atol=2e-4)


def _host_sinogram(a, normalise: bool) -> np.ndarray:
    """The slice-last sinogram as numpy reordered it on the host, clamped
    to >= 0 and over its maximum first with `normalise`."""
    a = np.asarray(a, np.float32)
    if normalise:
        a = np.maximum(a, 0)
        a = a / max(a.max(), 1e-30)
    return np.ascontiguousarray(np.transpose(a, (2, 1, 0)))


@pytest.mark.parametrize("k", WORLDS)
def test_sinogram_slabs_equal_the_host_reorders_slabs(problem, ranks, k):
    """Each rank's slab of TomoTorch's b_sl and ChemicalTomo's b_haadf and
    b_chem, reordered and normalised on the rank's device from its slices
    alone (the maxima all-reduced), equals the slab `pad_slices` and
    `shard_global` cut from the whole sinogram reordered and normalised by
    numpy on the host, bit for bit; Ns 6 is padded to 8 at 4 ranks (the
    last rank's slab is padding only)."""
    from tomojax_torch.dist import SlabGroup, pad_slices, shard_global

    got = ranks(k)
    chem = problem["ct_chem_uneven"]
    whole = {
        "sino_b_sl": (_host_sinogram(problem["tomo_series"], False), 2),
        "sino_b_haadf": (_host_sinogram(problem["ct_haadf_uneven"], True),
                         2),
        "sino_b_chem": (np.stack([_host_sinogram(m, True) for m in chem]),
                        3)}
    for key, (host, axis) in whole.items():
        assert got[key].shape[axis] % k == 0
        n = got[key].shape[axis] // k
        for r in range(k):
            g = SlabGroup(rank=r, size=k, device=torch.device("cpu"))
            want = shard_global(pad_slices(torch.from_numpy(host), g,
                                           axis)[0], g, axis).numpy()
            slab = np.take(got[key], range(r * n, (r + 1) * n), axis=axis)
            np.testing.assert_array_equal(slab.view(np.uint32),
                                          want.view(np.uint32),
                                          err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("k", WORLDS)
def test_live_buffer_slabs_equal_the_host_layout(problem, ranks, k):
    """Each rank's slab of the live reconstructor's buffer, its tilts'
    slabs copied to the rank's device and reordered there, equals the slab
    `pad_slices` and `shard_global` cut from the projections stacked and
    transposed by numpy on the host, bit for bit, filled one tilt at a time
    and in one batch; Ns 6 is padded to 8 at 4 ranks."""
    from tomojax_torch.dist import SlabGroup, pad_slices, shard_global

    got = ranks(k)
    series = problem["tomo_series"]
    host = torch.from_numpy(np.ascontiguousarray(np.stack(
        [series[:, :, i] for i in range(series.shape[2])]).transpose(
            0, 2, 1)))
    want = []
    for r in range(k):
        g = SlabGroup(rank=r, size=k, device=torch.device("cpu"))
        want.append(shard_global(pad_slices(host, g, 2)[0], g, 2).numpy())
    want = np.concatenate(want, axis=2)
    for way in ("one", "batch"):
        np.testing.assert_array_equal(got[f"live_buf_{way}"].view(np.uint32),
                                      want.view(np.uint32), err_msg=way)


def test_world_size_one_group_matches_unsharded_tomotorch(problem, ranks,
                                                         monkeypatch):
    """A group of one rank runs the sharded path (K9 plain versions, ring
    halos as local copies, all-reduces of one) and gives the unsharded
    result. The ranks store FGP duals in f32, so does this reference."""
    monkeypatch.setattr(tomojax_torch.config, "fgp_dual_dtype",
                        torch.float32)
    ts = problem["tomo_series"]
    ref = TomoTorch(ANGLES_DEG, ts, device="cpu")
    got = ranks(1)
    ref.fista(Niter=3, lambda_param=FISTA_LAM, nTViter=FISTA_NTV)
    np.testing.assert_allclose(got["tomo_fista_recon"], ref.get_recon(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["tomo_fista_cost"], ref.cost, rtol=1e-6)
    np.testing.assert_allclose(float(got["tomo_tv"]), ref.tv(), rtol=1e-6)
    ref.asd_pocs(Niter=3, nTViter=ASD_NG)
    np.testing.assert_allclose(got["tomo_asd_dd"], ref.dd_vec, rtol=1e-5)
    np.testing.assert_allclose(got["tomo_asd_recon"], ref.get_recon(),
                               atol=1e-5)


def _stream_rounds(b, alg):
    """The rank body's schedule (`_stream`), unsharded on the CPU."""
    rec = DynamicReconstructor(N, len(STREAM_ANGLES), 8, alg=alg,
                               device="cpu")
    for lo, hi in ((0, 8), (8, len(STREAM_ANGLES))):
        rec.add_projections([(float(STREAM_ANGLES[i]), b[:, i])
                             for i in range(lo, hi)])
        (rec.iterate_cs if alg == "cs" else rec.iterate)(4)
    return rec


def test_stream_with_group_matches_unsharded(problem, ranks):
    """Two ranks against the unsharded port: masked SIRT at Ns 3 (one pad
    slice) and the CS rounds at Ns 4 within rtol 2e-4 (the bound of
    tests/test_stream.py for the sharded reconstructor); at Ns 3 the CS rounds
    keep the pad slice exactly 0 (the periodic TV wrap then meets it, so
    their values are not compared)."""
    got = ranks(2)
    sirt = _stream_rounds(problem["stream_b3"], "sirt")
    np.testing.assert_allclose(got["stream_sirt_dd"], sirt.dd_history,
                               rtol=2e-4)
    np.testing.assert_allclose(got["stream_sirt_x"], sirt.get_recon(),
                               rtol=2e-4, atol=2e-5)
    assert got["stream_sirt_x"].shape == (3, N, N)
    cs = _stream_rounds(problem["stream_b4"], "cs")
    np.testing.assert_allclose(got["stream_cs4_dd"], cs.dd_history,
                               rtol=2e-4)
    np.testing.assert_allclose(got["stream_cs4_x"], cs.get_recon(),
                               atol=2e-3)
    padded = got["stream_cs3_padded"]
    assert padded.shape == (4, N, N)
    assert np.all(padded[3] == 0.0) and np.any(padded[:3] != 0.0)
    assert np.all(np.isfinite(got["stream_cs3_dd"]))


def test_stream_sharded_checkpoint_resumes_in_place(ranks):
    got = ranks(2)
    np.testing.assert_array_equal(got["stream_resumed_x"],
                                  got["stream_sirt_x"])
    np.testing.assert_array_equal(got["stream_resumed_dd"],
                                  np.float32(got["stream_sirt_dd"]))
    assert int(got["stream_resume_raised"]) == 1  # without a group


def test_poll_multihost_gives_every_rank_rank_zeros_list(problem, ranks):
    got = ranks(2)
    for r in range(2):
        np.testing.assert_array_equal(got["poll_angles"][r],
                                      problem["poll_angles"])
        np.testing.assert_array_equal(got["poll_images"][r],
                                      problem["poll_images"])
    np.testing.assert_array_equal(got["poll_second"], [0, 0])


def test_save_load_sharded_across_world_sizes(ranks, tmp_path):
    got = ranks(2)
    for key in ("shard_same", "shard_whole", "shard_w1"):
        np.testing.assert_array_equal(got[key], SHARD_ARRAY, err_msg=key)
    np.testing.assert_array_equal(got["shard_len6"][:4], SHARD_ARRAY)
    assert got["shard_len6"].shape == (6, 2, 3)
    assert np.all(got["shard_len6"][4:] == 0.0)
    np.testing.assert_array_equal(got["shard_w1_cut"], SHARD_ARRAY[:2])
    assert int(got["shard_len3_raised"]) == 1
    # the 2-rank save, loaded here whole and as a world of one
    d = str(tmp_path / "one")
    tio.save_sharded(d, {"a": torch.from_numpy(SHARD_ARRAY), "b":
                         torch.ones(3, 2, dtype=torch.float64)})
    back = tio.load_sharded(d, length=5)
    assert back["b"].dtype == torch.float64 and back["b"].shape == (5, 2)
    assert torch.equal(back["b"][3:], torch.zeros(2, 2, dtype=torch.float64))
    np.testing.assert_array_equal(back["a"][:4], SHARD_ARRAY)


def test_kl_divergence_with_group(problem, ranks):
    """Nslice 5 over 2 ranks (one pad slice): the cost and the volume
    against the unsharded port and TomoTPU at test_torch_sirt.py's
    bounds (cost rtol 1e-4; the volume at rtol 1e-4 and 1e-4 of its
    maximum); the pad slice stays exactly 0."""
    got = ranks(2)
    series = problem["kl_series"]
    one = TomoTorch(ANGLES_DEG, series, device="cpu")
    one.kl_divergence(Niter=3, lambda_param=KL_LAM)
    ref = TomoTPU(ANGLES_DEG, series).kl_divergence(Niter=3,
                                                    lambda_param=KL_LAM)
    for want_cost, want_x in ((one.cost, one.get_recon()),
                              (ref.cost, ref.get_recon())):
        np.testing.assert_allclose(got["kl_cost"], want_cost, rtol=1e-4)
        np.testing.assert_allclose(got["kl_recon"], want_x, rtol=1e-4,
                                   atol=1e-4 * np.abs(want_x).max())
    assert got["kl_padded"].shape == (6, N, N)
    assert np.all(got["kl_padded"][5] == 0.0)


# ------------------------------------------------------ the sharded fusion

FU_X_KEYS = ("fu_sirt_x", "fu_sart_x", "fu_pml_x", "fu_fgp_d", "fu_gd_x",
             "fu_rescale")
FU_SCALAR_KEYS = ("fu_sirt_ch", "fu_sirt_cc", "fu_sart_ch", "fu_sart_cc",
                  "fu_pml_cost", "fu_ddc", "fu_tv", "fu_fgp_tv", "fu_gd_tv")


def _jax_chemical_tomo(problem, mesh) -> dict:
    """rank_body.chemical_tomo_runs in tomojax on `mesh`, volumes
    slice-last."""
    out = {}
    tomo = JChemicalTomo(problem["ct_haadf"], FU_H_DEG,
                         dict(zip(FU_ELEMENTS, problem["ct_chem"])),
                         FU_C_DEG, mesh=mesh)
    for way, kw in rank_body.CT_WAYS.items():
        tomo.chemical_tomography(**rank_body.CT_CHEM)
        out["ct_chem_cost"] = tomo.costCHEM
        tomo.data_fusion(**rank_body.CT_FUSION, **kw)
        out[f"ct_{way}_costs"] = np.stack([tomo.costHAADF, tomo.costCHEM,
                                           tomo.costTV])
        out[f"ct_{way}_recon"] = tomo.get_recon()
    out["ct_rmse"] = tomo.rmse_per_element(problem["fu_gt"])
    return out


@pytest.fixture(scope="module")
def jax_fusion(problem):
    """tomojax on make_mesh(8), as tests/test_dist.py runs it: the fusion
    steps jitted on stacks sharded on the slice axis (XLA stencils), the
    4D FGP and TV-GD through the sharded Pallas kernels in interpret mode
    (per element, f32 duals), ChemicalTomo(mesh=). Slice-last, as the
    ranks give theirs."""
    mesh = jdist.make_mesh(8)
    jf = _fusion_system()
    sh4 = NamedSharding(mesh, P(None, "z", None, None))
    gt = jax.device_put(jnp.asarray(problem["fu_gt"]), sh4)
    bc = jax.device_put(jnp.asarray(_public4(problem["fu_bc_sl"])), sh4)
    bh = jdist.shard_volume(jnp.asarray(_public(problem["fu_bh_sl"])), mesh)
    x0 = jnp.zeros_like(gt)
    w = jnp.asarray(problem["fu_sart_w"])
    out = {}
    for way, kw in (("sirt", {}), ("sart", {"method": "sart",
                                            "sart_weights": w})):
        x, ch, cc = jax.jit(lambda x, h, c, kw=kw: j_step(
            x, h, c, jf, *rank_body.FU_STEP, **kw))(x0, bh, bc)
        out.update({f"fu_{way}_x": _sl4(x), f"fu_{way}_ch": ch,
                    f"fu_{way}_cc": cc})
    x, out["fu_pml_cost"] = jax.jit(lambda x, c: j_pml(
        x, c, jf, rank_body.FU_PML_LAM))(x0, bc)
    out["fu_pml_x"] = _sl4(x)
    out["fu_rescale"] = _sl(jax.jit(lambda g, h: j_rescale(g, h, jf))(gt, bh))
    out["fu_ddc"] = jax.jit(lambda g, c: j_ddc(0.5 * g, c, jf))(gt, bc)
    out["fu_tv"] = jax.jit(jtv.tv_4d)(gt)
    prev = (tjconfig.tv_impl, tjconfig.fgp_dual_dtype)
    try:
        tjconfig.set_tv_impl("pallas", dual_dtype=jnp.float32)
        with tjconfig.mesh_scope(mesh):
            d, out["fu_fgp_tv"] = jax.jit(lambda v: jtv.tv_fgp_4d(
                v, *rank_body.FU_FGP))(gt)
            g, out["fu_gd_tv"] = jax.jit(lambda v: jtv.tv_gd_4d(
                v, *rank_body.FU_GD))(gt)
    finally:
        tjconfig.set_tv_impl(prev[0], dual_dtype=prev[1])
    out.update(fu_fgp_d=_sl4(d), fu_gd_x=_sl4(g))
    out = {k: np.asarray(v) for k, v in out.items()}
    out.update(_jax_chemical_tomo(problem, mesh))
    return out


def _public4(a):
    """Slice-last (Nel, A, B, Ns) -> (Nel, Ns, A, B)."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _padded(problem, ns: int) -> dict:
    """The uneven problem's series and ground truth with zero slices up to
    `ns`, as the ranks pad them, under the uneven keys."""
    pad = ns - FU_UNEVEN_NS
    p = dict(problem)
    for key, axis in (("ct_haadf_uneven", 0), ("ct_chem_uneven", 1),
                      ("fu_gt_uneven", 1)):
        width = [(0, 0)] * problem[key].ndim
        width[axis] = (0, pad)
        p[key] = np.pad(problem[key], width)
    return p


@pytest.fixture(scope="module")
def port_fusion(problem):
    """The same calls in the unsharded port (plain versions, f32 duals,
    as the ranks run them); the uneven problem on the volume zero-padded to
    8 slices, as 4 ranks pad it."""
    saved = tomojax_torch.config.fgp_dual_dtype
    tomojax_torch.config.fgp_dual_dtype = torch.float32
    try:
        out = {k: np.asarray(v)
               for k, v in rank_body.fusion_steps(problem).items()}
        out.update(rank_body.chemical_tomo_runs(problem, device="cpu"))
        out.update(rank_body.chemical_tomo_runs(_padded(problem, 8),
                                                "_uneven", device="cpu"))
    finally:
        tomojax_torch.config.fgp_dual_dtype = saved
    return out


@pytest.mark.parametrize("k", WORLDS)
def test_sharded_fusion_steps_and_4d_tv_match_jax_and_unsharded(
        ranks, jax_fusion, port_fusion, k):
    """data_fusion_step (SIRT and SART) and poisson_ml_step_4d from zero,
    rescale_projections, data_distance_chem and the 4D tv, tv_fgp and
    tv_gd on the ground truth, with the group, against tomojax on
    make_mesh(8) and the unsharded port, at test_dist.py:136-137's bounds:
    stacks atol 1e-5, scalars rtol 1e-4. Measured at 1, 2 and 4 ranks:
    against tomojax stacks within 1.9e-6 (the rescaled sinogram; the
    volumes 4.8e-7), scalars within 3.3e-7; against the unsharded port
    stacks within 6.0e-8, scalars within 8.1e-8."""
    got = ranks(k)
    for ref in (jax_fusion, port_fusion):
        for key in FU_X_KEYS:
            np.testing.assert_allclose(got[key], ref[key], atol=1e-5,
                                       err_msg=key)
        for key in FU_SCALAR_KEYS:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                       err_msg=key)


@pytest.mark.parametrize("k", WORLDS)
def test_chemical_tomo_with_group_matches_jax_and_unsharded(
        ranks, jax_fusion, port_fusion, k):
    """ChemicalTomo(group=): chemical_tomography(5), then data_fusion(3) as
    the host loop, fused=True and method='sart', each from a fresh
    chemical_tomography. Against the unsharded port: volumes atol 1e-5,
    costs rtol 1e-4 (measured: volumes 0.0, costs 4.9e-7); against
    tomojax's ChemicalTomo(mesh=make_mesh(8)) the same bounds (measured:
    volumes 5.1e-7, costs 2.4e-6). The lambda_chem decay takes the same
    branches: no two consecutive HAADF costs lie within 1e-3 of each other
    (the smallest gap measured 0.128)."""
    got = ranks(k)
    for ref in (port_fusion, jax_fusion):
        np.testing.assert_allclose(got["ct_chem_cost"], ref["ct_chem_cost"],
                                   rtol=1e-4)
        for way in rank_body.CT_WAYS:
            np.testing.assert_allclose(got[f"ct_{way}_costs"],
                                       ref[f"ct_{way}_costs"], rtol=1e-4,
                                       err_msg=way)
            np.testing.assert_allclose(got[f"ct_{way}_recon"],
                                       ref[f"ct_{way}_recon"], atol=1e-5,
                                       err_msg=way)
        np.testing.assert_allclose(got["ct_rmse"], ref["ct_rmse"], rtol=1e-4)
    for way in rank_body.CT_WAYS:
        ch = got[f"ct_{way}_costs"][0]
        assert np.min(np.abs(np.diff(ch)) / ch[1:]) > 1e-3, way
    assert got["ct_host_recon"].shape == (2, FU_NS, FU_N, FU_N)


def test_chemical_tomo_with_group_uneven(ranks, port_fusion):
    """Ns 6 over 4 ranks (tests/test_dist.py:148-178): the slice axis is
    padded to 8, get_recon drops the padding, and the run equals the
    unsharded port's on the same zero-padded volume (volumes atol 1e-5,
    costs rtol 1e-4; measured 1.2e-7 and 1.1e-7)."""
    got = ranks(4)
    for way in rank_body.CT_WAYS:
        rec = got[f"ct_{way}_recon_uneven"]
        assert rec.shape == (2, FU_UNEVEN_NS, FU_N, FU_N)
        assert np.isfinite(rec).all()
        np.testing.assert_allclose(
            rec, port_fusion[f"ct_{way}_recon_uneven"][:, :FU_UNEVEN_NS],
            atol=1e-5, err_msg=way)
        np.testing.assert_allclose(got[f"ct_{way}_costs_uneven"],
                                   port_fusion[f"ct_{way}_costs_uneven"],
                                   rtol=1e-4, err_msg=way)
    assert got["ct_rmse_uneven"].shape == (2,)
