"""Rank body of tests/test_torch_dist.py; it holds no tests of its own.

Each spawned rank joins a gloo group through a file store, runs the port's
slab-sharded functions on its slab of the problem the parent saved, and
rank 0 saves what the ranks gather. It imports torch and tomojax_torch
only: the parent computes the JAX side, so no rank imports jax.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

# the sharded fusion cases (tests/test_dist.py's problem): ChemicalTomo's
# calls, shared with the parent, which runs them unsharded and in tomojax
CT_CHEM = {"Niter": 5, "lambdaCHEM": 0.2}
CT_FUSION = {"Niter": 3, "lambdaHAADF": 0.5, "iterSIRT": 2, "tvIter": 3,
             "lambdaTV": 1e-3}
CT_WAYS = {"host": {}, "fused": {"fused": True}, "sart": {"method": "sart"}}
FU_STEP = (0.5, 0.05, 2)  # lam_haadf, lam_chem, iter_sirt
FU_PML_LAM = 0.2
FU_FGP, FU_GD = (3, 0.1), (4, 0.05)  # (iterations, lam), (ng, dpocs)


def run(rank: int, world: int, init_file: str, problem_file: str,
        out_file: str) -> None:
    torch.set_num_threads(1)
    from tomojax_torch.dist import init_distributed

    group = init_distributed(f"file://{init_file}", world, rank,
                             device="cpu")
    try:
        with np.load(problem_file) as problem:
            out = _compute(group, dict(problem),
                           os.path.join(os.path.dirname(out_file),
                                        f"work{world}"))
        if rank == 0:
            np.savez(out_file, **out)
    finally:
        dist.destroy_process_group()


def _gather(x: torch.Tensor, group, axis: int = 2) -> np.ndarray:
    from tomojax_torch.dist import gather_slabs

    return gather_slabs(x, group, axis).numpy()


def _exchange(group) -> dict:
    """What every rank received from halo_exchange (chain and ring) and
    process_zero_value, gathered: one row per rank. The ring is swapped a
    second time with every P2P tag equal, so that only the order in which
    the operations are posted pairs them (as over NCCL, which ignores
    tags)."""
    from tomojax_torch import dist as tdist
    from tomojax_torch.dist import halo_exchange, process_zero_value

    r = group.rank
    lo = torch.full((2, 3), 10.0 * r + 1, dtype=torch.bfloat16)
    hi = torch.full((2, 3), 10.0 * r + 2, dtype=torch.bfloat16)
    got = []
    for ring in (False, True):
        left, right = halo_exchange(lo, hi, group, ring)
        got += [float(left[0, 0]), float(right[0, 0])]
    _, right_only = halo_exchange(lo, None, group, ring=True)
    got.append(float(right_only[0, 0]))
    got.append(float(process_zero_value(torch.tensor(r + 1.0), group)))
    got.append(float(process_zero_value({"rank": r + 1}, group)["rank"]))
    tags = tdist._RIGHTWARD, tdist._LEFTWARD
    tdist._RIGHTWARD = tdist._LEFTWARD = 0
    try:
        left, right = halo_exchange(lo, hi, group, ring=True)
    finally:
        tdist._RIGHTWARD, tdist._LEFTWARD = tags
    got += [float(left[0, 0]), float(right[0, 0])]
    row = torch.tensor(got, dtype=torch.float32)[None]
    return {"exchange": _gather(row, group, axis=0)}


def _tv(group, p: dict) -> dict:
    from tomojax_torch.convert import slab_from_numpy
    from tomojax_torch.tv import tv, tv_fgp, tv_gd

    x = slab_from_numpy(p["tv_x_sl"], group, 2)
    lam, it = float(p["fgp_lam"]), int(p["fgp_iters"])
    ng, dpocs = int(p["gd_ng"]), float(p["gd_dpocs"])
    out = {"tv": tv(x, group).numpy()}
    d, out["fgp_tv"] = tv_fgp(x, it, lam, torch.float32, group)
    out["fgp_d"] = _gather(d, group)
    d16, _ = tv_fgp(x, it, lam, torch.bfloat16, group)
    out["fgp_d_bf16"] = _gather(d16, group)
    xg, out["gd_tv"] = tv_gd(x, ng, dpocs, group)
    out["gd_x"] = _gather(xg, group)
    xm, out["mpi_tv"] = tv_gd(x, ng, dpocs, group, compat="reference-mpi")
    out["mpi_x"] = _gather(xm, group)
    return {k: np.asarray(v) for k, v in out.items()}


def _solvers(group, p: dict) -> dict:
    from tomojax_torch.convert import (
        sart_weights_from_numpy, slab_from_numpy, system_from_numpy,
    )
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.solvers import (
        AsdPocsParams, asd_pocs_host_loop, fista_init_sl, fista_run_sl,
    )

    n = p["row_sum"].shape[-1]
    geom = Geometry.make(n, p["angles_rad"])
    sysd = system_from_numpy(geom, p["row_sum"], p["col_sum"],
                             p["lipschitz"], "cpu")
    b = slab_from_numpy(p["b_sl"], group, 2)
    x0 = torch.zeros((b.shape[2], n, n))
    st = fista_init_sl(x0, sysd, b)
    st, m = fista_run_sl(st, b, sysd, float(p["fista_lam"]), 3,
                         int(p["fista_ntv"]), group=group)
    out = {"fista_x": _gather(st.x, group), "fista_m": m.numpy()}
    params = AsdPocsParams(niter=3, ng=int(p["asd_ng"]))
    w = sart_weights_from_numpy(p["sart_w"], "cpu")
    x, dd, _, _ = asd_pocs_host_loop(torch.zeros((n, n, b.shape[2])), b,
                                     sysd, w, params, group=group)
    out.update(asd_x=_gather(x, group), asd_dd=dd)
    return out


def _tomo(group, p: dict) -> dict:
    from tomojax_torch import TomoTorch

    tomo = TomoTorch(p["tomo_angles_deg"], p["tomo_series"], group=group)
    tomo.fista(Niter=3, lambda_param=float(p["fista_lam"]),
               nTViter=int(p["fista_ntv"]))
    out = {"tomo_fista_recon": tomo.get_recon(),
           "tomo_fista_cost": tomo.cost,
           "tomo_tv": np.float32(tomo.tv()),
           "tomo_dd": np.float32(tomo.data_distance())}
    tomo.asd_pocs(Niter=3, nTViter=int(p["asd_ng"]))
    out.update(tomo_asd_recon=tomo.get_recon(), tomo_asd_dd=tomo.dd_vec)
    tomo.sart(Niter=2)
    out.update(tomo_sart_recon=tomo.get_recon(), tomo_sart_cost=tomo.cost)
    return out


def _sinograms(group, p: dict) -> dict:
    """The sinogram slabs TomoTorch and ChemicalTomo build on each rank
    before any solver runs, from the Ns 6 series (padded to 8 at 4 ranks),
    gathered in rank order."""
    from tomojax_torch import ChemicalTomo, TomoTorch

    tomo = TomoTorch(p["tomo_angles_deg"], p["tomo_series"], group=group)
    chem = p["ct_chem_uneven"]
    ct = ChemicalTomo(p["ct_haadf_uneven"], p["fu_h_deg"],
                      {"c": chem[0], "zn": chem[1]}, p["fu_c_deg"],
                      group=group)
    return {"sino_b_sl": _gather(tomo.b_sl, group, 2),
            "sino_b_haadf": _gather(ct.b_haadf, group, 2),
            "sino_b_chem": _gather(ct.b_chem, group, 3)}


def _live_buffer(group, p: dict) -> dict:
    """The live reconstructor's measurement buffer filled from the Ns 6
    series (padded to 8 at 4 ranks) one tilt at a time and in one batch:
    each rank's slab, gathered in rank order."""
    from tomojax_torch.stream import DynamicReconstructor

    series, ang = p["tomo_series"], p["tomo_angles_deg"]
    out = {}
    for way, step in (("one", 1), ("batch", len(ang))):
        rec = DynamicReconstructor(series.shape[1], len(ang), group=group)
        for lo in range(0, len(ang), step):
            rec.add_projections([(float(ang[i]), series[:, :, i])
                                 for i in range(lo, lo + step)])
            rec._fill()
        out[f"live_buf_{way}"] = _gather(rec._buf[:len(ang)], group, 2)
    return out


def _stream(group, p: dict, work: str) -> dict:
    """The streaming reconstructor with a group: SIRT rounds at Ns 3 (padded to
    4) with a sharded checkpoint after each, resumed with and without the
    group; CS rounds at Ns 4 and 3 (the padded slab gathered whole)."""
    from tomojax_torch.dist import gather_slabs
    from tomojax_torch.stream import DynamicReconstructor

    ang, n = p["stream_angles"], p["stream_b3"].shape[2]

    def rounds(b, alg, ckpt=None):
        rec = DynamicReconstructor(n, len(ang), 8, alg=alg, group=group,
                                   checkpoint_path=ckpt)
        for lo, hi in ((0, 8), (8, len(ang))):
            rec.add_projections([(float(ang[i]), b[:, i])
                                 for i in range(lo, hi)])
            (rec.iterate_cs if alg == "cs" else rec.iterate)(4)
            rec.checkpoint()
        return rec

    ckpt = os.path.join(work, "sirt.h5")
    sirt = rounds(p["stream_b3"], "sirt", ckpt)
    out = {"stream_sirt_dd": sirt.dd_history,
           "stream_sirt_x": sirt.get_recon()}
    back = DynamicReconstructor(n, len(ang), group=group,
                                checkpoint_path=ckpt)
    back.resume()
    out.update(stream_resumed_x=back.get_recon(),
               stream_resumed_dd=back.dd_history)
    try:
        DynamicReconstructor(n, len(ang), device="cpu",
                             checkpoint_path=ckpt).resume()
        out["stream_resume_raised"] = 0
    except ValueError:
        out["stream_resume_raised"] = 1
    cs4 = rounds(p["stream_b4"], "cs")
    out.update(stream_cs4_dd=cs4.dd_history, stream_cs4_x=cs4.get_recon())
    cs3 = rounds(p["stream_b3"], "cs")
    out.update(stream_cs3_dd=cs3.dd_history,
               stream_cs3_padded=gather_slabs(cs3.x, group, 0).numpy())
    return out


def _poll(group, p: dict, work: str) -> dict:
    """poll_multihost twice: rank 0 watches a directory of three files
    (the other ranks an empty one); every rank's lists gathered."""
    from tomojax_torch.stream import TiltWatcher, poll_multihost

    src = os.path.join(work, f"poll{group.rank}")
    os.makedirs(src, exist_ok=True)
    if group.rank == 0:
        for a, img in zip(p["poll_angles"], p["poll_images"]):
            np.save(os.path.join(src, f"proj_{a}.npy"), img)
    watcher = TiltWatcher(src, preprocess=False)
    first, second = (poll_multihost(watcher, group) for _ in range(2))
    angles = torch.tensor([[a for a, _ in first]], dtype=torch.float64)
    images = torch.from_numpy(np.stack([im for _, im in first]))[None]
    return {"poll_angles": _gather(angles, group, 0),
            "poll_images": _gather(images, group, 0),
            "poll_second": _gather(torch.tensor([len(second)]), group, 0)}


def _sharded_io(group, p: dict, work: str) -> dict:
    """save_sharded of one slab a rank, loaded by this group, without one
    and with another length; the parent's world-of-one save loaded in
    slabs, whole and cut."""
    from tomojax_torch import io as tio
    from tomojax_torch.dist import shard_global

    whole = torch.from_numpy(p["shard_array"])
    d = os.path.join(work, "shards")
    tio.save_sharded(d, {"a": shard_global(whole, group)}, group)
    out = {"shard_same": _gather(tio.load_sharded(d, group)["a"], group, 0),
           "shard_whole": tio.load_sharded(d)["a"].numpy(),
           "shard_len6": _gather(tio.load_sharded(d, group, 6)["a"], group,
                                 0)}
    w1 = str(p["shard_w1_dir"])
    out["shard_w1"] = _gather(tio.load_sharded(w1, group)["a"], group, 0)
    out["shard_w1_cut"] = _gather(tio.load_sharded(w1, group, 2)["a"],
                                  group, 0)
    try:
        tio.load_sharded(w1, group, 3)
        out["shard_len3_raised"] = 0
    except ValueError:
        out["shard_len3_raised"] = 1
    return out


def _kl(group, p: dict) -> dict:
    from tomojax_torch import TomoTorch
    from tomojax_torch.dist import gather_slabs

    tomo = TomoTorch(p["tomo_angles_deg"], p["kl_series"], group=group)
    tomo.kl_divergence(Niter=3, lambda_param=float(p["kl_lam"]))
    return {"kl_cost": tomo.cost, "kl_recon": tomo.get_recon(),
            "kl_padded": gather_slabs(tomo.x, group, 0).numpy()}


def fusion_system(p: dict, device="cpu"):
    """The reference's fusion system of the problem, carried across."""
    from tomojax_torch.convert import fusion_system_from_numpy
    from tomojax_torch.geometry import Geometry

    n = int(p["fu_n"])
    return fusion_system_from_numpy(
        (Geometry.make(n, p["fu_h_rad"]), p["fu_h_row"], p["fu_h_col"],
         p["fu_h_lip"]),
        (Geometry.make(n, p["fu_c_rad"]), p["fu_c_row"], p["fu_c_col"],
         p["fu_c_lip"]),
        p["fu_w"], 1.6, p["fu_l_aps"], p["fu_l_asig"], device)


def fusion_steps(p: dict, group=None, cut=None) -> dict:
    """The fusion functions and the 4D TV on the problem's slice-last
    stacks: from zero the fused step (SIRT and SART) and the Poisson-ML
    step; on the ground truth the rescale and the 4D TV value, FGP and
    TV-GD; the chemistry distance of half the ground truth. `cut(a,
    axis)` gives this rank's slab of a whole array (None: the whole array
    as a tensor); the results are the rank's slabs and the all-reduced
    scalars."""
    from tomojax_torch.convert import sart_weights_from_numpy
    from tomojax_torch.fusion import (
        data_distance_chem, data_fusion_step, poisson_ml_step_4d,
        rescale_projections,
    )
    from tomojax_torch.tv import tv_4d, tv_fgp_4d, tv_gd_4d

    cut = cut or (lambda a, axis: torch.from_numpy(np.array(a, np.float32)))
    fsys = fusion_system(p)
    gt, bh, bc = (cut(p["fu_gt_sl"], 3), cut(p["fu_bh_sl"], 2),
                  cut(p["fu_bc_sl"], 3))
    x0 = torch.zeros_like(gt)
    w = sart_weights_from_numpy(p["fu_sart_w"], "cpu")
    out = {}
    for way, kw in (("sirt", {}), ("sart", {"method": "sart",
                                            "sart_weights": w})):
        x, ch, cc = data_fusion_step(x0, bh, bc, fsys, *FU_STEP, group=group,
                                     **kw)
        out.update({f"fu_{way}_x": x, f"fu_{way}_ch": ch,
                    f"fu_{way}_cc": cc})
    out["fu_pml_x"], out["fu_pml_cost"] = poisson_ml_step_4d(
        x0, bc, fsys, FU_PML_LAM, group)
    out["fu_rescale"] = rescale_projections(gt, bh, fsys, group)
    out["fu_ddc"] = data_distance_chem(0.5 * gt, bc, fsys, group)
    out["fu_tv"] = tv_4d(gt, group)
    out["fu_fgp_d"], out["fu_fgp_tv"] = tv_fgp_4d(gt, *FU_FGP, group=group)
    out["fu_gd_x"], out["fu_gd_tv"] = tv_gd_4d(gt, *FU_GD, group=group)
    return out


def chemical_tomo_runs(p: dict, suffix: str = "", group=None,
                       device=None) -> dict:
    """ChemicalTomo on the problem's series (suffix "_uneven": the Ns 6
    problem): chemical_tomography, then data_fusion each way of CT_WAYS
    from a fresh chemical_tomography; the costs and get_recon of each."""
    from tomojax_torch import ChemicalTomo

    haadf, chem = p["ct_haadf" + suffix], p["ct_chem" + suffix]
    tomo = ChemicalTomo(haadf, p["fu_h_deg"], {"c": chem[0], "zn": chem[1]},
                        p["fu_c_deg"], device=device, group=group)
    out = {}
    for way, kw in CT_WAYS.items():
        tomo.chemical_tomography(**CT_CHEM)
        out["ct_chem_cost" + suffix] = tomo.costCHEM
        tomo.data_fusion(**CT_FUSION, **kw)
        out[f"ct_{way}_costs{suffix}"] = np.stack(
            [tomo.costHAADF, tomo.costCHEM, tomo.costTV])
        out[f"ct_{way}_recon{suffix}"] = tomo.get_recon()
    out["ct_rmse" + suffix] = tomo.rmse_per_element(p["fu_gt" + suffix])
    return out


def _fusion(group, p: dict) -> dict:
    from tomojax_torch.convert import slab_from_numpy

    out = fusion_steps(p, group, lambda a, axis: slab_from_numpy(a, group,
                                                                 axis))
    for key in ("fu_sirt_x", "fu_sart_x", "fu_pml_x", "fu_fgp_d", "fu_gd_x"):
        out[key] = _gather(out[key], group, 3)
    out["fu_rescale"] = _gather(out["fu_rescale"], group, 2)
    out = {k: np.asarray(v) for k, v in out.items()}
    out.update(chemical_tomo_runs(p, group=group))
    if group.size == 4:  # Ns 6 over 4 ranks: two pad slices
        out.update(chemical_tomo_runs(p, "_uneven", group))
    return out


def _compute(group, p: dict, work: str) -> dict:
    from tomojax_torch import config

    config.fgp_dual_dtype = torch.float32  # the solvers' FGP, as the parent
    out = _exchange(group)
    out.update(_tv(group, p))
    out.update(_solvers(group, p))
    out.update(_tomo(group, p))
    out.update(_sinograms(group, p))
    out.update(_live_buffer(group, p))
    out.update(_fusion(group, p))
    if group.size == 2:  # the streaming cases run in the 2-rank spawn only
        os.makedirs(work, exist_ok=True)
        out.update(_stream(group, p, work))
        out.update(_poll(group, p, work))
        out.update(_sharded_io(group, p, work))
        out.update(_kl(group, p))
    return out
