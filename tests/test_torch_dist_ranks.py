"""Rank body of tests/test_torch_dist.py; it holds no tests of its own.

Each spawned rank joins a gloo group through a file store, runs the port's
slab-sharded functions on its slab of the problem the parent saved, and
rank 0 saves what the ranks gather. It imports torch and tomojax_torch
only: the parent computes the JAX side, so no rank imports jax.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def run(rank: int, world: int, init_file: str, problem_file: str,
        out_file: str) -> None:
    torch.set_num_threads(1)
    from tomojax_torch.dist import init_distributed

    group = init_distributed(f"file://{init_file}", world, rank,
                             device="cpu")
    try:
        with np.load(problem_file) as problem:
            out = _compute(group, dict(problem))
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


def _compute(group, p: dict) -> dict:
    from tomojax_torch import config

    config.fgp_dual_dtype = torch.float32  # the solvers' FGP, as the parent
    out = _exchange(group)
    out.update(_tv(group, p))
    out.update(_solvers(group, p))
    out.update(_tomo(group, p))
    return out
