"""ASD-POCS (adaptive steepest descent, projection onto convex sets),
slice-last (counterpart of ``tomojax/solvers/asd_pocs.py``).

One iteration, as the reference's working driver loop does it:

    x0 = x;  x = SART(x, beta, order);  dp = ||x - x0||     (K8)
    dpocs = alpha * dp on the first iteration
    dd = ||A x - b||                                       (K1's ddsq)
    x1 = x;  x, tv0 = TV-GD(x, ng, dpocs);  dg = ||x - x1||  (K5, K7)
    beta *= beta_red;  if dg > r_max dp and dd > eps: dpocs *= alpha_red

`asd_pocs_iteration` is one iteration (``make_asd_pocs_iteration``);
`asd_pocs_host_loop` adapts beta and dpocs on the host after reading dp,
dd and dg back, as the reference's driver and ``TomoTPU.asd_pocs`` do;
`asd_pocs_run` carries them as 0-dim device tensors
(``make_asd_pocs_run``), so a whole run queues without a host read.
Volumes are (N, N, Ns), sinograms (Na, Nt, Ns).

With ``group=`` (a `tomojax_torch.dist.SlabGroup`) they are this rank's
z-slabs, (N, N, n_loc) and (Na, Nt, n_loc): the SART sweep runs on the
slab as it is (``sart_sweep_pallas_sharded``), TV-GD runs K9c on the
periodic ring, and dp^2, dd^2 and dg^2 are all-reduced before the square
root. Every rank reads the same scalars, so in the host loop every rank
makes the same beta and dpocs decisions and issues the same collectives.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tomojax_torch import profiling
from tomojax_torch.dist import SlabGroup, all_reduce_sum
from tomojax_torch.host import read_scalars
from tomojax_torch.projector.cuda_joseph import fp_resid_sl
from tomojax_torch.solvers.base import System
from tomojax_torch.solvers.cuda_sart import sart_sweep_sl
from tomojax_torch.tv import tv_gd

F32 = torch.float32


class AsdPocsParams(NamedTuple):
    """Default recipe = the reference's defaults."""

    niter: int = 100
    eps: float = 0.025
    beta0: float = 0.25
    beta_red: float = 0.9985
    r_max: float = 0.95
    ng: int = 10
    alpha: float = 0.2
    alpha_red: float = 0.95


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=F32, device=device)


def _sqrt_sum(sq: torch.Tensor, group: SlabGroup | None) -> torch.Tensor:
    """sqrt of a sum of squares, all-reduced first with a group."""
    if group is not None:
        all_reduce_sum(sq, group)
    return torch.sqrt(sq)


def _norm(d: torch.Tensor, group: SlabGroup | None) -> torch.Tensor:
    return _sqrt_sum(torch.sum(d * d), group)


def data_distance_sl(x: torch.Tensor, b_sl: torch.Tensor, sys: System,
                     group: SlabGroup | None = None) -> torch.Tensor:
    """``||A x - b||`` as a 0-dim device tensor: K1 with beta = 0 against a
    zero ax_old, whose ddsq is a fixed-order sum on the device (with a
    group, all-reduced over the slabs)."""
    zero = torch.zeros((), dtype=F32, device=x.device)
    _, _, ddsq = fp_resid_sl(x, sys.geom, b_sl, torch.zeros_like(b_sl),
                             sys.inv_row, zero)
    return _sqrt_sum(ddsq, group)


def asd_pocs_iteration(x: torch.Tensor, b_sl: torch.Tensor, sys: System,
                       inv_col_a: torch.Tensor, beta, dpocs,
                       order: torch.Tensor, ng: int, first: bool = False,
                       alpha: float = 0.2, group: SlabGroup | None = None):
    """One iteration from x (N, N, Ns), or this rank's slab with a group.
    beta and dpocs are floats or 0-dim tensors, order an int32 (Na,)
    tensor on x's device. Returns (x, dp, dd, dg, tv0, dpocs), the scalars
    as 0-dim device tensors; dpocs is the value the TV step used."""
    dev = x.device
    x0 = x
    x = sart_sweep_sl(x, b_sl, sys.geom, sys.inv_row, inv_col_a,
                      _scalar(beta, dev), order)
    dp = _norm(x - x0, group)
    dpocs = alpha * dp if first else _scalar(dpocs, dev)
    dd = data_distance_sl(x, b_sl, sys, group)
    x1 = x
    x, tv0 = tv_gd(x, ng, dpocs, group)
    dg = _norm(x - x1, group)
    return x, dp, dd, dg, tv0, dpocs


def _sequential(orders, sys: System, niter: int, device) -> torch.Tensor:
    if orders is not None:
        return orders
    seq = torch.arange(sys.geom.nproj, dtype=torch.int32, device=device)
    return seq.expand(niter, -1)


def asd_pocs_host_loop(x: torch.Tensor, b_sl: torch.Tensor, sys: System,
                       inv_col_a: torch.Tensor, params: AsdPocsParams,
                       orders: torch.Tensor | None = None,
                       group: SlabGroup | None = None):
    """`params.niter` iterations, adapting beta and dpocs in Python after
    reading dp, dd and dg back from every iteration (the reference's
    driver loop): the five scalars in one host read an iteration.

    orders: as for `asd_pocs_run`. Returns (x, dd_vec, tv_vec, dpocs_vec),
    the vectors (niter,) float32 numpy arrays; dpocs_vec holds the value
    each iteration's TV step used."""
    p = params
    orders = _sequential(orders, sys, p.niter, x.device)
    beta, dpocs = p.beta0, 0.0
    out = np.zeros((3, p.niter), np.float32)
    for it in range(p.niter):
        with profiling.annotate("solvers.iteration"):
            x, dp, dd, dg, tv0, dpocs_used = asd_pocs_iteration(
                x, b_sl, sys, inv_col_a, beta, dpocs,
                orders[it].contiguous(), p.ng, it == 0, p.alpha, group)
            beta *= p.beta_red
            dp, dd, dg, dpocs, tv0 = read_scalars(dp, dd, dg, dpocs_used, tv0)
            out[:, it] = dd, tv0, dpocs
            if dg > p.r_max * dp and dd > p.eps:
                dpocs *= p.alpha_red
    return x, out[0], out[1], out[2]


def asd_pocs_run(x: torch.Tensor, b_sl: torch.Tensor, sys: System,
                 inv_col_a: torch.Tensor, params: AsdPocsParams,
                 orders: torch.Tensor | None = None,
                 group: SlabGroup | None = None):
    """`params.niter` iterations with beta and dpocs carried on the device.

    orders: None (sequential) or an int32 (niter, Na) tensor of visiting
    orders, one row per iteration. Returns (x, dd_vec, tv_vec), the
    vectors (niter,) device tensors."""
    p = params
    dev = x.device
    orders = _sequential(orders, sys, p.niter, dev)
    beta = _scalar(p.beta0, dev)
    dpocs = _scalar(0.0, dev)
    dds, tvs = [], []
    for it in range(p.niter):
        x, dp, dd, dg, tv0, dpocs = asd_pocs_iteration(
            x, b_sl, sys, inv_col_a, beta, dpocs, orders[it].contiguous(),
            p.ng, it == 0, p.alpha, group)
        beta = beta * p.beta_red
        dpocs = torch.where((dg > p.r_max * dp) & (dd > p.eps),
                            dpocs * p.alpha_red, dpocs)
        dds.append(dd)
        tvs.append(tv0)
    if not dds:
        empty = torch.zeros(0, dtype=F32, device=dev)
        return x, empty, empty
    return x, torch.stack(dds), torch.stack(tvs)
