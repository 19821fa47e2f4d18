"""FISTA-TV with Nesterov momentum, slice-last (counterpart of the
slice-last driver in ``tomojax/solvers/fista.py``).

One iteration on the state (x, x_old, yk, t, ax, resid):

1. K2: z = max(yk + C A^T resid, 0), the SIRT gradient step on the
   momentum variable, with the carried resid = (b - A yk) R;
2. FGP TV prox of z with the Nesterov step y = d + beta (d - x_old) fused
   into its last pass (K3 n_tv_iter - 1 times, then K4);
3. K1: ax = A x_new and the next resid = (b - (ax + beta (ax - ax_old))) R
   (A is linear, so A y_new needs no projection of its own), plus
   ||ax - b||^2;
4. K5: the TV value of x_new for the cost metric.

The state is unpadded and slice-last: volumes (N, N, Ns), sinograms
(Na, Nt, Ns). t and beta stay 0-dim device tensors and the kernels read
beta on the device, so the loop never waits for the host; `fista_run_sl`
returns the (n_iter, 3) metrics (cost, dd, tv) as one device tensor.

compat='reference' reproduces the reference's momentum-SIRT behaviour
(the TV prox result is discarded when momentum is on); momentum=False runs
the same program with beta = 0.

`fista_init`, `fista_step` and `fista_run` are the reference's
slice-first functions: thin layout wrappers over the slice-last functions,
with the reference's state (`FistaState`: volumes (Ns, N, N), projections
(Ns, Na, Nt), ax = A x_old and ay = A yk carried).

With ``group=`` (a `tomojax_torch.dist.SlabGroup`) the state is this
rank's z-slab: volumes (N, N, n_loc), sinograms (Na, Nt, n_loc). K1 and
K2 run on the slab as they are (slices are a batch); the prox runs K9a/K9b
with halo exchanges, and ||A x - b||^2 and the TV value are all-reduced,
so every rank holds the whole volume's metrics. `fista_init_sl` needs no
group: seeding the projections crosses no slab.
"""

from __future__ import annotations

import dataclasses

import torch

from tomojax_torch import ops, profiling
from tomojax_torch.dist import SlabGroup, all_reduce_sum
from tomojax_torch.projector.cuda_joseph import (
    bp_sirt_sl, fp_resid_sl, fp_sl,
)
from tomojax_torch.solvers.base import System
from tomojax_torch.tv import tv, tv_fgp_fused, tv_fgp_sharded


@dataclasses.dataclass(frozen=True)
class FistaStateSL:
    x: torch.Tensor  # (N, N, Ns)
    x_old: torch.Tensor
    yk: torch.Tensor
    t: torch.Tensor  # 0-dim momentum scalar
    ax: torch.Tensor  # (Na, Nt, Ns): A x_old
    resid: torch.Tensor  # (Na, Nt, Ns): (b - A yk) * inv_row


def to_sl(a: torch.Tensor) -> torch.Tensor:
    """Public (..., Ns, A, B) layout -> contiguous slice-last (..., A, B,
    Ns): (Ns, N, N) volumes and (Ns, Na, Nt) sinograms, and 4D stacks with
    a leading element axis."""
    return a.movedim(-3, -1).contiguous()


def from_sl(a: torch.Tensor) -> torch.Tensor:
    """Slice-last (..., A, B, Ns) -> contiguous public (..., Ns, A, B)."""
    return a.movedim(-1, -3).contiguous()


def fista_init_sl(x0: torch.Tensor, sys: System,
                  b_sl: torch.Tensor) -> FistaStateSL:
    """x0 in the public (Ns, N, N) layout on sys's device, b_sl the
    slice-last sinogram (Na, Nt, Ns). Projects x0 once to seed the
    carried residual."""
    xsl = to_sl(x0.to(torch.float32))
    zero = torch.zeros((), dtype=torch.float32, device=xsl.device)
    ax, resid, _ = fp_resid_sl(xsl, sys.geom, b_sl, torch.zeros_like(b_sl),
                               sys.inv_row, zero)
    return FistaStateSL(x=xsl, x_old=xsl, yk=xsl, t=zero + 1.0, ax=ax,
                        resid=resid)


def fista_step_sl(state: FistaStateSL, b_sl: torch.Tensor, sys: System,
                  lam: float, n_tv_iter: int = 10, momentum: bool = True,
                  compat: str = "correct", compute_metrics: bool = True,
                  group: SlabGroup | None = None):
    """One slice-last FISTA-TV iteration. Returns (state, metrics) with
    metrics a (3,) device tensor (cost, dd, tv), zeros when
    compute_metrics is False. With a group every rank calls it on its
    slab together."""
    if compat not in ("correct", "reference"):
        raise ValueError(f"compat must be 'correct' or 'reference': {compat}")
    z = bp_sirt_sl(state.resid, sys.geom, state.yk, sys.inv_col)
    if momentum:
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * state.t * state.t))
        beta = (state.t - 1.0) / t_new
    else:
        t_new = state.t
        beta = torch.zeros_like(state.t)
    if compat == "reference" and momentum:
        x_new = z
        y_new = ops.nesterov(x_new, state.x_old, beta)
    elif group is None:
        x_new, y_new = tv_fgp_fused(z, n_tv_iter, lam,
                                    mom=(state.x_old, beta))
    else:
        x_new, y_new = tv_fgp_sharded(z, n_tv_iter, lam, group,
                                      mom=(state.x_old, beta))
    ax_new, resid_new, ddsq = fp_resid_sl(x_new, sys.geom, b_sl, state.ax,
                                          sys.inv_row, beta)
    state = FistaStateSL(x=x_new, x_old=x_new, yk=y_new, t=t_new, ax=ax_new,
                         resid=resid_new)
    if not compute_metrics:
        return state, torch.zeros(3, dtype=torch.float32, device=z.device)
    if group is not None:
        all_reduce_sum(ddsq, group)
    tv_val = tv(x_new, group)
    cost = 0.5 * ddsq + lam * tv_val
    return state, torch.stack([cost, torch.sqrt(ddsq), tv_val])


def fista_run_sl(state: FistaStateSL, b_sl: torch.Tensor, sys: System,
                 lam: float, n_iter: int, n_tv_iter: int = 10,
                 momentum: bool = True, compat: str = "correct",
                 compute_metrics: bool = True,
                 group: SlabGroup | None = None):
    """`n_iter` iterations; returns (state, metrics (n_iter, 3))."""
    metrics = []
    for _ in range(n_iter):
        with profiling.annotate("solvers.iteration"):
            state, m = fista_step_sl(state, b_sl, sys, lam, n_tv_iter,
                                     momentum, compat, compute_metrics, group)
        metrics.append(m)
    if not metrics:
        return state, torch.zeros((0, 3), dtype=torch.float32,
                                  device=state.x.device)
    return state, torch.stack(metrics)


# ------------------------------------------------------------ slice-first


@dataclasses.dataclass(frozen=True)
class FistaState:
    """The reference's slice-first state: volumes (Ns, N, N), projections
    (Ns, Na, Nt)."""

    x: torch.Tensor
    x_old: torch.Tensor
    yk: torch.Tensor
    t: torch.Tensor  # 0-dim momentum scalar
    ax: torch.Tensor  # A x_old
    ay: torch.Tensor  # A yk


def fista_init(x0: torch.Tensor, sys: System) -> FistaState:
    """yk = x_old = x0, and x0 projected once (K1) to seed ax = ay."""
    x0 = x0.to(torch.float32)
    ax = from_sl(fp_sl(to_sl(x0), sys.geom))
    one = torch.ones((), dtype=torch.float32, device=x0.device)
    return FistaState(x=x0, x_old=x0, yk=x0, t=one, ax=ax, ay=ax)


def fista_run(state: FistaState, b: torch.Tensor, sys: System, lam: float,
              n_iter: int, n_tv_iter: int = 10, momentum: bool = True,
              compat: str = "correct", compute_metrics: bool = True,
              group: SlabGroup | None = None):
    """`n_iter` iterations of `fista_run_sl` on the state and the sinogram
    b (Ns, Na, Nt) in the reference's layout; returns (state, metrics
    (n_iter, 3)). The slice-last state carries (b - A yk) R instead of
    A yk: it is formed from ay on entry, and ay = ax + beta (ax - ax_old)
    on return, as the reference carries it."""
    b_sl = to_sl(b.to(torch.float32))
    st = FistaStateSL(x=to_sl(state.x), x_old=to_sl(state.x_old),
                      yk=to_sl(state.yk), t=state.t, ax=to_sl(state.ax),
                      resid=(b_sl - to_sl(state.ay))
                      * sys.inv_row[:, :, None])
    ax_old, t_old = st.ax, st.t
    metrics = []
    for _ in range(n_iter):
        ax_old, t_old = st.ax, st.t
        st, m = fista_step_sl(st, b_sl, sys, lam, n_tv_iter, momentum,
                              compat, compute_metrics, group)
        metrics.append(m)
    beta = ((t_old - 1.0) / st.t if momentum and metrics
            else torch.zeros_like(st.t))
    ay = from_sl(st.ax + beta * (st.ax - ax_old))
    state = FistaState(x=from_sl(st.x), x_old=from_sl(st.x_old),
                       yk=from_sl(st.yk), t=st.t, ax=from_sl(st.ax), ay=ay)
    if not metrics:
        return state, torch.zeros((0, 3), dtype=torch.float32,
                                  device=st.x.device)
    return state, torch.stack(metrics)


def fista_step(state: FistaState, b: torch.Tensor, sys: System, lam: float,
               n_tv_iter: int = 10, momentum: bool = True,
               compat: str = "correct", compute_metrics: bool = True,
               group: SlabGroup | None = None):
    """One iteration in the reference's layout: (state, (cost, dd, tv)),
    0-dim device tensors (zeros without compute_metrics)."""
    state, m = fista_run(state, b, sys, lam, 1, n_tv_iter, momentum, compat,
                         compute_metrics, group)
    return state, tuple(m[0])
