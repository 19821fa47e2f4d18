"""SIRT, SART, ART, CGLS, Poisson-ML and least-squares iterations
(counterpart of ``tomojax/solvers/iterative.py``).

The work runs slice-last, x (N, N, Ns) and b (Na, Nt, Ns), in the
``*_sl`` functions; ``sirt_sweep``, ``sart_sweep``, ``art_sweep``,
``cgls_run``, ``poisson_ml_step`` and ``least_squares_step`` take the
reference's layout, x (Ns, N, N) and b (Ns, Na, Nt), and convert at the
boundary.

* SIRT, variant 'astra' with the nonnegativity clamp: per iteration K1
  (epilogue off), the inv_row-weighted residual, then K2 with its fused
  update max(x + C A^T r, 0), C = inv_col (the reference's TPU fast path,
  ``_sirt_sweep_pallas_sl``); 'landweber' and 'cimmino' on ``fp_sl`` and
  ``bp_sl``.
* Poisson-ML: x <- max(x - (lam/L) A^T((Ax - b)/(Ax + eps)), 0), eps =
  0.1, cost = sum(Ax - b log(Ax + eps)); the update is K2's epilogue with
  y = x and the constant C = -lam/L, as the reference's fast path runs it.
* SART: the ordered sweep K8 (``solvers/cuda_sart.py``).
* ART: the ray-by-ray Kaczmarz sweep A1 (``solvers/cuda_art.py``).
* CGLS: conjugate gradients on the normal equations with per-slice scalars
  (sums over the image or sinogram plane, dims (0, 1)), on K1 and K2 with
  their epilogues off. The guards on the denominators are ``where``s on
  the device: no host read per iteration.
"""

from __future__ import annotations

import torch

from tomojax_torch.projector.cuda_joseph import bp_sirt_sl, bp_sl, fp_sl
from tomojax_torch.solvers.base import System, _safe_inv, bp_single_angle
from tomojax_torch.solvers.cuda_art import art_sweep_sl
from tomojax_torch.solvers.cuda_sart import sart_sweep_sl
from tomojax_torch.solvers.fista import from_sl, to_sl

POISSON_EPS = 0.1  # the reference's tomoengine.cpp:295
SIRT_VARIANTS = ("astra", "landweber", "cimmino")


# ----------------------------------------------------------------- SIRT


def sirt_sweep_sl(x: torch.Tensor, b: torch.Tensor, sys: System,
                  n_iter: int = 1, variant: str = "astra", beta=None,
                  row_nsq=None, nonneg: bool | None = None) -> torch.Tensor:
    """`n_iter` SIRT iterations, slice-last.

    variant:
      'astra'     x += C A^T R (b - A x), R, C the inverse row and column
                  sums; nonneg defaults True (ASTRA's min-constraint);
      'landweber' x += beta A^T (b - A x), beta defaults to 1/L;
      'cimmino'   x += (beta / Nrow) A^T M (b - A x), M = 1/||a_r||^2 from
                  row_nsq (``solvers.base.row_norms_sq``), beta defaults 1.
    nonneg clamps each iteration (default True for 'astra' only)."""
    if variant not in SIRT_VARIANTS:
        raise ValueError(f"unknown SIRT variant {variant!r}")
    if nonneg is None:
        nonneg = variant == "astra"
    geom = sys.geom
    if variant == "astra":
        ir = sys.inv_row[:, :, None]
        if nonneg:  # the update and clamp run in K2's epilogue
            for _ in range(n_iter):
                resid = (b - fp_sl(x, geom)) * ir
                x = bp_sirt_sl(resid, geom, x, sys.inv_col)
            return x

        def update(xx):
            resid = (b - fp_sl(xx, geom)) * ir
            return xx + sys.inv_col[:, :, None] * bp_sl(resid, geom)
    elif variant == "landweber":
        lw_beta = 1.0 / sys.lipschitz if beta is None else beta

        def update(xx):
            return xx + lw_beta * bp_sl(b - fp_sl(xx, geom), geom)
    else:
        if row_nsq is None:
            raise ValueError("variant 'cimmino' needs row_nsq = "
                             "solvers.base.row_norms_sq(geom, device)")
        nsq = torch.as_tensor(row_nsq, dtype=torch.float32,
                              device=x.device).reshape(geom.nproj, geom.nray)
        m = torch.where(nsq > 1e-12, 1.0 / torch.clamp_min(nsq, 1e-12),
                        0.0)[:, :, None]
        ci_beta = 1.0 if beta is None else beta
        nrow = geom.nproj * geom.nray

        def update(xx):
            resid = m * (b - fp_sl(xx, geom))
            return xx + (ci_beta / nrow) * bp_sl(resid, geom)

    for _ in range(n_iter):
        x = update(x)
        if nonneg:
            x = torch.clamp_min(x, 0.0)
    return x


def sirt_sweep(x: torch.Tensor, b: torch.Tensor, sys: System,
               n_iter: int = 1, variant: str = "astra", beta=None,
               row_nsq=None, nonneg: bool | None = None) -> torch.Tensor:
    """`sirt_sweep_sl` in the reference's layout: x (Ns, N, N), b
    (Ns, Na, Nt)."""
    return from_sl(sirt_sweep_sl(to_sl(x.to(torch.float32)), to_sl(b), sys,
                                 n_iter, variant, beta, row_nsq, nonneg))


# ----------------------------------------------------------------- SART


def make_sart_weights(sys: System) -> torch.Tensor:
    """Per-angle inverse column sums (Na, N, N) on sys's device: the
    one-angle backprojection of a ones sinogram for every angle at once,
    inverted where it exceeds 1e-6 and 0 elsewhere."""
    geom = sys.geom
    ones = torch.ones((geom.nproj, geom.nray), dtype=torch.float32,
                      device=sys.row_sum.device)
    return _safe_inv(bp_single_angle(ones, geom.cos, geom.sin, geom.n))


def sart_sweep(x: torch.Tensor, b: torch.Tensor, sys: System,
               inv_col_a: torch.Tensor, beta=1.0,
               order=None) -> torch.Tensor:
    """One ordered pass over the angle blocks (ASTRA SART ``run(Nproj)``).

    x (Ns, N, N); b (Ns, Na, Nt); inv_col_a from `make_sart_weights`;
    beta a float or 0-dim tensor; order None (sequential) or the (Na,)
    angle visiting order (any integer sequence). Returns the new
    (Ns, N, N) volume."""
    dev = x.device
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    if order is None:
        order = torch.arange(sys.geom.nproj, dtype=torch.int32, device=dev)
    order = torch.as_tensor(order, device=dev).to(torch.int32).contiguous()
    out = sart_sweep_sl(to_sl(x.to(torch.float32)), to_sl(b), sys.geom,
                        sys.inv_row, inv_col_a, beta, order)
    return from_sl(out)


# ------------------------------------------------------------------ ART


def art_sweep(x: torch.Tensor, b: torch.Tensor, sys: System, beta=1.0,
              ray_order=None) -> torch.Tensor:
    """One Kaczmarz sweep over single rays (A1) in the reference's layout:
    x (Ns, N, N), b (Ns, Na, Nt). Rays are visited angle-major (ray a * Nt
    + j) unless `ray_order` (an integer sequence of rays) permutes them,
    as randART does. beta is a float."""
    geom = sys.geom
    dev = x.device
    if ray_order is None:
        ray_order = torch.arange(geom.nproj * geom.nray, dtype=torch.int32,
                                 device=dev)
    order = torch.as_tensor(ray_order, device=dev).to(torch.int32)
    return from_sl(art_sweep_sl(to_sl(x.to(torch.float32)), to_sl(b), geom,
                                float(beta), order.contiguous()))


# ----------------------------------------------------------------- CGLS


def cgls_run_sl(x: torch.Tensor, b: torch.Tensor, sys: System,
                n_iter: int) -> torch.Tensor:
    """`n_iter` CGLS steps from x, slice-last, with per-slice (Ns,) scalars:
    each slice is its own least-squares problem. The CG state starts anew
    each call, as the reference's does; positivity is left to the caller."""
    geom = sys.geom

    def dots(v):
        return torch.sum(v * v, dim=(0, 1))

    r = b - fp_sl(x, geom)
    s = bp_sl(r, geom)
    p = s
    gamma = dots(s)
    for _ in range(n_iter):
        q = fp_sl(p, geom)
        denom = dots(q)
        alpha = torch.where(denom > 0,
                            gamma / torch.clamp_min(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * q
        s = bp_sl(r, geom)
        gamma_new = dots(s)
        beta = torch.where(gamma > 0,
                           gamma_new / torch.clamp_min(gamma, 1e-30), 0.0)
        p = s + beta * p
        gamma = gamma_new
    return x


def cgls_run(x: torch.Tensor, b: torch.Tensor, sys: System,
             n_iter: int) -> torch.Tensor:
    """`cgls_run_sl` in the reference's layout."""
    return from_sl(cgls_run_sl(to_sl(x.to(torch.float32)), to_sl(b), sys,
                               n_iter))


# ----------------------------------------------------------- Poisson-ML


def poisson_ml_step_sl(x: torch.Tensor, b: torch.Tensor, sys: System, lam):
    """One Poisson maximum-likelihood step and positivity, slice-last:
    returns (x_new, kl_cost), the cost a 0-dim tensor. b must be
    normalised to max <= 1 (the API does it). lam is a float or a 0-dim
    tensor on x's device."""
    geom = sys.geom
    ax = fp_sl(x, geom)
    ratio = (ax - b) / (ax + POISSON_EPS)
    neg_scale = (-lam / sys.lipschitz).expand(geom.n, geom.n).contiguous()
    x_new = bp_sirt_sl(ratio, geom, x, neg_scale)
    return x_new, torch.sum(ax - b * torch.log(ax + POISSON_EPS))


def poisson_ml_step(x: torch.Tensor, b: torch.Tensor, sys: System, lam):
    """`poisson_ml_step_sl` in the reference's layout."""
    x_new, cost = poisson_ml_step_sl(to_sl(x.to(torch.float32)), to_sl(b),
                                     sys, lam)
    return from_sl(x_new), cost


# -------------------------------------------------------- least squares


def least_squares_step(x: torch.Tensor, b: torch.Tensor,
                       sys: System) -> torch.Tensor:
    """Plain gradient step x -= (1/L) A^T (A x - b) in the reference's
    layout (the reference's tomoengine.cpp:386-401)."""
    xs = to_sl(x.to(torch.float32))
    grad = bp_sl(fp_sl(xs, sys.geom) - to_sl(b), sys.geom)
    return from_sl(xs - (1.0 / sys.lipschitz) * grad)
