"""The work of each layer call that a roofline metric reads, and the card's
peaks.

A roofline share is the least time the card could take for a call
divided by the time the call took. The least time is the larger of the
call's bytes over the memory rate and its operations over the float32
rate. Bytes count each input of the call read once and each output
written once, whatever the kernels that implement it read again or keep
in between: a later change that fuses kernels or keeps intermediates on
chip is measured against the same work. Operations count the arithmetic
the algorithm needs, without the recomputation a kernel may choose.

Each work function takes the arguments of the port's function of the
same name and returns (bytes, operations). The counts follow the
formulas of ``chip_smoke.py`` (``bound``, ``sart_work``, the projector
rows); the FGP and TV-GD counts are per voxel without recomputation.
"""

from __future__ import annotations

import functools

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

FGP_ITER_OPS = 27  # the objective (8) and the dual step and projection (19)
FGP_OBJ_OPS = 8
MOMENTUM_OPS = 3
TV_VALUE_OPS = 11  # three differences, squares, sums, eps, sqrt, the sum
TV_STEP_OPS = 29  # the subgradient (24), its norm (2), the step (3)


def bound_s(bytes_: float, ops: float) -> float:
    """The least time in seconds: max(bytes / 3.35 TB/s, ops / 67 TFLOP/s)."""
    return max(bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


@functools.lru_cache(maxsize=64)
def _nnz(n: int, nray: int, angles_key: tuple) -> int:
    """The nonzero weights of the Joseph matrix A: both taps of every
    (angle, pixel) of the backprojection's closed form that fall on a bin
    with a nonzero weight (float32 arithmetic, as the tables are)."""
    a = np.asarray(angles_key, np.float64)
    c, s = np.cos(a), np.sin(a)
    c[np.abs(c) < 1e-12] = 0.0
    s[np.abs(s) < 1e-12] = 0.0
    invd = (1.0 / np.maximum(np.abs(c), np.abs(s))).astype(np.float32)
    c, s = c.astype(np.float32), s.astype(np.float32)
    ctr = np.float32((n - 1) / 2.0)
    xc = np.arange(n, dtype=np.float32) - ctr
    yr = ctr - np.arange(n, dtype=np.float32)
    total = 0
    for k in range(len(a)):
        jstar = (c[k] * xc[None, :] + s[k] * yr[:, None]
                 + np.float32((nray - 1) / 2.0))
        f = np.floor(jstar)
        for fj in (f, f + 1):
            w = np.maximum(1.0 - np.abs(fj - jstar) * invd[k], 0.0) * invd[k]
            total += int(np.count_nonzero((fj >= 0) & (fj < nray) & (w != 0)))
    return total


def nnz(geom) -> int:
    """Nonzeros of A for a geometry with n, nray and angles (radians)."""
    return _nnz(geom.n, geom.nray, tuple(float(v) for v in geom.angles))


def _sizes(geom, ns: int):
    v = geom.n * geom.n * ns
    s = geom.nproj * geom.nray * ns
    return v, s, geom.n * geom.n


def fp_sl(x, geom, *_, **__):
    v, s, _ = _sizes(geom, x.shape[-1])
    return 4 * (v + s), 2 * nnz(geom) * x.shape[-1]


def fp_resid_sl(x, geom, *_, **__):
    """x, b, ax_old, inv_row, beta in; ax, resid, ||A x - b||^2 out."""
    ns = x.shape[-1]
    v, s, _ = _sizes(geom, ns)
    return (4 * (v + 4 * s + geom.nproj * geom.nray + 1),
            2 * nnz(geom) * ns + 8 * s)


def bp_sl(y, geom, *_, **__):
    v, s, _ = _sizes(geom, y.shape[-1])
    return 4 * (s + v), 2 * nnz(geom) * y.shape[-1]


def bp_sirt_sl(resid, geom, *_, **__):
    """resid, y_vol, inv_col in; max(y_vol + inv_col A^T resid, 0) out."""
    ns = resid.shape[-1]
    v, s, p = _sizes(geom, ns)
    return 4 * (s + 2 * v + p), 2 * nnz(geom) * ns + 3 * v


def tv_fgp_fused(x, n_iter, lam, dual_dtype=None, mom=None, *_, **kw):
    """x in, d out; with momentum x_old and beta in, y out."""
    mom = kw.get("mom", mom)
    v = x.numel()
    ops = (n_iter - 1) * FGP_ITER_OPS * v + FGP_OBJ_OPS * v
    bytes_ = 8 * v
    if mom is not None:
        bytes_ += 8 * v + 4
        ops += MOMENTUM_OPS * v
    return bytes_, ops


def tv_descent(x, ng, dpocs, *_, **__):
    """x in, x out; ng normalised subgradient steps."""
    v = x.numel()
    return 8 * v, ng * TV_STEP_OPS * v + v


def sart_sweep_sl(x, b, geom, inv_row, inv_col_a, beta, order, *_, **__):
    """One sweep: x in and out once; b, inv_row, inv_col_a, beta, order
    read once; per angle its forward and back taps (a multiply-add per
    nonzero and slice each way) and a 4-operation update of every
    voxel."""
    n, na, ns = geom.n, geom.nproj, x.shape[-1]
    return (4 * (2 * n * n * ns + na * geom.nray * (ns + 1) + na * n * n
                 + na + 1),
            4 * nnz(geom) * ns + 4 * na * n * n * ns)


WORK = {f.__name__: f for f in (fp_sl, fp_resid_sl, bp_sl, bp_sirt_sl,
                                tv_fgp_fused, tv_descent, sart_sweep_sl)}
