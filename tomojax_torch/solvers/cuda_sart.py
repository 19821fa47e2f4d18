"""Ordered SART sweep kernel K8 on the card, with its plain PyTorch version.

Counterpart of ``tomojax/solvers/pallas_sart.py`` (``_sart_resident_kernel``,
``_sart_kernel``) and of the XLA branch of
``tomojax/solvers/iterative.py:sart_sweep`` whose semantics they share.
Slice-last, unpadded: x (N, N, Ns), b (Na, Nt, Ns). For k = 0, 1, ...
with angle a = order[k]:

    resid = (b[a] - A_a x) * inv_row[a]
    x     = max(x + beta * inv_col_a[a] * A_a^T resid, 0)

A_a is the one-angle Joseph operator of K1 (driving-axis walk) and its
transpose as K2 computes it (closed-form 2-tap gather); the plain version
is K1's and K2's one-angle plain bodies (``cuda_joseph.fp_angle_ref``,
``bp_angle_ref``), and all read the float64-derived tables of
``cuda_joseph.angle_tables``, so the plain version and the kernel pick
the same taps. ``sart_sweep_sl`` runs
the plain version only when its tensors lie on the CPU; on CUDA tensors it
launches ``csrc/sart.cu`` or raises. One call is one sweep and counts one
in ``sart_sweep_sl.launches``.
"""

from __future__ import annotations

import torch

from tomojax_torch import _build
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import (
    angle_tables, bp_angle_ref, fp_angle_ref,
)

F32 = torch.float32


def sart_sweep_sl_ref(x, b, geom: Geometry, inv_row, inv_col_a, beta, order):
    """Plain K8: one ordered SART pass over the angles of ``order``
    (an int (K,) tensor, a full sweep when it is a permutation of
    range(Na)); returns the new (N, N, Ns) volume."""
    n, nt = geom.n, geom.nray
    tabs = angle_tables(geom, torch.device("cpu"))
    fp_tab, bp_tab = tabs.fp.tolist(), tabs.bp.tolist()
    for a in order.tolist():
        proj = fp_angle_ref(x, fp_tab[a], n, nt)
        resid = (b[a] - proj) * inv_row[a][:, None]
        upd = bp_angle_ref(resid, bp_tab[a], n)
        x = torch.clamp_min(x + beta * inv_col_a[a][:, :, None] * upd, 0.0)
    return x


def sart_sweep_sl(x, b, geom: Geometry, inv_row, inv_col_a, beta, order):
    """K8: `sart_sweep_sl_ref` on the card.

    x (N, N, Ns); b (Na, Nt, Ns); inv_row (Na, Nt) = System.inv_row;
    inv_col_a (Na, N, N) per-angle column weights
    (``iterative.make_sart_weights``); beta a 0-dim float32 tensor and
    order a contiguous int32 (K,) tensor, both on x's device and read there
    by the kernel. Entries of order must lie in [0, Na): the plain version
    raises on others, the kernel leaves x unchanged for them."""
    ns = x.shape[-1]
    n, nt, na = geom.n, geom.nray, geom.nproj
    _build.check_operand(x, "x", (n, n, ns), F32)
    _build.check_operand(b, "b", (na, nt, ns), F32)
    _build.check_operand(inv_row, "inv_row", (na, nt), F32)
    _build.check_operand(inv_col_a, "inv_col_a", (na, n, n), F32)
    _build.check_operand(beta, "beta", (), F32)
    if order.dim() != 1 or order.numel() == 0:
        raise ValueError(f"order: shape {tuple(order.shape)}, expected (K,) "
                         f"with K >= 1")
    _build.check_operand(order, "order", order.shape, torch.int32)
    if _build.on_cpu(x, b, inv_row, inv_col_a, beta, order):
        return sart_sweep_sl_ref(x, b, geom, inv_row, inv_col_a, beta, order)
    tabs = angle_tables(geom, x.device)
    resid = torch.empty((nt, ns), dtype=F32, device=x.device)
    out = torch.empty_like(x)
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_sart_sweep(
        p(x), p(tabs.fp), p(tabs.bp), p(b), p(inv_row), p(inv_col_a),
        p(beta), p(order), order.numel(), p(resid), p(out), n, nt, na, ns,
        _build.stream()), "tj_sart_sweep")
    sart_sweep_sl.launches += 1
    return out


sart_sweep_sl.launches = 0
