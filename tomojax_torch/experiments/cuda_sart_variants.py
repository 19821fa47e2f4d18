"""Experiment SART sweeps E3 and E4 on the card, with their plain PyTorch
version and the tap tables.

Counterparts of the TPU kernels of ``scripts/exp_sart_pipeline.py`` and
``exp_sart_ablate.py``. Operands as ``solvers/cuda_sart.py`` (K8): x
(N, N, Ns), b (Na, Nt, Ns), inv_row (Na, Nt), inv_col_a (Na, N, N), beta a
0-dim float32 tensor and order an int32 (K,) tensor on x's device. For
k = 0, 1, ... with angle a = order[k]:

    acc   = sum over the FP taps of w x
    resid = (b[a] - invd acc) * inv_row[a]
    x     = max(x + (beta invd) inv_col_a[a] * sum over the taps of w resid, 0)

with the unscaled hat w = max(0, min(1 - u, 1 + u)), u = (j - J*) invd, of
the TPU sweeps (their 1/D deferred into the two scalars), on K1's FP taps
and K2's BP taps. `MODES` (csrc/exp_hat.cuh):

* TAPS_F32: float32 throughout (the TPU's dbuf, wv_f32, ablate full / rot,
  phase); TAPS_BF16: w, the FP's x and the update's residual rounded to
  bf16, products exact in float32 (wvmem, wv_rebuild / reread / fold, res);
  TABLE_BF16: TAPS_BF16 with taps and weights read from `sart_tables`
  (whbm, reshbm);
* the ablations of exp_sart_ablate.py, on the same taps: NOHAT (the constant
  weight 0.01), NOFP (no FP walk: resid = b[a] inv_row[a]) and NOUPD (the
  FP walks, x is returned unchanged).

* E3 ``sart_variant`` (``csrc/exp_sart.cu`` ``exp_sart_fp_kernel`` +
  ``exp_sart_update_kernel``): K8's two launches per angle in any mode.
* E4 ``sart_resident`` (``exp_sart_resident_kernel``): the sweep in one
  launch, each block owning ``sb`` slices (`SLICES_PER_BLOCK`) for every
  angle (TAPS_F32, TAPS_BF16, TABLE_BF16); it equals E3.

The plain version `sart_variant_ref` goes one angle at a time in the
kernels' order of operations, so it equals both bit for bit. A wrapper runs
it only when its tensors lie on the CPU; on CUDA tensors it launches its
kernel or raises, and counts in ``<wrapper>.launches``.
"""

from __future__ import annotations

import dataclasses

import torch

from tomojax_torch import _build
from tomojax_torch.experiments.cuda_projector_variants import (
    bp_taps, fp_taps, gather_bins, gather_taps, sequential_sum, weight,
)
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import angle_tables

F32, BF16 = torch.float32, torch.bfloat16
MODES = ("TAPS_F32", "TAPS_BF16", "TABLE_BF16", "NOHAT", "NOFP", "NOUPD")
RESIDENT_MODES = ("TAPS_F32", "TAPS_BF16", "TABLE_BF16")
SLICES_PER_BLOCK = (1, 2, 4, 8)  # E4 slab widths; 4 by default
NOHAT_WEIGHT = 0.01  # exp_sart_ablate.py's constant


@dataclasses.dataclass(frozen=True)
class SartTables:
    """Taps and bf16 weights of one geometry (TABLE_BF16): for each angle,
    bin and driving step the first FP tap index and its two weights
    (fp_i0 int32 (Na, Nt, N), fp_w bf16 (Na, Nt, N, 2)), and for each angle
    and pixel the first bin and its two weights (bp_j0 int32 (Na, N, N),
    bp_w bf16 (Na, N, N, 2))."""

    fp_i0: torch.Tensor
    fp_w: torch.Tensor
    bp_j0: torch.Tensor
    bp_w: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.fp_i0, self.fp_w, self.bp_j0, self.bp_w))


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).float()


def _fp_weights(tf, tb, n: int, nt: int, device, mode: str):
    """First taps (N, Nt) and weights (N, Nt) of one angle's FP walk."""
    i0, js0, js1, rd = fp_taps(tf, tb, n, nt, device)
    if mode == "NOHAT":
        w = torch.full(js0.shape, NOHAT_WEIGHT, dtype=F32, device=device)
        return i0, w, w, rd
    jf = torch.arange(nt, dtype=F32, device=device)[None, :]
    w0, w1 = (weight("HAT5", jf, js, tb[2]) for js in (js0, js1))
    if mode in ("TAPS_BF16", "TABLE_BF16"):
        w0, w1 = _round_bf16(w0), _round_bf16(w1)
    return i0, w0, w1, rd


def _bp_weights(tb, n: int, nt: int, device, mode: str):
    """First bins (N, N) and weights (N, N) of one angle's update."""
    j0, f, jstar = bp_taps(tb, n, nt, device)
    if mode == "NOHAT":
        w = torch.full(jstar.shape, NOHAT_WEIGHT, dtype=F32, device=device)
        return j0, w, w
    w0 = weight("HAT5", f, jstar, tb[2])
    w1 = weight("HAT5", f + 1.0, jstar, tb[2])
    if mode in ("TAPS_BF16", "TABLE_BF16"):
        w0, w1 = _round_bf16(w0), _round_bf16(w1)
    return j0, w0, w1


def sart_tables(geom: Geometry, device) -> SartTables:
    """The TABLE_BF16 tables of `geom`, built once per geometry with plain
    PyTorch (the counterpart of exp_sart_pipeline.py:build_w_hbm): the taps
    and bf16 weights that TAPS_BF16 computes in the kernel."""
    n, nt, na = geom.n, geom.nray, geom.nproj
    tabs = angle_tables(geom, torch.device("cpu"))
    tf, tb = tabs.fp.tolist(), tabs.bp.tolist()
    fp_i0 = torch.empty((na, nt, n), dtype=torch.int32, device=device)
    fp_w = torch.empty((na, nt, n, 2), dtype=BF16, device=device)
    bp_j0 = torch.empty((na, n, n), dtype=torch.int32, device=device)
    bp_w = torch.empty((na, n, n, 2), dtype=BF16, device=device)
    for a in range(na):
        i0, w0, w1, _ = _fp_weights(tf[a], tb[a], n, nt, device, "TAPS_BF16")
        fp_i0[a] = i0.T
        fp_w[a] = torch.stack([w0.T, w1.T], dim=-1)
        j0, w0, w1 = _bp_weights(tb[a], n, nt, device, "TAPS_BF16")
        bp_j0[a] = j0
        bp_w[a] = torch.stack([w0, w1], dim=-1)
    return SartTables(fp_i0, fp_w, bp_j0, bp_w)


def sart_variant_ref(x, b, geom: Geometry, inv_row, inv_col_a, beta, order,
                     mode: str = "TAPS_F32", tables: SartTables | None = None):
    """Plain E3 / E4: one ordered pass over the angles of `order` in `mode`
    (TABLE_BF16 reads `tables`); returns the new (N, N, Ns) volume."""
    n, nt = geom.n, geom.nray
    tabs = angle_tables(geom, torch.device("cpu"))
    tf, tb = tabs.fp.tolist(), tabs.bp.tolist()
    bf16 = mode in ("TAPS_BF16", "TABLE_BF16")
    x_in = x
    for a in order.tolist():
        invd = tb[a][2]
        if mode == "NOFP":
            acc = torch.zeros_like(b[a])
        else:
            if mode == "TABLE_BF16":
                i0 = tables.fp_i0[a].T.long()
                w0, w1 = (tables.fp_w[a, :, :, i].T.float() for i in (0, 1))
                rd = tf[a][3] != 0.0
            else:
                i0, w0, w1, rd = _fp_weights(tf[a], tb[a], n, nt, x.device,
                                             mode)
            v0, v1 = gather_taps(x, i0, rd)
            if bf16:
                v0, v1 = _round_bf16(v0), _round_bf16(v1)
            acc = sequential_sum(w0[..., None] * v0, w1[..., None] * v1)
        resid = (b[a] - acc * invd) * inv_row[a][:, None]
        if bf16:
            resid = _round_bf16(resid)
        if mode == "NOUPD":
            continue
        if mode == "TABLE_BF16":
            j0 = tables.bp_j0[a].long()
            w0, w1 = (tables.bp_w[a, :, :, i].float() for i in (0, 1))
        else:
            j0, w0, w1 = _bp_weights(tb[a], n, nt, x.device, mode)
        r0, r1 = gather_bins(resid, j0)
        upd = w0[..., None] * r0 + w1[..., None] * r1
        scale = (beta * invd) * inv_col_a[a]
        x = torch.clamp_min(x + scale[..., None] * upd, 0.0)
    return x.clone() if x is x_in else x


# ------------------------------------------------------------------ wrappers


def _check(x, b, geom: Geometry, inv_row, inv_col_a, beta, order, mode,
           tables, modes):
    if mode not in modes:
        raise ValueError(f"mode must be one of {modes}, got {mode!r}")
    n, nt, na, ns = geom.n, geom.nray, geom.nproj, x.shape[-1]
    _build.check_operand(x, "x", (n, n, ns), F32)
    _build.check_operand(b, "b", (na, nt, ns), F32)
    _build.check_operand(inv_row, "inv_row", (na, nt), F32)
    _build.check_operand(inv_col_a, "inv_col_a", (na, n, n), F32)
    _build.check_operand(beta, "beta", (), F32)
    if order.dim() != 1 or order.numel() == 0:
        raise ValueError(f"order: shape {tuple(order.shape)}, expected (K,) "
                         f"with K >= 1")
    _build.check_operand(order, "order", order.shape, torch.int32)
    ops = [x, b, inv_row, inv_col_a, beta, order]
    if mode == "TABLE_BF16":
        if tables is None:
            raise ValueError("mode TABLE_BF16 needs the tables of "
                             "sart_tables(geom, device)")
        _build.check_operand(tables.fp_i0, "fp_i0", (na, nt, n), torch.int32)
        _build.check_operand(tables.fp_w, "fp_w", (na, nt, n, 2), BF16)
        _build.check_operand(tables.bp_j0, "bp_j0", (na, n, n), torch.int32)
        _build.check_operand(tables.bp_w, "bp_w", (na, n, n, 2), BF16)
        ops += [tables.fp_i0, tables.fp_w, tables.bp_j0, tables.bp_w]
    return _build.on_cpu(*ops)


def _table_ptrs(mode: str, tables: SartTables | None):
    if mode != "TABLE_BF16":
        return [None] * 4
    return [t.data_ptr() for t in (tables.fp_i0, tables.fp_w, tables.bp_j0,
                                   tables.bp_w)]


def sart_variant(x, b, geom: Geometry, inv_row, inv_col_a, beta, order,
                 mode: str = "TAPS_F32", tables: SartTables | None = None):
    """E3: `sart_variant_ref` on the card, two launches per angle (one for
    NOUPD). Entries of order must lie in [0, Na): the plain version raises
    on others, the kernel leaves x unchanged for them."""
    if _check(x, b, geom, inv_row, inv_col_a, beta, order, mode, tables,
              MODES):
        return sart_variant_ref(x, b, geom, inv_row, inv_col_a, beta, order,
                                mode, tables)
    tabs = angle_tables(geom, x.device)
    resid = torch.empty((geom.nray, x.shape[-1]), dtype=F32, device=x.device)
    out = torch.empty_like(x)
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_exp_sart_sweep(
        MODES.index(mode), p(x), p(tabs.fp), p(tabs.bp), p(b), p(inv_row),
        p(inv_col_a), p(beta), p(order), order.numel(), p(resid), p(out),
        *_table_ptrs(mode, tables), geom.n, geom.nray, geom.nproj,
        x.shape[-1], _build.stream()), "tj_exp_sart_sweep")
    sart_variant.launches += 1
    return out


def sart_resident(x, b, geom: Geometry, inv_row, inv_col_a, beta, order,
                  mode: str = "TAPS_BF16", tables: SartTables | None = None,
                  sb: int = 4):
    """E4: the same sweep as `sart_variant` in one launch, `sb` slices per
    block (a slab width of `SLICES_PER_BLOCK`: fewer slices give more
    blocks to fill the card, more give longer contiguous reads); mode
    TAPS_F32, TAPS_BF16 or TABLE_BF16."""
    if sb not in SLICES_PER_BLOCK:
        raise ValueError(f"sb must be one of {SLICES_PER_BLOCK}, got {sb!r}")
    if _check(x, b, geom, inv_row, inv_col_a, beta, order, mode, tables,
              RESIDENT_MODES):
        return sart_variant_ref(x, b, geom, inv_row, inv_col_a, beta, order,
                                mode, tables)
    tabs = angle_tables(geom, x.device)
    out = torch.empty_like(x)
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_exp_sart_resident(
        MODES.index(mode), p(x), p(tabs.fp), p(tabs.bp), p(b), p(inv_row),
        p(inv_col_a), p(beta), p(order), order.numel(), p(out),
        *_table_ptrs(mode, tables), geom.n, geom.nray, geom.nproj,
        x.shape[-1], sb, _build.stream()),
        "tj_exp_sart_resident")
    sart_resident.launches += 1
    return out


sart_variant.launches = 0
sart_resident.launches = 0

