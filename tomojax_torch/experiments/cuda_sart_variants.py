"""Experiment SART sweeps E3 and E4 on the card, with their plain PyTorch
version and the tap tables.

Counterparts of the TPU kernels of ``scripts/exp_sart_pipeline.py`` and
``exp_sart_ablate.py``, and the instruments that split K8's step
(``solvers/cuda_sart.py``) as E1/E2 split K1/K2. Operands as K8's: x
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

* E3 ``sart_variant`` (``csrc/exp_sart.cu``): any mode on its own route
  at this shape (`e3_route`): resident (N <= 288 at Nt = N) as K8's
  cluster-resident sweep (``csrc/sart_resident.cuh``) at K8's first
  shape, 8 blocks (bands of rows) a cluster and 4 slices a pixel, one
  launch a sweep; streaming above, two launches a step (K8 itself runs
  (16, 2) up to N = 528: E3 has no such shape). On the resident route
  TAPS_F32 - NOHAT is the hat's share of K8's step, TAPS_F32 - NOFP the
  FP's, TAPS_F32 - NOUPD the update's.
* E4 ``sart_resident`` (``csrc/exp_sart_shapes.cu``): the resident sweep in
  TAPS_F32, TAPS_BF16 or TABLE_BF16 at a cluster shape of `E4_SHAPES`:
  8 or 16 blocks, 1, 2 or 4 slices a pixel. A shape whose block does not
  fit the card's shared memory (`shape_fits`) raises; E4 never runs
  another shape or route in its place.

Both are bound, as K8's resident route, by the shared-memory reads of the
FP and the update and a cluster barrier a step, far below device memory.

The plain version `sart_variant_ref` goes one angle at a time in the
kernels' order of operations, every operation rounded on its own. With
``bands=B`` it sums each ray as the resident kernel with B blocks does
(per band and phase, then phase 0 + phase 1, then the bands in rank
order); with bands=1 in the driving order of the streaming route. So each
kernel equals it bit for bit at its own B. A wrapper runs it only when its
tensors lie on the CPU; on CUDA tensors it launches its kernel or raises,
and counts in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tomojax_torch import _build
from tomojax_torch.experiments.cuda_projector_variants import (
    bp_taps, fp_taps, gather_bins, gather_taps, sequential_sum, weight,
)
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import angle_tables
from tomojax_torch.solvers.cuda_sart import (
    BAND_BLOCKS, CLUSTER_SLICES, PHASES, RESIDENT_SMEM_MAX, band_rows,
    column_steps, phase_cycles, resident_smem_bytes, shape_fits,
)

F32, BF16 = torch.float32, torch.bfloat16
MODES = ("TAPS_F32", "TAPS_BF16", "TABLE_BF16", "NOHAT", "NOFP", "NOUPD")
RESIDENT_MODES = ("TAPS_F32", "TAPS_BF16", "TABLE_BF16")
# E4's cluster shapes (blocks, slices a pixel), K8's (8, 4) first
E4_BLOCKS, E4_SLICES = (8, 16), (4, 2, 1)
E4_SHAPES = tuple((blk, sb) for blk in E4_BLOCKS for sb in E4_SLICES)
NOHAT_WEIGHT = 0.01  # exp_sart_ablate.py's constant


def e4_shapes(n: int, nt: int) -> list:
    """The shapes of `E4_SHAPES` that fit at N, Nt."""
    return [s for s in E4_SHAPES if shape_fits(n, nt, *s)]


def e3_route(n: int, nt: int) -> str:
    """The route ``tj_exp_sart_sweep`` takes at this shape: 'resident'
    where E3's one cluster shape (`BAND_BLOCKS`, `CLUSTER_SLICES`: K8's
    first, exp_sart.cu E_BLOCKS, E_SLICES) fits, else 'streaming'."""
    return ("resident" if shape_fits(n, nt, BAND_BLOCKS, CLUSTER_SLICES)
            else "streaming")


def e3_bands(n: int, nt: int) -> int:
    """The bands E3 sums a ray over at this shape: 8 on its resident
    route, 1 (the driving order) on the streaming one."""
    return BAND_BLOCKS if e3_route(n, nt) == "resident" else 1


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


def _band_sum(p0, p1, i0, t_fp, n: int, nt: int, bands: int):
    """The ray sums (Nt, Ns) of the products p0, p1 (N steps, Nt, Ns) of the
    taps i0 and i0 + 1 (N, Nt) of one angle (fp table row t_fp) in the
    resident kernel's order with `bands` blocks: block b holds rows
    [b R, (b + 1) R), R = band_rows(N, bands), and walks, in two phases
    (the even and odd steps of its range), the band's rows (row-driven) or
    the steps of `column_steps` (column-driven), taps outside its rows
    reading 0; each phase adds (acc + p0) + p1 a step; then phase 0 +
    phase 1 per band, and the bands in rank order."""
    ns = p0.shape[-1]
    dev = p0.device
    rows = band_rows(n, bands)
    acc = torch.zeros((bands, 2, nt, ns), dtype=F32, device=dev)
    if t_fp[3] != 0.0:  # row-driven: band b's steps are its rows
        pad = bands * rows - n
        if pad:
            z = torch.zeros((pad, nt, ns), dtype=F32, device=dev)
            p0, p1 = torch.cat([p0, z]), torch.cat([p1, z])
        q0 = p0.reshape(bands, rows, nt, ns)
        q1 = p1.reshape(bands, rows, nt, ns)
        for t in range(rows):
            acc[:, t % 2] = (acc[:, t % 2] + q0[:, t]) + q1[:, t]
    else:  # column-driven: per band the steps that reach its rows
        f32 = np.float32
        ctr = f32(0.5) * f32(n - 1)
        u = ctr - (np.arange(nt, dtype=f32)
                   - f32(0.5) * f32(nt - 1)) * f32(t_fp[0])
        lo = [min(blk * rows, n) for blk in range(bands)]
        hi = [min((blk + 1) * rows, n) for blk in range(bands)]
        ks = [column_steps(u, t_fp[1], n, nt, r0, r1)
              for r0, r1 in zip(lo, hi)]
        k0 = torch.from_numpy(np.stack([k[0] for k in ks])).to(dev)
        k1 = torch.from_numpy(np.stack([k[1] for k in ks])).to(dev)
        lo_t = torch.tensor(lo, device=dev)[:, None]
        hi_t = torch.tensor(hi, device=dev)[:, None]
        jj = torch.arange(nt, device=dev)[None, :]
        for t in range(int((k1 - k0).max())):
            k = k0 + t
            ok = k < k1
            kc = k.clamp(max=n - 1)
            tap = i0[kc, jj]  # (bands, Nt)
            m0 = ok & (tap >= lo_t) & (tap < hi_t)
            m1 = ok & (tap + 1 >= lo_t) & (tap + 1 < hi_t)
            g0 = torch.where(m0[..., None], p0[kc, jj], 0.0)
            g1 = torch.where(m1[..., None], p1[kc, jj], 0.0)
            acc[:, t % 2] = (acc[:, t % 2] + g0) + g1
    part = acc[:, 0] + acc[:, 1]
    ray = part[0]
    for blk in range(1, bands):
        ray = ray + part[blk]
    return ray


def sart_variant_ref(x, b, geom: Geometry, inv_row, inv_col_a, beta, order,
                     mode: str = "TAPS_F32", tables: SartTables | None = None,
                     bands: int = 1):
    """Plain E3 / E4: one ordered pass over the angles of `order` in `mode`
    (TABLE_BF16 reads `tables`), each ray summed as the resident kernel
    with `bands` blocks sums it (1: in the driving order, as the streaming
    route); returns the new (N, N, Ns) volume."""
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
            p0, p1 = w0[..., None] * v0, w1[..., None] * v1
            acc = (sequential_sum(p0, p1) if bands == 1
                   else _band_sum(p0, p1, i0, tf[a], n, nt, bands))
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
    """E3: `sart_variant_ref` on the card on `e3_route` (one
    launch a sweep on the resident route, two launches a step, one for
    NOUPD, on the streaming one); summed over `e3_bands` bands. Entries of
    order must lie in [0, Na): the plain version raises on others, the
    kernel leaves x unchanged for them."""
    n, nt = geom.n, geom.nray
    if _check(x, b, geom, inv_row, inv_col_a, beta, order, mode, tables,
              MODES):
        return sart_variant_ref(x, b, geom, inv_row, inv_col_a, beta, order,
                                mode, tables, e3_bands(n, nt))
    tabs = angle_tables(geom, x.device)
    resid = (torch.empty((nt, x.shape[-1]), dtype=F32, device=x.device)
             if e3_route(n, nt) == "streaming" else None)
    out = torch.empty_like(x)
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_exp_sart_sweep(
        MODES.index(mode), p(x), p(tabs.fp), p(tabs.bp), p(b), p(inv_row),
        p(inv_col_a), p(beta), p(order), order.numel(),
        None if resid is None else p(resid), p(out),
        *_table_ptrs(mode, tables), n, nt, geom.nproj, x.shape[-1],
        _build.stream()), "tj_exp_sart_sweep")
    sart_variant.launches += 1
    return out


def _check_shape(n: int, nt: int, blocks: int, sb: int) -> None:
    if blocks not in E4_BLOCKS:
        raise ValueError(f"blocks must be one of {E4_BLOCKS}, got "
                         f"{blocks!r}")
    if sb not in E4_SLICES:
        raise ValueError(f"sb must be one of {E4_SLICES}, got {sb!r}")
    if not shape_fits(n, nt, blocks, sb):
        raise ValueError(
            f"E4 shape ({blocks}, {sb}) needs "
            f"{resident_smem_bytes(n, nt, blocks, sb)} B of shared memory a "
            f"block at N {n}, Nt {nt}, above {RESIDENT_SMEM_MAX}")


def sart_resident(x, b, geom: Geometry, inv_row, inv_col_a, beta, order,
                  mode: str = "TAPS_BF16", tables: SartTables | None = None,
                  blocks: int = BAND_BLOCKS, sb: int = CLUSTER_SLICES):
    """E4: the sweep of `sart_variant` in one launch of the resident sweep
    at cluster shape (`blocks`, `sb`) of `E4_SHAPES` (K8's (8, 4) by
    default); mode TAPS_F32, TAPS_BF16 or TABLE_BF16. Raises for a shape
    that does not fit (`shape_fits`), on the CPU too; on the card a cluster
    the card refuses fails the launch."""
    _check_shape(geom.n, geom.nray, blocks, sb)
    if _check(x, b, geom, inv_row, inv_col_a, beta, order, mode, tables,
              RESIDENT_MODES):
        return sart_variant_ref(x, b, geom, inv_row, inv_col_a, beta, order,
                                mode, tables, blocks)
    tabs = angle_tables(geom, x.device)
    out = torch.empty_like(x)
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_exp_sart_resident(
        MODES.index(mode), p(x), p(tabs.fp), p(tabs.bp), p(b), p(inv_row),
        p(inv_col_a), p(beta), p(order), order.numel(), p(out),
        *_table_ptrs(mode, tables), geom.n, geom.nray, geom.nproj,
        x.shape[-1], blocks, sb, _build.stream()),
        "tj_exp_sart_resident")
    sart_resident.launches += 1
    return out


def resident_clusters(n: int, nt: int, ns: int, blocks: int = BAND_BLOCKS,
                      sb: int = CLUSTER_SLICES,
                      mode: str = "TAPS_F32") -> dict:
    """The resident launch of E3 (the default shape, any mode) or E4 at this
    shape on the current card: clusters (one per `sb` slices), how many the
    card holds at once (cudaOccupancyMaxActiveClusters; 0: it cannot launch
    them), the waves that makes and the shared memory of a block."""
    _check_shape(n, nt, blocks, sb)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    active = ctypes.c_int(0)
    _build.check(_build.lib().tj_exp_sart_active_clusters(
        MODES.index(mode), n, nt, ns, blocks, sb, ctypes.byref(active)),
        "tj_exp_sart_active_clusters")
    clusters = -(-ns // sb)
    return {"clusters": clusters, "active": active.value,
            "waves": -(-clusters // max(active.value, 1)),
            "smem": resident_smem_bytes(n, nt, blocks, sb)}


def resident_phases(x, b, geom: Geometry, inv_row, inv_col_a, beta, order,
                    mode: str = "TAPS_F32",
                    tables: SartTables | None = None) -> dict:
    """One E3 sweep on the resident route with its phases timed (the PROF
    instantiation of `mode`; operands on the card): for row- and
    column-driven steps, their count and the mean clock64 cycles a step of
    each of ``cuda_sart.PHASES`` over the blocks, as
    ``cuda_sart.resident_phases`` reads K8's. Counts in no launch count."""
    n, nt, ns = geom.n, geom.nray, x.shape[-1]
    if _check(x, b, geom, inv_row, inv_col_a, beta, order, mode, tables,
              MODES):
        raise ValueError("resident_phases times the kernel: pass CUDA "
                         "tensors")
    if e3_route(n, nt) != "resident":
        raise ValueError(f"E3 streams at N {n}, Nt {nt}: no resident "
                         f"phases")
    blocks = BAND_BLOCKS * -(-ns // CLUSTER_SLICES)
    prof = torch.zeros((blocks, 2, len(PHASES) + 1), dtype=torch.int64,
                       device=x.device)
    tabs = angle_tables(geom, x.device)
    out = torch.empty_like(x)
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_exp_sart_resident_phases(
        MODES.index(mode), p(x), p(tabs.fp), p(tabs.bp), p(b), p(inv_row),
        p(inv_col_a), p(beta), p(order), order.numel(), p(out),
        *_table_ptrs(mode, tables), n, nt, geom.nproj, ns, p(prof),
        _build.stream()), "tj_exp_sart_resident_phases")
    return phase_cycles(prof)


sart_variant.launches = 0
sart_resident.launches = 0
