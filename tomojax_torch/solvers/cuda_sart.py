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
the same taps.

``csrc/sart.cu`` has two routes, chosen by the shape alone (`sart_shape`,
which ``tj_sart_route`` mirrors; `sart_route` names the route):

* resident, where one block's share fits the card's shared memory
  (`shape_fits`) at a cluster shape of `K8_SHAPES`, the first that fits:
  (8, 4) for N <= 288 at Nt = N, (16, 2) for 289 <= N <= 528, (16, 1) in
  the spilling layout for 529 <= N <= 1052. One launch a sweep. A
  thread-block cluster of `blocks` blocks keeps `slices` slices of the
  volume in shared memory for the whole sweep, block r the rows
  [r R, (r + 1) R), R = `band_rows` (N, blocks); per step each block sums
  every ray's taps in its own rows (column-driven angles over the steps of
  `column_steps`), the partials are added in block order through
  distributed shared memory, and each block updates its rows
  (``csrc/sart_resident.cuh``, which the experiment sweeps E3/E4 share).
  The spilling layout (`K8_SPILL`) reads inv_col_a from device memory and
  keeps the band's rows past `held_rows` in a device scratch
  (`spill_rows` a block: 13 of 64 at N = 1024) while at most a quarter of
  a band spills;
* streaming otherwise (N above 1052 at Nt = N): two launches a step, the
  volume in device memory.

Only the resident FP's sum order differs (the ray as band partials added
in block order), so its result is within rounding of the plain version's,
not bit-equal; the update is the same arithmetic. ``sart_sweep_sl`` runs
the plain version only when its tensors lie on the CPU; on CUDA tensors it
launches ``csrc/sart.cu`` or raises, and a resident launch that fails
raises rather than take the other route. One call is one sweep. On the
card it runs inside the span ``solvers.sart`` and counts its kernel
launches (1 on the resident route, 2 a step on the streaming one) in
the counter ``sart_launches`` and in ``sart_sweep_sl.launches``, and the
band rows a block keeps in device memory (`route_spill_rows`) in the
counter ``sart_spill_rows``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tomojax_torch import _build, profiling
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import (
    angle_tables, bp_angle_ref, fp_angle_ref,
)

F32 = torch.float32
# the resident route's cluster shapes (csrc/sart.cu R_SHAPES), (blocks a
# cluster, slices a pixel) in the order the route tries them, and whether
# each runs the spilling layout; the first is also E3's (csrc/exp_sart.cu
# E_BLOCKS, E_SLICES) and the default of the shape arguments below
K8_SHAPES = ((8, 4), (16, 2), (16, 1))
K8_SPILL = (False, False, True)
BAND_BLOCKS, CLUSTER_SLICES = K8_SHAPES[0]
# csrc/sart_resident.cuh RESIDENT_SMEM_MAX, STEP_SLACK, R_PAD: the shared
# memory of one block on an H100 (opt-in), the margin of the column-driven
# step range (2^-20 positions per unit of 2N + Nt + 8), and the pixels
# after each band row
RESIDENT_SMEM_MAX = 232448
STEP_SLACK = 2.0 ** -20
BAND_PAD = 4


def band_rows(n: int, blocks: int = BAND_BLOCKS) -> int:
    """Rows of the volume each block of a resident cluster of `blocks`
    holds."""
    return -(-n // blocks)


def held_rows(n: int, nt: int, blocks: int, sb: int) -> int:
    """Rows of its band that a block of the spilling layout keeps in shared
    memory: as many as fit beside its partials, residual, b[a] and
    inv_row[a], at most the band (csrc/sart_resident.cuh held_rows)."""
    room = RESIDENT_SMEM_MAX - nt * (16 * sb + 4)
    return min(max(room, 0) // ((n + BAND_PAD) * 4 * sb), band_rows(n, blocks))


def resident_smem_bytes(n: int, nt: int, blocks: int = BAND_BLOCKS,
                        sb: int = CLUSTER_SLICES, spill: bool = False) -> int:
    """Shared memory of one block of the resident sweep with `blocks`
    blocks a cluster and `sb` slices a pixel (csrc/sart_resident.cuh
    resident_smem; K8 takes the defaults): its rows of x (rows of N +
    `BAND_PAD` pixels of sb floats) and of inv_col_a[a] (floats), the
    double-buffered partials, the residual plane and b[a] (4 pixels a bin)
    and inv_row[a] (a float a bin). The spilling layout (`spill`) holds
    `held_rows` rows of x and no inv_col_a."""
    bins = nt * (16 * sb + 4)
    if spill:
        return held_rows(n, nt, blocks, sb) * (n + BAND_PAD) * 4 * sb + bins
    rows = band_rows(n, blocks)
    return rows * (n + BAND_PAD) * 4 * sb + rows * n * 4 + bins


def shape_fits(n: int, nt: int, blocks: int, sb: int,
               spill: bool = False) -> bool:
    """Whether a block of the resident sweep with `blocks` blocks a cluster
    and `sb` slices a pixel fits at N, Nt (csrc/sart_resident.cuh
    resident_fits): its shared memory within the card's; in the spilling
    layout, at least one row held and at most a quarter of the band
    spilled."""
    if spill:
        rows, held = band_rows(n, blocks), held_rows(n, nt, blocks, sb)
        return held > 0 and 4 * (rows - held) <= rows
    return resident_smem_bytes(n, nt, blocks, sb) <= RESIDENT_SMEM_MAX


def _route_shape(n: int, nt: int):
    return next(((shape, spill) for shape, spill in zip(K8_SHAPES, K8_SPILL)
                 if shape_fits(n, nt, *shape, spill)), (None, False))


def sart_shape(n: int, nt: int) -> tuple[int, int] | None:
    """The cluster shape (blocks, slices) of `K8_SHAPES` that
    ``tj_sart_sweep`` runs at this shape, the first that fits
    (`shape_fits`, in the layout of `K8_SPILL`), or None where none fits
    (the streaming route)."""
    return _route_shape(n, nt)[0]


def route_spill_rows(n: int, nt: int) -> int:
    """The band rows a block of ``tj_sart_sweep`` keeps in device memory
    at this shape (``tj_sart_spill_rows``): the band's rows past
    `held_rows` on the spilling shape, 0 on the other shapes and on the
    streaming route."""
    shape, spill = _route_shape(n, nt)
    if not spill:
        return 0
    return band_rows(n, shape[0]) - held_rows(n, nt, *shape)


def sart_route(n: int, nt: int) -> str:
    """'resident' where `sart_shape` finds a shape, else 'streaming': the
    route ``tj_sart_sweep`` takes at this shape."""
    return "streaming" if sart_shape(n, nt) is None else "resident"


def column_steps(u, shear: float, n: int, nt: int, r0: int, r1: int):
    """The steps [k0, k1) in which a resident block with rows [r0, r1)
    walks a column-driven ray, for rays of ``u = (N-1)/2 - base`` (a
    float32 array) and the angle's shear: the closed form of
    csrc/sart_resident.cuh column_steps, each float32 operation rounded
    alone in the kernel's order. pos(k) = u + (k - (N-1)/2) shear is monotone in k and a
    tap row lies in the band when pos lies in [r0 - 1, r1); the ends are
    widened by 2 steps plus the rounding of pos over |shear|. Returns two
    int64 arrays of u's shape."""
    f32 = np.float32
    u = np.asarray(u, f32)
    zero = np.zeros(u.shape, np.int64)
    if r0 >= r1:
        return zero, zero
    sh = f32(shear)
    if sh == 0:
        inside = (u >= f32(r0 - 1)) & (u < f32(r1))
        return zero, np.where(inside, n, 0).astype(np.int64)
    ctr = f32(0.5) * f32(n - 1)
    # np.fmin/np.fmax drop a NaN operand, as fminf/fmaxf do
    with np.errstate(over="ignore", invalid="ignore"):
        ta = (f32(r0 - 1) - u) / sh
        tb = (f32(r1) - u) / sh
        slack = f32(STEP_SLACK) * f32(2 * n + nt + 8)
        m = f32(2) + slack / abs(sh)
        lo = (ctr + np.fmin(ta, tb)) - m
        hi = (ctr + np.fmax(ta, tb)) + m
    k0 = np.fmin(np.fmax(np.floor(lo), f32(0)), f32(n))
    k1 = np.fmin(np.fmax(np.ceil(hi) + f32(1), f32(0)), f32(n))
    return k0.astype(np.int64), k1.astype(np.int64)


def _resident_shape(n: int, nt: int) -> tuple[int, int]:
    shape = sart_shape(n, nt)
    if shape is None:
        raise ValueError(f"K8 streams at N {n}, Nt {nt}: no resident launch")
    return shape


def resident_clusters(n: int, nt: int, ns: int) -> dict:
    """The resident route's launch at this shape on the current card: its
    cluster shape (`sart_shape`: blocks a cluster, slices a pixel), clusters
    (one per `slices` slices), how many the card holds at once
    (cudaOccupancyMaxActiveClusters), the waves that makes, the shared
    memory of a block and the band rows it spills. Raises where K8
    streams."""
    blocks, slices = _resident_shape(n, nt)
    spill = K8_SPILL[K8_SHAPES.index((blocks, slices))]
    active = ctypes.c_int(0)
    _build.check(_build.lib().tj_sart_active_clusters(
        n, nt, ns, ctypes.byref(active)), "tj_sart_active_clusters")
    clusters = -(-ns // slices)
    return {"blocks": blocks, "slices": slices, "clusters": clusters,
            "active": active.value,
            "waves": -(-clusters // max(active.value, 1)),
            "smem": resident_smem_bytes(n, nt, blocks, slices, spill),
            "spill_rows": route_spill_rows(n, nt)}


def _checked_on_cpu(x, b, geom: Geometry, inv_row, inv_col_a, beta,
                    order) -> bool:
    """Raise unless the operands are as `sart_sweep_sl` takes them; True
    when they all lie on the CPU, False when all lie on the card."""
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
    return _build.on_cpu(x, b, inv_row, inv_col_a, beta, order)


PHASES = ("copy issue", "FP", "copy wait + cluster barrier", "residual",
          "update")  # csrc/sart_resident.cuh R_PHASES


def resident_phases(x, b, geom: Geometry, inv_row, inv_col_a, beta,
                    order, serial_fp: bool = False, out=None) -> dict:
    """One resident sweep on the card with its phases timed (the kernel's
    PROF instantiation; operands as `sart_sweep_sl`'s, on the card): for
    row- and column-driven steps, their count and the mean clock64 cycles
    a step of each of `PHASES` over the blocks (thread 0 of each; the FP
    ends at a block barrier of its own), at the cluster shape of
    `sart_shape`. `serial_fp`: the spilling shape's FP walks the rays of
    a row-driven angle one after another instead of four together (the
    other shapes always do). `out`, where given (x's shape, on the card), takes the
    sweep's result. Raises where K8 streams. Counts in no launch count."""
    if _checked_on_cpu(x, b, geom, inv_row, inv_col_a, beta, order):
        raise ValueError("resident_phases times the kernel: pass CUDA "
                         "tensors")
    n, nt, na, ns = geom.n, geom.nray, geom.nproj, x.shape[-1]
    per_cluster, slices = _resident_shape(n, nt)
    blocks = per_cluster * -(-ns // slices)
    prof = torch.zeros((blocks, 2, len(PHASES) + 1), dtype=torch.int64,
                       device=x.device)
    tabs = angle_tables(geom, x.device)
    scratch = _scratch(n, nt, ns, x.device)
    if out is None:
        out = torch.empty_like(x)
    _build.check_operand(out, "out", x.shape, F32)
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_sart_resident_phases(
        p(x), p(tabs.fp), p(tabs.bp), p(b), p(inv_row), p(inv_col_a),
        p(beta), p(order), order.numel(),
        None if scratch is None else p(scratch), p(out), n, nt, na, ns,
        p(prof), int(serial_fp), _build.stream()), "tj_sart_resident_phases")
    return phase_cycles(prof)


def phase_cycles(prof: torch.Tensor) -> dict:
    """The (blocks, 2, len(PHASES) + 1) int64 counters of a timed resident
    sweep as {row-driven, column-driven: {steps, mean cycles a step of
    each phase over the blocks}}."""
    cycles = prof.cpu().double()
    res = {}
    for i, kind in enumerate(("row-driven", "column-driven")):
        steps = int(cycles[0, i, -1])
        res[kind] = {"steps": steps, **{
            name: float(cycles[:, i, q].mean()) / max(steps, 1)
            for q, name in enumerate(PHASES)}}
    return res


def _scratch(n: int, nt: int, ns: int, device) -> torch.Tensor | None:
    """``tj_sart_sweep``'s scratch at this shape: the streaming route's
    (Nt, Ns) residual plane, the spilling shape's (Ns, blocks,
    `route_spill_rows`, N) band rows, else None."""
    shape = sart_shape(n, nt)
    if shape is None:
        return torch.empty((nt, ns), dtype=F32, device=device)
    spilled = route_spill_rows(n, nt)
    if spilled == 0:
        return None
    return torch.empty((ns, shape[0], spilled, n), dtype=F32, device=device)


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
    """K8: `sart_sweep_sl_ref` on the card, on the route of `sart_route`.

    x (N, N, Ns); b (Na, Nt, Ns); inv_row (Na, Nt) = System.inv_row;
    inv_col_a (Na, N, N) per-angle column weights
    (``iterative.make_sart_weights``); beta a 0-dim float32 tensor and
    order a contiguous int32 (K,) tensor, both on x's device and read there
    by the kernel. Entries of order must lie in [0, Na): the plain version
    raises on others, the kernel leaves x unchanged for them."""
    if _checked_on_cpu(x, b, geom, inv_row, inv_col_a, beta, order):
        return sart_sweep_sl_ref(x, b, geom, inv_row, inv_col_a, beta, order)
    ns = x.shape[-1]
    n, nt, na = geom.n, geom.nray, geom.nproj
    route = sart_route(n, nt)
    with profiling.annotate("solvers.sart"):
        tabs = angle_tables(geom, x.device)
        scratch = _scratch(n, nt, ns, x.device)
        out = torch.empty_like(x)
        p = torch.Tensor.data_ptr
        _build.check(_build.lib().tj_sart_sweep(
            p(x), p(tabs.fp), p(tabs.bp), p(b), p(inv_row), p(inv_col_a),
            p(beta), p(order), order.numel(),
            None if scratch is None else p(scratch), p(out), n, nt, na, ns,
            _build.stream()), "tj_sart_sweep")
        # csrc/sart.cu: resident_sweep launches once, streaming_sweep
        # sart_fp_kernel and sart_update_kernel once a step
        launches = 1 if route == "resident" else 2 * order.numel()
        profiling.count("sart_launches", launches)
        profiling.count("sart_spill_rows", route_spill_rows(n, nt))
    sart_sweep_sl.launches += launches
    return out


sart_sweep_sl.launches = 0
