"""Joseph projector kernels on the card, with their plain PyTorch versions.

Counterpart of ``tomojax/projector/pallas_joseph.py``. Layouts are
slice-last and unpadded: volumes ``(N, N, Ns)``, sinograms
``(Na, Nt, Ns)``, all float32 and contiguous.

* K1 ``fp_resid_sl`` (``csrc/joseph.cu`` ``fp_kernel<true>``): ``ax = A x``
  with the FISTA residual epilogue; ``fp_sl`` is the same kernel with the
  epilogue off (plain ``A x``). Both pass the geometry's `fp_plan`, the
  angle groups and staging windows of K1's blocks (E1,
  ``experiments/cuda_projector_variants.py``, walks the same plan with its
  own cap on the angles a group).
* K2 ``bp_sirt_sl`` (``csrc/joseph.cu`` ``bp_kernel<true>``): the SIRT
  update ``max(y_vol + inv_col * A^T r, 0)``; ``bp_sl`` is the same kernel
  with the epilogue off (plain ``A^T y``).
* K10 ``bp_sl`` / ``bp_sirt_sl`` with ``ab > 1`` (launched by
  ``bp_ab_sl``): K2's ``bp_kernel`` with ``ab`` angles a stage of its ring
  over the angle set padded to a multiple of ab, the reference's
  ``bp_pallas_sl(..., ab=)``; it equals K2 bit for bit. Where the ring
  and tables (`bp_smem_bytes`) exceed the card's shared memory per block,
  ``bp_ab_sl`` raises a ValueError.

The plain versions are the 2-point gathers of the reference's XLA
``gather`` mode (``tomojax/projector/joseph.py`` ``_fp_branch`` and
``_bp_impl``), the exact transpose pair, built from one-angle bodies
(``fp_angle_ref``, ``bp_angle_ref``) that the SART sweep's plain version
(``solvers/cuda_sart.py``) shares. A wrapper runs its plain version
only when its tensors lie on the CPU; on CUDA tensors it launches the
kernel or raises. Each wrapper counts its kernel launches in
``<wrapper>.launches``. The cached `angle_tables` and K1's plan count each
build (a cache miss) as ``plan_builds`` in the innermost open span of
``tomojax_torch.profiling``; each K1 launch (``fp_sl``, ``fp_resid_sl``)
counts there the angles it projects, ``fp_angles``, and its plan's angle
groups, ``fp_groups``, so their ratio is the angles a group of K1's blocks
shares (each group stages its own window of x).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tomojax_torch import _build, profiling
from tomojax_torch.geometry import Geometry

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AngleTables:
    """Per-angle constants of one geometry, (Na, 4) float32 each.

    fp: {1/denom, shear, 1/|denom|, row_driven} of the driving-axis walk
        (denom = cos and shear = -sin/cos for row-driven angles, denom =
        sin and shear = cos/sin for column-driven ones);
    bp: {cos, sin, 1/D, 0} of the closed form J* = x_c cos + y_r sin +
        (Nt-1)/2, D = max(|cos|, |sin|).
    Computed in float64 and rounded once to float32, so the kernels and
    the plain versions read the same numbers.
    """

    fp: torch.Tensor
    bp: torch.Tensor


@functools.lru_cache(maxsize=32)
def angle_tables(geom: Geometry, device: torch.device) -> AngleTables:
    profiling.count("plan_builds")  # the body runs on a cache miss only
    rd = geom.row_driven
    denom = np.where(rd, geom.cos, geom.sin)
    shear = np.where(rd, -geom.sin, geom.cos) / denom
    fp = np.stack([1.0 / denom, shear, 1.0 / np.abs(denom),
                   rd.astype(np.float64)], axis=1)
    bp = np.stack([geom.cos, geom.sin, 1.0 / geom.driving,
                   np.zeros(geom.nproj)], axis=1)
    return AngleTables(
        torch.as_tensor(fp.astype(np.float32), device=device),
        torch.as_tensor(bp.astype(np.float32), device=device),
    )


# K1's tiling (csrc/joseph.cu FP_G, FP_B, FP_K, FP_W): a block owns up to
# FP_GROUP angles of one driving type x FP_BINS bins x 32 slices and walks
# the driving axis FP_STEPS steps at a time, staging at most FP_WINDOW tap
# positions per step.
FP_GROUP, FP_BINS, FP_STEPS, FP_WINDOW = 8, 32, 2, 96


def fp_positions(tab: np.ndarray, n: int, nt: int, j, k) -> np.ndarray:
    """Tap positions of rays (bin j) at driving steps k for every angle of
    `tab` (float32 rows of ``angle_tables(...).fp``), rounded as
    ``tj::fp_ray`` (csrc/joseph.cuh) and K1 round them: each float32
    operation alone, in the same order. The result has a leading angle
    axis before the broadcast shape of j and k."""
    f32 = np.float32
    tab = np.asarray(tab, dtype=f32)
    lead = (len(tab),) + (1,) * max(np.ndim(j), np.ndim(k))
    inv_d, shear, row = (tab[:, i].reshape(lead) for i in (0, 1, 3))
    ctr = f32(0.5) * f32(n - 1)
    base = (np.asarray(j, dtype=f32) - f32(0.5) * f32(nt - 1)) * inv_d
    k = np.asarray(k, dtype=f32)
    with np.errstate(over="ignore"):
        row_pos = (base + (ctr - k) * shear) + ctr
        col_pos = (ctr - base) + (k - ctr) * shear
    return np.where(row != 0, row_pos, col_pos)


@dataclasses.dataclass(frozen=True)
class FpPlan:
    """K1's blocks for one geometry (`fp_plan`).

    groups: (ng, 2 + cap) int32 rows {row_driven, count, angles...}:
        consecutive angles of one driving type, at most cap (FP_GROUP for
        K1), whose rays of one bin tile fit one staging window of FP_WINDOW
        positions per chunk;
    windows: (ng, bin tiles, chunks, 2) int32 {lo, width}: the positions
        [lo, lo + width) that a block stages per step of a chunk, clamped to
        the volume plus two zero positions on each side. A tap at i0 is read
        at min(max(i0, lo), lo + width - 2), which moves only taps whose
        two positions both lie outside the volume onto zero positions.
    table: both flattened into one int32 tensor on the device, as tj_fp and
        tj_fp_resid take them.
    """

    groups: np.ndarray
    windows: np.ndarray
    table: torch.Tensor

    @property
    def ng(self) -> int:
        return len(self.groups)

    @property
    def width(self) -> int:
        """The widest window: the row stride of K1's staging ring."""
        return int(self.windows[..., 1].max())


def _fp_corner_windows(geom: Geometry, tab: np.ndarray):
    """(lo, hi) per (angle, bin tile, chunk): the least tap position
    floor(pos) and the largest floor(pos) + 1 over the tile's rays and the
    chunk's steps. pos is monotone in j and in k (each rounded operation
    is), so the extremes lie at the four corners."""
    n, nt = geom.n, geom.nray
    j0 = np.arange(0, nt, FP_BINS)
    k0 = np.arange(0, n, FP_STEPS)
    js = np.stack([j0, np.minimum(j0 + FP_BINS, nt) - 1])  # (2, tiles)
    ks = np.stack([k0, np.minimum(k0 + FP_STEPS, n) - 1])  # (2, chunks)
    pos = fp_positions(tab, n, nt, js[:, None, :, None],
                       ks[None, :, None, :])  # (Na, 2, 2, tiles, chunks)
    f = np.floor(pos.reshape(len(tab), 4, len(j0), len(k0)))
    return f.min(axis=1).astype(np.int64), f.max(axis=1).astype(np.int64) + 1


def _clamp_window(lo, hi, n: int):
    lo_eff = np.clip(lo, -2, n)
    return lo_eff, np.clip(hi, -1, n + 1) - lo_eff + 1


def fp_plan(geom: Geometry, device: torch.device,
            group: int = FP_GROUP) -> FpPlan:
    """K1's plan: angles grouped in table order, a new group at a change of
    driving type, at `group` angles (K1: FP_GROUP; E1: its ab), or where
    the next angle would widen some window past FP_WINDOW; then each
    group's windows. Group rows hold 2 + `group` ints."""
    return _fp_plan(geom, device, group)


@functools.lru_cache(maxsize=64)
def _fp_plan(geom: Geometry, device: torch.device, group: int) -> FpPlan:
    profiling.count("plan_builds")  # the body runs on a cache miss only
    tab = angle_tables(geom, torch.device("cpu")).fp.numpy()
    lo, hi = _fp_corner_windows(geom, tab)
    n = geom.n
    groups, windows = [], []
    members, cur_lo, cur_hi = [], None, None
    for a in range(geom.nproj):
        if members:
            nlo, nhi = np.minimum(cur_lo, lo[a]), np.maximum(cur_hi, hi[a])
            if (len(members) < group and tab[a, 3] == tab[members[0], 3]
                    and _clamp_window(nlo, nhi, n)[1].max() <= FP_WINDOW):
                members.append(a)
                cur_lo, cur_hi = nlo, nhi
                continue
            groups.append(members)
            windows.append(_clamp_window(cur_lo, cur_hi, n))
        members, cur_lo, cur_hi = [a], lo[a], hi[a]
    groups.append(members)
    windows.append(_clamp_window(cur_lo, cur_hi, n))
    g = np.zeros((len(groups), 2 + group), np.int32)
    for i, m in enumerate(groups):
        g[i, 0], g[i, 1] = int(tab[m[0], 3] != 0), len(m)
        g[i, 2:2 + len(m)] = m
    w = np.stack([np.stack(pair, axis=-1) for pair in windows]).astype(
        np.int32)
    flat = np.concatenate([g.ravel(), w.ravel()])
    return FpPlan(g, w, torch.as_tensor(flat, device=device))


# K2's tiling (csrc/joseph.cu BP_T, BP_W): a block owns a BP_TILE^2 tile of
# pixels x 32 slices and stages BP_WINDOW bins per angle.
BP_TILE, BP_WINDOW = 16, 24


def bp_jstar(tab: np.ndarray, nt: int, xc, yr) -> np.ndarray:
    """J* = x_c cos + y_r sin + (Nt-1)/2 for every angle of `tab` (float32
    rows of ``angle_tables(...).bp``) at pixel centres (xc, yr), rounded as
    ``tj::bp_jstar`` (csrc/joseph.cuh): each float32 operation alone. The
    result has a leading angle axis before the broadcast shape of xc, yr."""
    f32 = np.float32
    tab = np.asarray(tab, dtype=f32)
    lead = (len(tab),) + (1,) * max(np.ndim(xc), np.ndim(yr))
    c, s = (tab[:, i].reshape(lead) for i in (0, 1))
    off = f32(0.5) * f32(nt - 1)
    return (c * np.asarray(xc, f32) + s * np.asarray(yr, f32)) + off


def bp_window_lo(geom: Geometry) -> np.ndarray:
    """(Na, tiles, tiles) first staged bin of each (angle, tile row, tile
    column), as K2 computes it at the start of a block (csrc/joseph.cu
    bp_kernel): floor of the least J* over the four corners of the whole
    tile, pixels past N included. J* is monotone in x_c and y_r, so every
    tap of the tile lies in [lo, lo + BP_WINDOW)."""
    n = geom.n
    tab = angle_tables(geom, torch.device("cpu")).bp.numpy()
    ctr = np.float32(0.5) * np.float32(n - 1)
    t0 = np.arange(0, n, BP_TILE, dtype=np.float32)
    xs = np.stack([t0 - ctr, (t0 + (BP_TILE - 1)) - ctr])  # (2, tiles)
    ys = np.stack([ctr - t0, ctr - (t0 + (BP_TILE - 1))])
    j = bp_jstar(tab, geom.nray, xs[None, None, :, :], ys[:, :, None, None])
    # j: (Na, 2 y corners, row tiles, 2 x corners, column tiles)
    return np.floor(j.min(axis=(1, 3))).astype(np.int64)


def _hat_taps(pos: torch.Tensor, n: int):
    """Indices (clamped, safe to gather with) and masked linear weights of
    the two taps around `pos` (tomojax/projector/joseph.py _hat_weights)."""
    f = torch.floor(pos)
    frac = pos - f
    i0 = f.to(torch.int64)
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < n), 1.0 - frac, 0.0)
    w1 = torch.where((i1 >= 0) & (i1 < n), frac, 0.0)
    return i0.clamp(0, n - 1), i1.clamp(0, n - 1), w0, w1


# --------------------------------------------------------------- plain A x


def fp_angle_ref(x: torch.Tensor, t, n: int, nt: int) -> torch.Tensor:
    """One angle's ``A_a x``: (N, N, Ns) -> (Nt, Ns).

    The driving-axis walk of ``_fp_branch`` as one 2-tap gather over all
    driving steps: row-driven angles step over rows and interpolate two
    columns, column-driven angles step over columns and interpolate two
    rows; the sum is scaled by 1/D. t = (1/denom, shear, scale, row_driven)
    floats, a row of ``angle_tables(...).fp``; positions are rounded in
    the kernels' order."""
    inv_d, shear, scale, row_driven = t
    ctr = (n - 1) / 2.0
    steps = torch.arange(n, dtype=F32, device=x.device)
    base = (torch.arange(nt, dtype=F32, device=x.device)
            - (nt - 1) / 2.0) * inv_d  # (Nt,)
    if row_driven:
        pos = (base[None, :] + (ctr - steps)[:, None] * shear) + ctr
    else:
        pos = (ctr - base)[None, :] + (steps - ctr)[:, None] * shear
    i0, i1, w0, w1 = _hat_taps(pos, n)  # (N steps, Nt)
    k = torch.arange(n, device=x.device)[:, None]
    if row_driven:  # x[step, tap, s]
        v0, v1 = x[k, i0], x[k, i1]
    else:  # x[tap, step, s]
        v0, v1 = x[i0, k], x[i1, k]
    return (v0 * w0[..., None] + v1 * w1[..., None]).sum(0) * scale


def fp_sl_ref(x: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Plain ``A x``: (N, N, Ns) -> (Na, Nt, Ns), `fp_angle_ref` for every
    angle."""
    tab = angle_tables(geom, torch.device("cpu")).fp.tolist()
    return torch.stack([fp_angle_ref(x, t, geom.n, geom.nray) for t in tab])


def fp_resid_sl_ref(x, geom: Geometry, b, ax_old, inv_row, beta):
    """Plain K1: ``(ax, resid, ddsq)`` with ``ax = A x``,
    ``resid = (b - (ax + beta (ax - ax_old))) * inv_row`` and
    ``ddsq = sum (ax - b)^2`` (0-dim)."""
    ax = fp_sl_ref(x, geom)
    ay = ax + beta * (ax - ax_old)
    resid = (b - ay) * inv_row[:, :, None]
    r = ax - b
    return ax, resid, torch.sum(r * r)


# ------------------------------------------------------------- plain A^T y


def bp_angle_ref(ya: torch.Tensor, t, n: int, acc=0.0) -> torch.Tensor:
    """``acc`` plus one angle's ``A_a^T ya``: (Nt, Ns) -> (N, N, Ns).

    ``_bp_impl`` for one angle: J* = x_c cos + y_r sin + (Nt-1)/2 at every
    pixel and a 2-point gather at floor(J*), floor(J*)+1 with weights
    hat((j - J*)/D)/D. t = (cos, sin, 1/D, -) floats, a row of
    ``angle_tables(...).bp``."""
    c, s, invd = t[:3]
    nt = ya.shape[0]
    ctr = (n - 1) / 2.0
    xc = torch.arange(n, dtype=F32, device=ya.device) - ctr
    yr = ctr - torch.arange(n, dtype=F32, device=ya.device)
    jstar = c * xc[None, :] + s * yr[:, None] + (nt - 1) / 2.0  # (N, N)
    f = torch.floor(jstar)
    j0 = f.to(torch.int64)
    j1 = j0 + 1
    w0 = torch.clamp_min(1.0 - torch.abs(f - jstar) * invd, 0.0) * invd
    w1 = torch.clamp_min(1.0 - torch.abs((f + 1.0) - jstar) * invd,
                         0.0) * invd
    w0 = torch.where((j0 >= 0) & (j0 < nt), w0, 0.0)
    w1 = torch.where((j1 >= 0) & (j1 < nt), w1, 0.0)
    return (acc + ya[j0.clamp(0, nt - 1)] * w0[..., None]
            + ya[j1.clamp(0, nt - 1)] * w1[..., None])


def bp_sl_ref(y: torch.Tensor, geom: Geometry, ab: int = 1) -> torch.Tensor:
    """Plain ``A^T y``: (Na, Nt, Ns) -> (N, N, Ns), `bp_angle_ref` summed
    over the angles in order. With ab > 1 (K10's plain version) the angle
    set is padded to a multiple of ab with zero sinogram rows and zero
    table rows (1/D = 0), as ``bp_pallas_sl`` pads it; their taps add 0."""
    na = geom.nproj
    tab = angle_tables(geom, torch.device("cpu")).bp.tolist()
    tab += [[0.0] * 4] * (_round_up(na, ab) - na)
    acc = torch.zeros((geom.n, geom.n, y.shape[-1]), dtype=F32,
                      device=y.device)
    zero_row = torch.zeros_like(y[0])
    for a, t in enumerate(tab):
        acc = bp_angle_ref(y[a] if a < na else zero_row, t, geom.n, acc)
    return acc


def bp_sirt_sl_ref(resid, geom: Geometry, y_vol, inv_col, ab: int = 1):
    """Plain K2 (K10 with ab > 1): ``max(y_vol + inv_col * A^T resid,
    0)``."""
    return torch.clamp_min(
        y_vol + inv_col[:, :, None] * bp_sl_ref(resid, geom, ab), 0.0)


# ---------------------------------------------------------------- wrappers


def _p(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _count_groups(geom: Geometry, plan: FpPlan) -> None:
    """A K1 launch's angles and its plan's groups, in the innermost open
    span."""
    profiling.count("fp_angles", geom.nproj)
    profiling.count("fp_groups", plan.ng)


def fp_sl(x: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """``A x``: (N, N, Ns) -> (Na, Nt, Ns); K1 with the epilogue off."""
    ns = x.shape[-1]
    sino = (geom.nproj, geom.nray, ns)
    _build.check_operand(x, "x", (geom.n, geom.n, ns), F32)
    if _build.on_cpu(x):
        return fp_sl_ref(x, geom)
    tab = angle_tables(geom, x.device).fp
    plan = fp_plan(geom, x.device)
    ax = torch.empty(sino, dtype=F32, device=x.device)
    _build.check(_build.lib().tj_fp(
        _p(x), _p(tab), _p(plan.table), plan.ng, plan.width, _p(ax), geom.n,
        geom.nray, geom.nproj, ns, _build.stream()), "tj_fp")
    fp_sl.launches += 1
    _count_groups(geom, plan)
    return ax


def fp_resid_sl(x, geom: Geometry, b, ax_old, inv_row, beta):
    """K1: ``(ax, resid, ddsq)`` as `fp_resid_sl_ref` says.

    x (N, N, Ns); b and ax_old (Na, Nt, Ns); inv_row (Na, Nt); beta a
    0-dim float32 tensor on the same device (read there by the kernel).
    ddsq is a 0-dim tensor, summed on the device in a fixed order."""
    ns = x.shape[-1]
    sino = (geom.nproj, geom.nray, ns)
    _build.check_operand(x, "x", (geom.n, geom.n, ns), F32)
    _build.check_operand(b, "b", sino, F32)
    _build.check_operand(ax_old, "ax_old", sino, F32)
    _build.check_operand(inv_row, "inv_row", sino[:2], F32)
    _build.check_operand(beta, "beta", (), F32)
    if _build.on_cpu(x, b, ax_old, inv_row, beta):
        return fp_resid_sl_ref(x, geom, b, ax_old, inv_row, beta)
    lib = _build.lib()
    tab = angle_tables(geom, x.device).fp
    plan = fp_plan(geom, x.device)
    ax = torch.empty(sino, dtype=F32, device=x.device)
    resid = torch.empty(sino, dtype=F32, device=x.device)
    partials = torch.empty(lib.tj_fp_resid_partials(geom.nray, geom.nproj, ns),
                           dtype=F32, device=x.device)
    ddsq = torch.empty((), dtype=F32, device=x.device)
    _build.check(lib.tj_fp_resid(
        _p(x), _p(tab), _p(plan.table), plan.ng, plan.width, _p(b),
        _p(ax_old), _p(inv_row), _p(beta), _p(ax), _p(resid), _p(partials),
        _p(ddsq), geom.n, geom.nray, geom.nproj, ns, _build.stream()),
        "tj_fp_resid")
    fp_resid_sl.launches += 1
    _count_groups(geom, plan)
    return ax, resid, ddsq


AB_MAX = 32  # largest stage K10 takes (csrc/joseph.cu AB_MAX)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _check_ab(ab) -> None:
    if (isinstance(ab, bool) or not isinstance(ab, int)
            or not 1 <= ab <= AB_MAX):
        raise ValueError(f"ab must be an int in [1, {AB_MAX}], got {ab!r}")


def _bp_launch(y, geom: Geometry, y_vol, inv_col):
    ns = y.shape[-1]
    tab = angle_tables(geom, y.device).bp
    out = torch.empty((geom.n, geom.n, ns), dtype=F32, device=y.device)
    _build.check(_build.lib().tj_bp(
        _p(y), _p(tab), _p(y_vol), _p(inv_col), _p(out), geom.n, geom.nray,
        geom.nproj, ns, _build.stream()), "tj_bp")
    return out


def bp_smem_bytes(na: int, stage: int) -> int:
    """Shared memory of one block of K2's kernel (csrc/joseph.cu bp_smem):
    the double-buffered ring of `stage` angles x BP_WINDOW bins x 32
    slices, then a float4 table entry and an int window start for each of
    the na angles rounded up to `stage`."""
    return 2 * stage * BP_WINDOW * 32 * 4 + _round_up(na, stage) * 20


def bp_ab_sl(y, geom: Geometry, ab: int, y_vol=None, inv_col=None):
    """K10's launch on CUDA operands that `bp_sl` / `bp_sirt_sl` checked:
    K2's kernel (and, with y_vol and inv_col, its epilogue) with `ab`
    angles a stage. Raises a ValueError where the block's shared memory
    exceeds the card's limit. Counts in ``bp_ab_sl.launches``."""
    need, limit = bp_smem_bytes(geom.nproj, ab), _build.lib().tj_smem_limit()
    if need > limit:
        raise ValueError(
            f"K10 at ab={ab} with {geom.nproj} angles needs {need} bytes of "
            f"shared memory per block; the card allows {limit} "
            f"(cudaDevAttrMaxSharedMemoryPerBlockOptin)")
    ns = y.shape[-1]
    tab = angle_tables(geom, y.device).bp
    out = torch.empty((geom.n, geom.n, ns), dtype=F32, device=y.device)
    _build.check(_build.lib().tj_bp_ab(
        _p(y), _p(tab), _p(y_vol), _p(inv_col), _p(out), geom.n, geom.nray,
        geom.nproj, ns, ab, _build.stream()), "tj_bp_ab")
    bp_ab_sl.launches += 1
    return out


def bp_sl(y: torch.Tensor, geom: Geometry, ab: int = 1) -> torch.Tensor:
    """``A^T y``: (Na, Nt, Ns) -> (N, N, Ns); K2 with the epilogue off, or
    K10 with ab > 1 (the angles taken ab at a time, the same result)."""
    _check_ab(ab)
    ns = y.shape[-1]
    _build.check_operand(y, "y", (geom.nproj, geom.nray, ns), F32)
    if _build.on_cpu(y):
        return bp_sl_ref(y, geom, ab)
    if ab > 1:
        return bp_ab_sl(y, geom, ab)
    out = _bp_launch(y, geom, None, None)
    bp_sl.launches += 1
    return out


def bp_sirt_sl(resid, geom: Geometry, y_vol, inv_col, ab: int = 1):
    """K2: ``max(y_vol + inv_col * A^T resid, 0)``; K10 with ab > 1.

    resid (Na, Nt, Ns); y_vol (N, N, Ns); inv_col (N, N), the SIRT column
    weights shared by every slice (or any (N, N) scale, such as the
    constant -lam/L of the Poisson-ML step)."""
    _check_ab(ab)
    ns = resid.shape[-1]
    vol = (geom.n, geom.n, ns)
    _build.check_operand(resid, "resid", (geom.nproj, geom.nray, ns), F32)
    _build.check_operand(y_vol, "y_vol", vol, F32)
    _build.check_operand(inv_col, "inv_col", vol[:2], F32)
    if _build.on_cpu(resid, y_vol, inv_col):
        return bp_sirt_sl_ref(resid, geom, y_vol, inv_col, ab)
    if ab > 1:
        return bp_ab_sl(resid, geom, ab, y_vol, inv_col)
    out = _bp_launch(resid, geom, y_vol, inv_col)
    bp_sirt_sl.launches += 1
    return out


fp_sl.launches = 0
fp_resid_sl.launches = 0
bp_sl.launches = 0
bp_sirt_sl.launches = 0
bp_ab_sl.launches = 0
