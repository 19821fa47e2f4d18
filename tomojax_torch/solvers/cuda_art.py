"""ART sweep kernel A1 on the card, with its plain PyTorch version.

Counterpart of ``tomojax/solvers/iterative.py:art_sweep``: the true
Kaczmarz sweep over single rays (the reference's CPU engine feature,
ctvlib.cpp:137-191). The reference runs it as an XLA ``lax.scan`` of one
ray a step; it is no Pallas kernel, so A1 replaces no TPU kernel, only a
loop that costs about 20 launches a ray in plain PyTorch. Slice-last:
x (N, N, Ns), b (Na, Nt, Ns). For k = 0, 1, ... with ray r = order[k]
(angle a = r // Nt, bin j = r % Nt), per slice:

    dot   = <a_r, x>,  nsq = ||a_r||^2
    coeff = beta (b[a, j] - dot) / max(nsq, 1e-12)
    x    += coeff a_r          (the first taps of every step, then the
                                second taps, as the reference scatters)

with a_r the ray's Joseph row as the reference builds it in the scan body:
N steps along the driving axis, two hat taps a step scaled by
1/max(|cos| or |sin|, 1e-8), out-of-range taps weighted 0 and clipped.

``art_sweep_sl`` runs the plain version ``art_sweep_sl_ref`` only when
its tensors lie on the CPU; on CUDA tensors it launches ``csrc/art.cu``
(one launch a sweep, counted in ``art_sweep_sl.launches``) or raises.
The kernel rounds the positions, the weights and the updates as the plain
version does; only its sums of dot and nsq run in another (fixed) order,
so the two agree within rounding, and two kernel sweeps bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tomojax_torch import _build
from tomojax_torch.geometry import Geometry

F32 = torch.float32
ART_SLICES = 8  # slices a block of A1 (csrc/art.cu takes 1, 2, 4, 8, 16)
SLICES = (1, 2, 4, 8, 16)
STEPS_A_THREAD = 8  # csrc/art.cu A_K
MAX_WARPS = 16  # csrc/art.cu A_MAXW


def art_max_n(slices: int = ART_SLICES) -> int:
    """The largest N A1 takes with `slices` slices a block (tj_art_max_n):
    16 warps of 32 / slices step groups, 8 steps a thread."""
    if slices not in SLICES:
        raise ValueError(f"slices {slices}: A1 takes one of {SLICES}")
    return MAX_WARPS * (32 // slices) * STEPS_A_THREAD


def art_slices(n: int) -> int:
    """The slices a block A1 takes at image side n: `ART_SLICES`, or the
    most that still take n (`art_max_n`); raises above every
    instantiation's N."""
    for sl in sorted((s for s in SLICES if s <= ART_SLICES), reverse=True):
        if n <= art_max_n(sl):
            return sl
    raise ValueError(f"A1 takes N <= {art_max_n(min(SLICES))}, not {n}")


@functools.lru_cache(maxsize=16)
def art_table(geom: Geometry, device: torch.device) -> torch.Tensor:
    """(Na, 4) float32 {cos, sin, row_driven, 0} on `device`, the angle
    table A1 reads (the cosines and sines of ``Geometry`` rounded to
    float32, as the reference's scan body takes them)."""
    tab = np.stack([geom.cos, geom.sin, geom.row_driven.astype(np.float64),
                    np.zeros(geom.nproj)], axis=1)
    return torch.as_tensor(tab.astype(np.float32), device=device)


def art_taps(geom: Geometry, device):
    """Every ray's row of the Joseph operator as the reference's ART scan
    builds it: (p0, p1, w0, w1, nsq) with p0, p1 (Na Nt, N) int64 pixel
    indices row * N + column of the two taps of each step, w0, w1 their
    float32 weights and nsq (Na Nt,) = sum of w0^2 + w1^2, in the
    reference's float32 arithmetic and order (tomojax/solvers/iterative.py
    art_sweep's body, batched over the rays)."""
    n, nt, na = geom.n, geom.nray, geom.nproj
    tab = art_table(geom, torch.device(device))
    c, s = tab[:, 0, None, None], tab[:, 1, None, None]
    rd = (tab[:, 2] != 0)[:, None, None]
    ctr = (n - 1) / 2.0
    steps = torch.arange(n, dtype=F32, device=tab.device)[None, None, :]
    tj = (torch.arange(nt, dtype=F32, device=tab.device)
          - (nt - 1) / 2.0)[None, :, None]
    safe_c = torch.where(c.abs() < 1e-8, 1.0, c)
    safe_s = torch.where(s.abs() < 1e-8, 1.0, s)
    pos_row = tj / safe_c + (ctr - steps) * (-s / safe_c) + ctr
    pos_col = ctr - tj / safe_s + (steps - ctr) * (c / safe_s)
    pos = torch.where(rd, pos_row, pos_col)
    scale = 1.0 / torch.clamp_min(torch.where(rd, c, s).abs(), 1e-8)
    f = torch.floor(pos)
    frac = pos - f
    i0 = f.to(torch.int64)
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < n), 1.0 - frac, 0.0) * scale
    w1 = torch.where((i1 >= 0) & (i1 < n), frac, 0.0) * scale
    m = steps.to(torch.int64)

    def pixel(i):
        i = i.clamp(0, n - 1)
        return torch.where(rd, m * n + i, i * n + m).reshape(na * nt, n)

    nsq = (w0 * w0 + w1 * w1).sum(-1).reshape(na * nt)
    return (pixel(i0), pixel(i1), w0.reshape(na * nt, n),
            w1.reshape(na * nt, n), nsq)


def _checked_on_cpu(x, b, geom: Geometry, order, slices) -> bool:
    """Raise unless the operands are as `art_sweep_sl` takes them; True
    when they all lie on the CPU, False when all lie on the card."""
    ns = x.shape[-1]
    n, nt, na = geom.n, geom.nray, geom.nproj
    _build.check_operand(x, "x", (n, n, ns), F32)
    _build.check_operand(b, "b", (na, nt, ns), F32)
    if order.dim() != 1 or order.numel() == 0:
        raise ValueError(f"order: shape {tuple(order.shape)}, expected (K,) "
                         f"with K >= 1")
    _build.check_operand(order, "order", order.shape, torch.int32)
    if slices is None:
        art_slices(n)
    elif n > art_max_n(slices):
        raise ValueError(f"A1 with {slices} slices a block takes N <= "
                         f"{art_max_n(slices)}, not {n}")
    return _build.on_cpu(x, b, order)


def art_sweep_sl_ref(x, b, geom: Geometry, beta, order):
    """Plain A1: one Kaczmarz pass over the rays of ``order`` (an int (K,)
    tensor of ray indices a * Nt + j); returns the new (N, N, Ns) volume.
    Raises on an entry outside [0, Na Nt)."""
    n, ns = geom.n, x.shape[-1]
    rays = geom.nproj * geom.nray
    p0, p1, w0, w1, nsq = art_taps(geom, x.device)
    nsq = torch.clamp_min(nsq, 1e-12)
    xf = x.reshape(n * n, ns).clone()
    bf = b.reshape(rays, ns)
    for r in order.tolist():
        if not 0 <= r < rays:
            raise ValueError(f"order entry {r} outside [0, {rays})")
        q0, q1 = p0[r], p1[r]
        u0, u1 = w0[r][:, None], w1[r][:, None]
        dot = (xf[q0] * u0 + xf[q1] * u1).sum(0)
        coeff = beta * (bf[r] - dot) / nsq[r]
        xf.index_add_(0, q0, u0 * coeff)
        xf.index_add_(0, q1, u1 * coeff)
    return xf.reshape(n, n, ns)


def art_sweep_sl(x, b, geom: Geometry, beta, order, slices=None):
    """A1: `art_sweep_sl_ref` on the card, one launch a sweep.

    x (N, N, Ns); b (Na, Nt, Ns); beta a float; order a contiguous int32
    (K,) tensor of rays on x's device, read there by the kernel (K >= 1).
    Entries must lie in [0, Na Nt): the plain version raises on others,
    the kernel skips them. slices: slices a block, one of `SLICES` (the
    kernel's instantiations; N <= `art_max_n(slices)`), by default
    `art_slices(N)`. Returns a new volume."""
    if _checked_on_cpu(x, b, geom, order, slices):
        return art_sweep_sl_ref(x, b, geom, beta, order)
    n, nt, na, ns = geom.n, geom.nray, geom.nproj, x.shape[-1]
    if slices is None:
        slices = art_slices(n)
    out = x.clone()
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_art_sweep(
        p(out), p(b), p(art_table(geom, x.device)), p(order), order.numel(),
        float(beta), n, nt, na, ns, slices, _build.stream()), "tj_art_sweep")
    art_sweep_sl.launches += 1
    return out


art_sweep_sl.launches = 0
