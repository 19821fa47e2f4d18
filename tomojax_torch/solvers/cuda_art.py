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
Both compute their taps from one table (`art_table`: per ray t_j / the
angle's divisor, sh, scale, the driving axis). The kernel rounds the
positions, the weights and the updates as the plain version does; only
its sums of dot and nsq run in another (fixed) order, so the two agree
within rounding, and two kernel sweeps bit for bit.

The kernel's schedule (csrc/art.cu): a step of ray r + 1 that keeps r's
driving axis belongs to the thread that held it in r, so the pixels the
two rays share (clipped taps included) pass in registers and the others
are loaded while r reduces; a pixel that r + 1 carries is stored by the
ray that lets it go. `art_variant` and `art_phases` split a ray's time
on the card (chip_smoke.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tomojax_torch import _build
from tomojax_torch.geometry import Geometry

F32 = torch.float32
ART_SLICES = 2  # slices a block of A1 (csrc/art.cu takes 1, 2, 4, 8, 16)
SLICES = (1, 2, 4, 8, 16)


def art_config(slices: int) -> tuple:
    """(VS, L, Q, KS, KL, W) of A1 with `slices` slices a block
    (csrc/art.cuh Cfg): slices a thread, threads a step group, step groups
    a warp, steps a thread where N allows it (KS) and above (KL), warps a
    block at most."""
    if slices not in SLICES:
        raise ValueError(f"slices {slices}: A1 takes one of {SLICES}")
    vs = min(slices, 4)
    lanes = slices // vs
    return (vs, lanes, 32 // lanes, 1 if slices <= 4 else 2,
            8 if slices == 1 else 4, 16 if slices <= 2 else 8)


def art_max_n(slices: int = ART_SLICES) -> int:
    """The largest N A1 takes with `slices` slices a block (tj_art_max_n):
    W warps of Q step groups, KL steps each (`art_config`)."""
    _, _, q, _, kl, w = art_config(slices)
    return w * q * kl


def art_groups(n: int, slices: int) -> int:
    """G, the step groups of one A1 block at image side n: step m belongs
    to group m % G (`art_config`: Q a warp, as many warps as n needs at KS
    steps a thread, or at KL above W warps)."""
    _, _, q, ks, kl, w = art_config(slices)
    warps = -(-n // (q * ks))
    return q * (warps if warps <= w else -(-n // (q * kl)))


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
    """(Na Nt, 4) float32 {t1, sh, scale, row_driven} per ray a * Nt + j
    on `device`, the table A1 reads and the plain version (`art_taps`)
    computes its taps from. With c, s the angle's cosine and sine rounded
    to float32 (as the reference's scan body takes them) and c', s' those
    below 1e-8 in magnitude replaced by 1: t1 = t_j / c' and sh = -s / c'
    (row-driven) or t_j / s' and c / s' (column-driven), t_j = j - (Nt -
    1) / 2, scale = 1 / max(|c| or |s|, 1e-8), each one float32 operation,
    computed once on the CPU."""
    c = torch.as_tensor(geom.cos.astype(np.float32))[:, None]
    s = torch.as_tensor(geom.sin.astype(np.float32))[:, None]
    rd = torch.as_tensor(geom.row_driven)[:, None]
    safe_c = torch.where(c.abs() < 1e-8, 1.0, c)
    safe_s = torch.where(s.abs() < 1e-8, 1.0, s)
    tj = (torch.arange(geom.nray, dtype=F32) - (geom.nray - 1) / 2.0)[None]
    t1 = tj / torch.where(rd, safe_c, safe_s)
    sh = torch.where(rd, -s / safe_c, c / safe_s).expand_as(t1)
    scale = (1.0 / torch.clamp_min(torch.where(rd, c, s).abs(), 1e-8)
             ).expand_as(t1)
    tab = torch.stack([t1, sh, scale, rd.to(F32).expand_as(t1)], dim=-1)
    return tab.reshape(geom.nproj * geom.nray, 4).contiguous().to(device)


def art_taps(geom: Geometry, device):
    """Every ray's row of the Joseph operator as the reference's ART scan
    builds it: (p0, p1, w0, w1, nsq) with p0, p1 (Na Nt, N) int64 pixel
    indices row * N + column of the two taps of each step, w0, w1 their
    float32 weights and nsq (Na Nt,) = sum of w0^2 + w1^2, in the
    reference's float32 arithmetic and order (tomojax/solvers/iterative.py
    art_sweep's body, batched over the rays): pos = t1 + (ctr - m) sh +
    ctr (row-driven) or ctr - t1 + (m - ctr) sh, from `art_table`."""
    n, nt, na = geom.n, geom.nray, geom.nproj
    tab = art_table(geom, torch.device(device)).reshape(na, nt, 4)
    t1, sh = tab[..., 0, None], tab[..., 1, None]
    scale = tab[..., 2, None]
    rd = tab[..., 3, None] != 0
    ctr = (n - 1) / 2.0
    steps = torch.arange(n, dtype=F32, device=tab.device)[None, None, :]
    pos_row = t1 + (ctr - steps) * sh + ctr
    pos_col = ctr - t1 + (steps - ctr) * sh
    pos = torch.where(rd, pos_row, pos_col)
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


def mixed_order(na: int, nt: int, run: int = 3) -> np.ndarray:
    """A permutation of the Na Nt rays that jumps between two angles every
    `run` bins: angles a and a + ceil(Na / 2) in turns, for each a below
    ceil(Na / 2). Over a symmetric tilt range the pairs mix jumps that keep
    the driving axis (A1 carries the next ray) with jumps that change it (a
    full fetch after a barrier); chip_smoke.py and the tests hold A1 to it.
    """
    half = (na + 1) // 2
    out = []
    for a in range(half):
        pair = [a] + ([a + half] if a + half < na else [])
        for j0 in range(0, nt, run):
            for p in pair:
                out.extend(p * nt + j for j in range(j0, min(j0 + run, nt)))
    return np.asarray(out, dtype=np.int32)


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
        float(beta), n, nt * na, ns, slices, _build.stream()),
        "tj_art_sweep")
    art_sweep_sl.launches += 1
    return out


art_sweep_sl.launches = 0

# A1's variants (csrc/art.cuh Variant bits) and the PROF bit
VARIANTS = {"FULL": 0, "NOLOAD": 1, "NORED": 2, "NOSTORE": 4, "NOPREF": 8,
            "CHAIN": 1 | 4 | 8}
PROF = 16
PHASES = ("staging", "full fetch", "dot and butterfly",
          "next ray's taps and loads", "barrier", "block sum", "L2 prefetch",
          "coefficient and update")  # csrc/art.cuh A_PHASES


def _variant(x, b, geom: Geometry, beta, order, index: int, slices, prof):
    if _checked_on_cpu(x, b, geom, order, slices):
        raise ValueError("A1's variants time the kernel: pass CUDA tensors")
    n, nt, na, ns = geom.n, geom.nray, geom.nproj, x.shape[-1]
    out = x.clone()
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_art_variant(
        index, p(out), p(b), p(art_table(geom, x.device)), p(order),
        order.numel(), float(beta), n, nt * na, ns,
        art_slices(n) if slices is None else slices,
        None if prof is None else p(prof), _build.stream()),
        "tj_art_variant")
    return out


def art_variant(x, b, geom: Geometry, beta, order, variant: str,
                slices=None):
    """One sweep of a variant of A1 on the card, for splitting a ray's time
    (`VARIANTS`: FULL is A1; NOLOAD takes every pixel value from
    registers in place of x, NORED takes the warp's sum for the block's (no
    shared partials; the ray's barrier stays), NOSTORE writes no update,
    NOPREF issues no L2 prefetch, CHAIN is all three of NOLOAD, NOSTORE
    and NOPREF: the ray-to-ray chain without x's traffic; their results
    are not the sweep's). Operands as `art_sweep_sl`'s, on the card (Ns a
    multiple of min(slices, 4)); counts in no launch count."""
    return _variant(x, b, geom, beta, order, VARIANTS[variant], slices,
                    None)


def art_phases(x, b, geom: Geometry, beta, order, slices=None) -> dict:
    """One A1 sweep on the card with the phases of a ray timed (the
    kernel's PROF instantiation; operands as `art_sweep_sl`'s): the mean
    clock64 cycles a ray of each of `PHASES` over the blocks (thread 0 of
    each), and the rays counted. Counts in no launch count."""
    ns = x.shape[-1]
    blocks = -(-ns // (art_slices(geom.n) if slices is None else slices))
    prof = torch.zeros((blocks, len(PHASES) + 1), dtype=torch.int64,
                       device=x.device)
    _variant(x, b, geom, beta, order, PROF, slices, prof)
    cyc = prof.cpu().double()
    rays = int(cyc[0, -1])
    return {"rays": rays, **{name: float(cyc[:, q].mean()) / max(rays, 1)
                             for q, name in enumerate(PHASES)}}
