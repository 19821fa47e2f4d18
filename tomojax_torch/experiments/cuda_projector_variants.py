"""Experiment projector kernels E1 and E2 on the card, with their plain
PyTorch versions.

Counterparts of the TPU kernels of ``scripts/exp_hat_model.py``,
``exp_projector_variants.py``, ``exp_projector_variants2.py`` and
``exp_pair_fp.py``. Layouts as ``projector/cuda_joseph.py``: volumes
``(N, N, Ns)``, sinograms ``(Na, Nt, Ns)``, float32, contiguous.

* E1 ``fp_variant`` (``csrc/exp_projector.cu`` ``fp_variant_kernel``): the
  forward projection on K1's design: blocks of up to ``ab`` angles (the
  TPU's a_blk) x 32 bins x 32 slices from K1's host plan
  (`fp_variant_plan`), the windows of each step staged in shared memory;
  at each step the two taps of K1's position, each weighted from its
  distance d = j - J*(pixel) in one of the `FORMS`. The default ab is
  K1's own group cap. ``pair=True`` writes the rays of theta and -theta of
  a symmetric series from one walk over the angles Na/2 .. Na-1, staging
  each window and its mirror.
* E2 ``bp_variant`` (``bp_variant_kernel``): the backprojection on K2's
  design: 16 x 16 pixel tiles x 32 slices, the angles staged 8 at a time,
  24 bins each from the window start of ``cuda_joseph.bp_window_lo``
  (zeros outside the sinogram), with the weight forms of `BP_FORMS`, the
  angles added in order; ``aps=2`` reads two angles' taps before their
  products.

The forms (csrc/exp_hat.cuh): FULL ``max(0, 1 - |d| invd) invd``; HAT5
``max(0, min(1 - u, 1 + u))``, u = d invd, the sum times invd; BF16
``max(0, 1 - |bf16(u)|)`` in bf16, the FP sum times invd, the BP sinogram
times invd before the product; W4 ``max(0, invd - |j invd^2 - invd^2 J*|)``;
the ablations NOHAT (the constant invd/2 on the same taps) and NODOT (the
FULL weights summed, nothing loaded). Products are float32 unless a form
rounds explicitly.

The plain versions go one angle at a time and add the products of each
driving step (FP) or angle (BP) in the kernels' order, every operation
rounded on its own, so they equal the kernels bit for bit. A wrapper runs
its plain version only when its tensors lie on the CPU; on CUDA tensors it
launches its kernel or raises, and counts in ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch import _build
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import (
    FP_GROUP, FpPlan, angle_tables, fp_plan,
)

F32 = torch.float32
FORMS = ("FULL", "HAT5", "BF16", "NOHAT", "NODOT", "W4")  # exp_hat.cuh Form
BP_FORMS = ("FULL", "BF16", "NOHAT", "NODOT", "W4")
ANGLES_PER_BLOCK = (1, 2, 4, 8, 16, 32)
PAIR_TOL = 1e-9  # rad: largest |theta_i + theta_(Na-1-i)| of a pair series


def _f32(v) -> float:
    """`v` rounded to float32, as a Python float (a scalar operand that
    PyTorch applies in float32)."""
    return float(np.float32(v))


def weight(form: str, jf, jstar: torch.Tensor, invd: float) -> torch.Tensor:
    """Weight of the taps at bins `jf` (a float tensor of bin indices) with
    J* = `jstar`, for one angle of 1/D = `invd` (a float32 value): the
    kernels' ``tj::xp::weight<FORM>``."""
    if form == "NOHAT":
        return torch.full_like(jstar, _f32(invd * 0.5))
    if form == "W4":
        inv2 = _f32(np.float32(invd) * np.float32(invd))
        return torch.clamp_min(invd - torch.abs(jf * inv2 - inv2 * jstar),
                               0.0)
    d = jf - jstar
    if form == "HAT5":
        u = d * invd
        return torch.clamp_min(torch.minimum(1.0 - u, 1.0 + u), 0.0)
    if form == "BF16":
        ub = (d * invd).to(torch.bfloat16)
        return torch.clamp_min(1.0 - ub.abs(), 0.0).float()
    return torch.clamp_min(1.0 - torch.abs(d) * invd, 0.0) * invd


def jstar_of(t_bp, xc, yr, off: float) -> torch.Tensor:
    """J* = x_c cos + y_r sin + (Nt-1)/2 in ``tj::bp_jstar``'s order."""
    return t_bp[0] * xc + t_bp[1] * yr + off


def fp_taps(t_fp, t_bp, n: int, nt: int, device):
    """Taps of every (driving step k, bin j) of one angle, (N, Nt) each:
    the first tap index i0 = floor(pos) at K1's position, the J* of taps i0
    and i0 + 1, and the row-driven flag. t_fp / t_bp are the angle's rows
    of ``angle_tables(...).fp`` / ``.bp``."""
    inv_d, shear, _, row_driven = t_fp
    ctr, off = (n - 1) / 2.0, (nt - 1) / 2.0
    steps = torch.arange(n, dtype=F32, device=device)
    base = (torch.arange(nt, dtype=F32, device=device) - off) * inv_d
    if row_driven:
        pos = (base[None, :] + (ctr - steps)[:, None] * shear) + ctr
    else:
        pos = (ctr - base)[None, :] + (steps - ctr)[:, None] * shear
    f = torch.floor(pos)
    k = steps[:, None]
    js = []
    for tap in (f, f + 1.0):
        if row_driven:  # pixel (row k, column tap)
            js.append(jstar_of(t_bp, tap - ctr, ctr - k, off))
        else:  # pixel (row tap, column k)
            js.append(jstar_of(t_bp, k - ctr, ctr - tap, off))
    return f.to(torch.int64), js[0], js[1], bool(row_driven)


def gather_taps(x: torch.Tensor, i0: torch.Tensor, row_driven: bool,
                flip: bool = False):
    """x at taps i0 and i0 + 1 of every (step, bin), out-of-range taps as 0:
    two (N, Nt, Ns) tensors. flip reads row N-1-r for row r."""
    n = x.shape[0]
    k = torch.arange(n, device=x.device)[:, None]
    out = []
    for i in (i0, i0 + 1):
        ok = (i >= 0) & (i < n)
        ic = i.clamp(0, n - 1)
        if row_driven:
            v = x[n - 1 - k if flip else k, ic]
        else:
            v = x[n - 1 - ic if flip else ic, k]
        out.append(torch.where(ok[..., None], v, 0.0))
    return out


def sequential_sum(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """acc + p0[k] + p1[k] for k = 0, 1, ..., each addition rounded: the
    kernels' accumulation order over the driving steps."""
    acc = torch.zeros_like(p0[0])
    for k in range(p0.shape[0]):
        acc = acc + p0[k]
        acc = acc + p1[k]
    return acc


def pair_series(geom: Geometry) -> None:
    """Raise unless the angles pair up as theta[Na-1-i] = -theta[i] within
    `PAIR_TOL` with an even count (E1's PAIR)."""
    th = geom.angles
    if geom.nproj % 2:
        raise ValueError(f"pair needs an even number of angles, got "
                         f"{geom.nproj}")
    worst = float(np.max(np.abs(th + th[::-1])))
    if worst > PAIR_TOL:
        raise ValueError(f"angles are not symmetric pairs: max |theta_i + "
                         f"theta_(Na-1-i)| = {worst:.3e} rad > {PAIR_TOL}")


# ------------------------------------------------------------- plain versions


def fp_variant_ref(x: torch.Tensor, geom: Geometry, form: str = "FULL",
                   pair: bool = False) -> torch.Tensor:
    """Plain E1: (N, N, Ns) -> (Na, Nt, Ns) in weight form `form`; with
    pair, each angle Na/2 + z walks its taps once for itself and, on the
    row-flipped volume, for angle Na/2 - 1 - z."""
    n, nt, na = geom.n, geom.nray, geom.nproj
    tabs = angle_tables(geom, torch.device("cpu"))
    tf, tb = tabs.fp.tolist(), tabs.bp.tolist()
    out = torch.empty((na, nt, x.shape[-1]), dtype=F32, device=x.device)
    for a in range(na // 2, na) if pair else range(na):
        invd = tb[a][2]
        i0, js0, js1, rd = fp_taps(tf[a], tb[a], n, nt, x.device)
        jf = torch.arange(nt, dtype=F32, device=x.device)[None, :]
        w0, w1 = weight(form, jf, js0, invd), weight(form, jf, js1, invd)
        if form == "NODOT":
            acc = sequential_sum(w0[..., None], w1[..., None])
            out[a] = acc.expand(nt, x.shape[-1])
            continue
        v0, v1 = gather_taps(x, i0, rd)
        acc = sequential_sum(w0[..., None] * v0, w1[..., None] * v1)
        out[a] = acc * invd if form in ("HAT5", "BF16") else acc
        if pair:
            u0, u1 = gather_taps(x, i0, rd, flip=True)
            out[na - 1 - a] = sequential_sum(w0[..., None] * u0,
                                             w1[..., None] * u1)
    return out


def bp_taps(t_bp, n: int, nt: int, device):
    """Bins of every pixel of one angle, (N, N) each: j0 = floor(J*) as an
    int64 tensor, floor(J*) as a float tensor, and J*."""
    ctr = (n - 1) / 2.0
    xc = torch.arange(n, dtype=F32, device=device) - ctr
    yr = ctr - torch.arange(n, dtype=F32, device=device)
    jstar = jstar_of(t_bp, xc[None, :], yr[:, None], (nt - 1) / 2.0)
    f = torch.floor(jstar)
    return f.to(torch.int64), f, jstar


def gather_bins(ya: torch.Tensor, j0: torch.Tensor):
    """ya (Nt, Ns) at bins j0 and j0 + 1 of every pixel, out-of-range bins
    as 0: two (N, N, Ns) tensors."""
    nt = ya.shape[0]
    return [torch.where(((j >= 0) & (j < nt))[..., None],
                        ya[j.clamp(0, nt - 1)], 0.0) for j in (j0, j0 + 1)]


def bp_variant_ref(y: torch.Tensor, geom: Geometry,
                   form: str = "FULL") -> torch.Tensor:
    """Plain E2: (Na, Nt, Ns) -> (N, N, Ns) in weight form `form`, the
    angles added in order (APS does not change the result)."""
    n, nt = geom.n, geom.nray
    acc = torch.zeros((n, n, y.shape[-1]), dtype=F32, device=y.device)
    for a, t in enumerate(angle_tables(geom, torch.device("cpu")).bp.tolist()):
        j0, f, jstar = bp_taps(t, n, nt, y.device)
        w0, w1 = weight(form, f, jstar, t[2]), weight(form, f + 1.0, jstar,
                                                       t[2])
        if form == "NODOT":
            acc = acc + w0[..., None]
            acc = acc + w1[..., None]
            continue
        v0, v1 = gather_bins(y[a], j0)
        if form == "BF16":
            v0, v1 = v0 * t[2], v1 * t[2]
        acc = acc + w0[..., None] * v0
        acc = acc + w1[..., None] * v1
    return acc


# ------------------------------------------------------------------ wrappers


def _check_choice(value, allowed, name: str) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


def fp_variant_plan(geom: Geometry, ab: int, pair: bool,
                    device: torch.device) -> FpPlan:
    """The plan E1 walks: K1's `fp_plan` with at most `ab` angles a group,
    over the angles Na/2 .. Na-1 (member indices from 0) with pair."""
    if pair:
        geom = Geometry.make(geom.n, geom.angles[geom.nproj // 2:],
                             nray=geom.nray)
    return fp_plan(geom, device, group=ab)


def fp_variant(x: torch.Tensor, geom: Geometry, form: str = "FULL",
               ab: int = FP_GROUP, pair: bool = False) -> torch.Tensor:
    """E1: `fp_variant_ref` on the card, blocks of at most `ab` angles (or
    pairs); the result does not depend on ab.

    pair=True needs form FULL and a series of `pair_series`."""
    _check_choice(form, FORMS, "form")
    _check_choice(ab, ANGLES_PER_BLOCK, "ab")
    if pair:
        _check_choice(form, ("FULL",), "form with pair")
        pair_series(geom)
    ns = x.shape[-1]
    _build.check_operand(x, "x", (geom.n, geom.n, ns), F32)
    if _build.on_cpu(x):
        return fp_variant_ref(x, geom, form, pair)
    tabs = angle_tables(geom, x.device)
    plan = fp_variant_plan(geom, ab, pair, x.device)
    out = torch.empty((geom.nproj, geom.nray, ns), dtype=F32, device=x.device)
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_exp_fp(
        FORMS.index(form), int(pair), p(x), p(tabs.fp), p(tabs.bp),
        p(plan.table), plan.ng, plan.width, ab, int(plan.groups[:, 1].max()),
        p(out), geom.n, geom.nray, geom.nproj, ns, _build.stream()),
        "tj_exp_fp")
    fp_variant.launches += 1
    return out


def bp_variant(y: torch.Tensor, geom: Geometry, form: str = "FULL",
               aps: int = 1) -> torch.Tensor:
    """E2: `bp_variant_ref` on the card; aps = 2 (form FULL) takes two
    angles per step."""
    _check_choice(form, BP_FORMS, "form")
    _check_choice(aps, (1, 2), "aps")
    if aps == 2:
        _check_choice(form, ("FULL",), "form with aps 2")
    ns = y.shape[-1]
    _build.check_operand(y, "y", (geom.nproj, geom.nray, ns), F32)
    if _build.on_cpu(y):
        return bp_variant_ref(y, geom, form)
    tab = angle_tables(geom, y.device).bp
    out = torch.empty((geom.n, geom.n, ns), dtype=F32, device=y.device)
    p = torch.Tensor.data_ptr
    _build.check(_build.lib().tj_exp_bp(
        FORMS.index(form), aps, p(y), p(tab), p(out), geom.n, geom.nray,
        geom.nproj, ns, _build.stream()), "tj_exp_bp")
    bp_variant.launches += 1
    return out


fp_variant.launches = 0
bp_variant.launches = 0
