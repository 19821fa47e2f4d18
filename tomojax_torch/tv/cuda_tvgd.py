"""TV-GD subgradient kernel K7 and the descent step on the card, with their
plain PyTorch versions.

Counterpart of ``tomojax/tv/pallas_tvgd.py`` (``_grad_kernel`` and the
step ``tv_gd_pallas`` leaves to XLA): the 4-term isotropic TV subgradient
with periodic wrap and eps = 1e-6 of ``tomojax/tv/__init__.py:_tv_grad``,
plus ``||g||^2``, and the normalised step x - dpocs g / ||g||. The port's
volumes are slice-last (N, N, Ns), so the reference's slice axis i is axis
2, its row axis j is axis 0 and its column axis k is axis 1; both versions
keep the reference's summation order (i, then j, then k).

``tv_grad`` runs the plain version only for a CPU tensor; on a CUDA tensor
it launches ``csrc/tvgd.cu`` (the plane march of ``tv/march.py``; per-block
partial sums of g^2, then one fixed-order sum: repeated runs give
identical norms) or raises. ``tv_step`` likewise launches ``tj_tv_step``,
one elementwise pass that reads dpocs and ||g||^2 on the device and rounds
as the plain expression does. Launches are counted in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from tomojax_torch import _build, profiling
from tomojax_torch.tv.cuda_tv_value import EPS_TV

F32 = torch.float32
_I, _J, _K = 2, 0, 1  # the reference's (slice, row, column) axes


def tv_grad_field(x: torch.Tensor) -> torch.Tensor:
    """Plain g of a slice-last 3D volume (periodic on every axis)."""
    ip = torch.roll(x, -1, _I)
    jp = torch.roll(x, -1, _J)
    kp = torch.roll(x, -1, _K)
    di, dj, dk = x - ip, x - jp, x - kp
    d = torch.sqrt(EPS_TV + di * di + dj * dj + dk * dk)
    g = (3.0 * x - ip - jp - kp) / d
    g = g + (x - torch.roll(x, 1, _I)) / torch.roll(d, 1, _I)
    g = g + (x - torch.roll(x, 1, _J)) / torch.roll(d, 1, _J)
    return g + (x - torch.roll(x, 1, _K)) / torch.roll(d, 1, _K)


def tv_grad_ref(x: torch.Tensor):
    """Plain ``(g, ||g||^2)`` of a slice-last 3D volume (0-dim norm)."""
    g = tv_grad_field(x)
    return g, torch.sum(g * g)


def tv_grad(x: torch.Tensor):
    """K7: ``(g, ||g||^2)`` as `tv_grad_ref` says, for a contiguous
    (N, N, Ns) float32 volume; the norm is a 0-dim tensor on x's device."""
    if x.dim() != 3:
        raise ValueError(f"tv_grad takes a 3D volume, got {tuple(x.shape)}")
    _build.check_operand(x, "x", x.shape, F32)
    if _build.on_cpu(x):
        return tv_grad_ref(x)
    lib = _build.lib()
    n0, n1, n2 = x.shape
    g = torch.empty_like(x)
    partials = torch.empty(lib.tj_tv_grad_partials(n0, n1, n2), dtype=F32,
                           device=x.device)
    gsq = torch.empty((), dtype=F32, device=x.device)
    _build.check(lib.tj_tv_grad(x.data_ptr(), g.data_ptr(),
                                partials.data_ptr(), gsq.data_ptr(), n0, n1,
                                n2, _build.stream()), "tj_tv_grad")
    tv_grad.launches += 1
    return g, gsq


def tv_step_ref(x, g, gsq, dpocs, clamp: bool = False):
    """Plain descent step ``x - dpocs * g / sqrt(gsq)``, then positivity
    when `clamp` (the last of the steps)."""
    x = x - dpocs * g / torch.sqrt(gsq)
    return torch.clamp_min(x, 0.0) if clamp else x


def tv_step(x, g, gsq, dpocs, clamp: bool = False):
    """The descent step as `tv_step_ref` says, for contiguous float32 x and
    g of one shape and a 0-dim float32 gsq; dpocs a float or a 0-dim
    tensor. On the card one pass, dpocs and gsq read on the device."""
    _build.check_operand(x, "x", x.shape, F32)
    _build.check_operand(g, "g", x.shape, F32)
    _build.check_operand(gsq, "gsq", (), F32)
    if _build.on_cpu(x, g, gsq):
        return tv_step_ref(x, g, gsq, dpocs, clamp)
    dp = torch.as_tensor(dpocs, dtype=F32, device=x.device)
    _build.check_operand(dp, "dpocs", (), F32)
    out = torch.empty_like(x)
    _build.check(_build.lib().tj_tv_step(
        x.data_ptr(), g.data_ptr(), dp.data_ptr(), gsq.data_ptr(),
        out.data_ptr(), x.numel(), int(clamp), _build.stream()), "tj_tv_step")
    tv_step.launches += 1
    return out


def tv_descent(x: torch.Tensor, ng: int, dpocs, grad=tv_grad):
    """`ng` normalised steps along `grad` (a function x -> (g, ||g||^2)),
    the last one clamped to x >= 0; with ng = 0 only the clamp."""
    with profiling.annotate("tv.descent"):
        if ng == 0:
            return torch.clamp_min(x, 0.0)
        for k in range(ng):
            g, gsq = grad(x)
            x = tv_step(x, g, gsq, dpocs, clamp=k == ng - 1)
        return x


tv_grad.launches = 0
tv_step.launches = 0
