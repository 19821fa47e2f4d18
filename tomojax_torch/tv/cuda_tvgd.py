"""TV-GD subgradient kernel K7 on the card, with its plain PyTorch version.

Counterpart of ``tomojax/tv/pallas_tvgd.py`` (``_grad_kernel``): the
4-term isotropic TV subgradient with periodic wrap and eps = 1e-6 of
``tomojax/tv/__init__.py:_tv_grad``, plus ``||g||^2``. The port's volumes
are slice-last (N, N, Ns), so the reference's slice axis i is axis 2, its
row axis j is axis 0 and its column axis k is axis 1; both versions keep
the reference's summation order (i, then j, then k). ``tv_grad`` runs the
plain version only for a CPU tensor; on a CUDA tensor it launches
``csrc/tvgd.cu`` (per-block partial sums of g^2, then one fixed-order
sum: repeated runs give identical norms) or raises. Launches are counted
in ``tv_grad.launches``.
"""

from __future__ import annotations

import torch

from tomojax_torch import _build
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


tv_grad.launches = 0
