"""TV-value kernel K5 on the card, with its plain PyTorch version.

Counterpart of ``tomojax/tv/pallas_tv_value.py``: the isotropic TV value
with periodic wrap and eps = 1e-6 (the FISTA metric). ``tv_value`` runs
the plain version only for a CPU tensor; on a CUDA tensor it launches
``csrc/tv_value.cu`` (per-block partial sums, then one fixed-order sum:
repeated runs give identical values) or raises. Launches are counted in
``tv_value.launches``.
"""

from __future__ import annotations

import torch

from tomojax_torch import _build

EPS_TV = 1e-6
F32 = torch.float32


def tv_value_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain sum of sqrt(eps + dz^2 + dy^2 + dx^2) over a 3D volume, with
    forward differences that wrap around (0-dim result)."""
    d0 = x - torch.roll(x, -1, 0)
    d1 = x - torch.roll(x, -1, 1)
    d2 = x - torch.roll(x, -1, 2)
    return torch.sum(torch.sqrt(EPS_TV + d0 * d0 + d1 * d1 + d2 * d2))


def tv_value(x: torch.Tensor) -> torch.Tensor:
    """K5: periodic isotropic TV of a contiguous (n0, n1, n2) float32
    volume, as a 0-dim float32 tensor on x's device."""
    if x.dim() != 3:
        raise ValueError(f"tv_value takes a 3D volume, got {tuple(x.shape)}")
    _build.check_operand(x, "x", x.shape, F32)
    if _build.on_cpu(x):
        return tv_value_ref(x)
    lib = _build.lib()
    n0, n1, n2 = x.shape
    partials = torch.empty(lib.tj_tv_value_partials(n0, n1, n2), dtype=F32,
                           device=x.device)
    out = torch.empty((), dtype=F32, device=x.device)
    _build.check(lib.tj_tv_value(x.data_ptr(), partials.data_ptr(),
                                 out.data_ptr(), n0, n1, n2, _build.stream()),
                 "tj_tv_value")
    tv_value.launches += 1
    return out


tv_value.launches = 0
