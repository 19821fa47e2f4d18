"""TV-value kernel K5 on the card, with its plain PyTorch version.

Counterpart of ``tomojax/tv/pallas_tv_value.py``: the isotropic TV value
with periodic wrap and eps = 1e-6 (the FISTA metric). Given a right halo
plane it computes a slab's share of the TV of a z-sharded volume (the
axis-2 neighbour of the last slice is the next rank's first slice, the
periodic wrap across slabs). ``tv_value`` runs
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


def tv_value_ref(x: torch.Tensor, hi: torch.Tensor | None = None):
    """Plain sum of sqrt(eps + dz^2 + dy^2 + dx^2) over a 3D volume, with
    forward differences that wrap around (0-dim result); with `hi`, the
    (n0, n1) plane above the last slice of axis 2 takes the wrap's place
    on that axis."""
    if hi is not None:
        x = torch.cat([x, hi[:, :, None]], dim=2)
    d0 = x - torch.roll(x, -1, 0)
    d1 = x - torch.roll(x, -1, 1)
    d2 = x - torch.roll(x, -1, 2)
    t = torch.sqrt(EPS_TV + d0 * d0 + d1 * d1 + d2 * d2)
    return torch.sum(t if hi is None else t[:, :, :-1])


def tv_value(x: torch.Tensor, hi: torch.Tensor | None = None):
    """K5: periodic isotropic TV of a contiguous (n0, n1, n2) float32
    volume, as a 0-dim float32 tensor on x's device. hi: optional
    contiguous (n0, n1) plane above slice n2 - 1 (a slab's right halo)."""
    if x.dim() != 3:
        raise ValueError(f"tv_value takes a 3D volume, got {tuple(x.shape)}")
    _build.check_operand(x, "x", x.shape, F32)
    halo = () if hi is None else (hi,)
    if hi is not None:
        _build.check_operand(hi, "hi", x.shape[:2], F32)
    if _build.on_cpu(x, *halo):
        return tv_value_ref(x, hi)
    lib = _build.lib()
    n0, n1, n2 = x.shape
    partials = torch.empty(lib.tj_tv_value_partials(n0, n1, n2), dtype=F32,
                           device=x.device)
    out = torch.empty((), dtype=F32, device=x.device)
    _build.check(lib.tj_tv_value(x.data_ptr(),
                                 None if hi is None else hi.data_ptr(),
                                 partials.data_ptr(), out.data_ptr(), n0, n1,
                                 n2, _build.stream()), "tj_tv_value")
    tv_value.launches += 1
    return out


tv_value.launches = 0
