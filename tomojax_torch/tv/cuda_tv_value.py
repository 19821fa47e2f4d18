"""TV-value kernel K5 on the card, with its plain PyTorch version.

Counterpart of ``tomojax/tv/pallas_tv_value.py``: the isotropic TV value
with periodic wrap and eps = 1e-6 (the FISTA metric), of a volume or
summed over the elements of a (nel, ...) stack. Given a right halo plane
it computes a slab's share of the TV of a z-sharded volume (the axis-2
neighbour of the last slice is the next rank's first slice, the periodic
wrap across slabs). ``tv_value`` runs the plain version only for a CPU
tensor; on a CUDA tensor it launches ``csrc/tv_value.cu`` (the plane
march of ``csrc/tv_march.cuh``, one partial sum a block, then one
fixed-order sum: repeated runs give identical values) or raises. Launches
are counted in ``tv_value.launches``.
"""

from __future__ import annotations

import torch

from tomojax_torch import _build

EPS_TV = 1e-6
F32 = torch.float32


def tv_terms_ref(x: torch.Tensor, hi: torch.Tensor | None = None):
    """The plain per-voxel terms sqrt(eps + dz^2 + dy^2 + dx^2) of a 3D
    volume, with forward differences that wrap around; with `hi`, the
    (n0, n1) plane above the last slice of axis 2 takes the wrap's place
    on that axis."""
    if hi is not None:
        x = torch.cat([x, hi[:, :, None]], dim=2)
    d0 = x - torch.roll(x, -1, 0)
    d1 = x - torch.roll(x, -1, 1)
    d2 = x - torch.roll(x, -1, 2)
    t = torch.sqrt(EPS_TV + d0 * d0 + d1 * d1 + d2 * d2)
    return t if hi is None else t[:, :, :-1]


def tv_value_ref(x: torch.Tensor, hi: torch.Tensor | None = None):
    """Plain sum of `tv_terms_ref` over a 3D volume (0-dim result). A 4D
    (nel, ...) stack (hi (nel, n0, n1)) gives the sum over its elements of
    their 3D values."""
    if x.dim() == 4:
        return torch.stack([tv_value_ref(xe, None if hi is None else hi[e])
                            for e, xe in enumerate(x)]).sum()
    return torch.sum(tv_terms_ref(x, hi))


def tv_value(x: torch.Tensor, hi: torch.Tensor | None = None):
    """K5: periodic isotropic TV of a contiguous (n0, n1, n2) float32
    volume, or the summed TV of the elements of a (nel, n0, n1, n2) stack
    in one launch, as a 0-dim float32 tensor on x's device. hi: optional
    contiguous plane above slice n2 - 1 of each element (x.shape[:-1]; a
    slab's right halo)."""
    if x.dim() not in (3, 4):
        raise ValueError(f"tv_value takes a 3D volume or a 4D stack, got "
                         f"{tuple(x.shape)}")
    _build.check_operand(x, "x", x.shape, F32)
    halo = () if hi is None else (hi,)
    if hi is not None:
        _build.check_operand(hi, "hi", x.shape[:-1], F32)
    if _build.on_cpu(x, *halo):
        return tv_value_ref(x, hi)
    lib = _build.lib()
    nel = x.shape[0] if x.dim() == 4 else 1
    n0, n1, n2 = x.shape[-3:]
    partials = torch.empty(lib.tj_tv_value_partials(nel, n0, n1, n2),
                           dtype=F32, device=x.device)
    out = torch.empty((), dtype=F32, device=x.device)
    _build.check(lib.tj_tv_value(x.data_ptr(),
                                 None if hi is None else hi.data_ptr(),
                                 partials.data_ptr(), out.data_ptr(), nel, n0,
                                 n1, n2, _build.stream()), "tj_tv_value")
    tv_value.launches += 1
    return out


tv_value.launches = 0
