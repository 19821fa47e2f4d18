"""TV-GD on a z-slab of a sharded volume: kernel K9c and its plain PyTorch
version (counterpart of ``tomojax/tv/pallas_tvgd_sharded.py``).

TV-GD wraps periodically on every axis, so the slabs form a ring: before
every descent step each rank sends its first slice to the left neighbour
and its last slice to the right one, and rank 0's plane below is the last
slice of rank size - 1. K9c ``tv_grad_halo`` (``csrc/tvgd.cu``
``tv_grad_kernel<true>``) is K7's body with the planes below slice 0 and
above slice n_loc - 1 taken from those halos; its g equals K7's on the
whole volume bit for bit. Its ||g||^2 is the slab's fixed-order partial,
all-reduced into the global norm, so every rank takes the same normalised
step as the unsharded `tv_gd` (the reference's multi-rank TV-GD uses the
local norm instead: ``tv.tv_gd(compat='reference-mpi')``). The step and
the clamp are `cuda_tvgd.tv_step`, as on the unsharded path.

``tv_grad_halo`` runs the plain version only for CPU tensors; on CUDA
tensors it launches the kernel or raises. Launches are counted in
``tv_grad_halo.launches``.
"""

from __future__ import annotations

import torch

from tomojax_torch import _build
from tomojax_torch.dist import SlabGroup, all_reduce_sum, halo_exchange
from tomojax_torch.tv.cuda_tvgd import F32, tv_descent, tv_grad_field

_SLAB = 2  # the slab axis of a slice-last volume


def tv_grad_halo_ref(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Plain K9c: ``(g, ||g||^2 of the slab)`` of a slice-last slab whose
    axis-2 neighbours are the (n0, n1) planes lo (below slice 0) and hi
    (above the last slice)."""
    ext = torch.cat([lo[:, :, None], x, hi[:, :, None]], dim=_SLAB)
    g = tv_grad_field(ext)[:, :, 1:-1]
    return g.contiguous(), torch.sum(g * g)


def tv_grad_halo(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """K9c: as `tv_grad_halo_ref` says, for a contiguous (N, N, n_loc)
    float32 slab and contiguous (N, N) float32 planes; the partial norm is
    a 0-dim tensor on x's device."""
    if x.dim() != 3:
        raise ValueError(f"tv_grad_halo takes a 3D slab, got "
                         f"{tuple(x.shape)}")
    _build.check_operand(x, "x", x.shape, F32)
    _build.check_operand(lo, "lo", x.shape[:2], F32)
    _build.check_operand(hi, "hi", x.shape[:2], F32)
    if _build.on_cpu(x, lo, hi):
        return tv_grad_halo_ref(x, lo, hi)
    lib = _build.lib()
    n0, n1, n2 = x.shape
    g = torch.empty_like(x)
    partials = torch.empty(lib.tj_tv_grad_partials(n0, n1, n2), dtype=F32,
                           device=x.device)
    gsq = torch.empty((), dtype=F32, device=x.device)
    _build.check(lib.tj_tv_grad_halo(x.data_ptr(), lo.data_ptr(),
                                     hi.data_ptr(), g.data_ptr(),
                                     partials.data_ptr(), gsq.data_ptr(), n0,
                                     n1, n2, _build.stream()),
                 "tj_tv_grad_halo")
    tv_grad_halo.launches += 1
    return g, gsq


def tv_gd_sharded(x: torch.Tensor, ng: int, dpocs, group: SlabGroup):
    """`ng` globally normalised TV-subgradient steps of this rank's slab
    (N, N, n_loc), then positivity (``tv_gd_sharded`` of the JAX package,
    without the TV value: ``tv.tv_gd`` adds it). dpocs is a float or a
    0-dim tensor on x's device; no step reads the host."""
    def grad(v):
        lo, hi = halo_exchange(v[:, :, 0].contiguous(),
                               v[:, :, -1].contiguous(), group, ring=True)
        g, gsq = tv_grad_halo(v, lo, hi)
        return g, all_reduce_sum(gsq, group)

    return tv_descent(x, ng, dpocs, grad)


tv_grad_halo.launches = 0
