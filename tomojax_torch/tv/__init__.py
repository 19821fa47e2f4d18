"""Total-variation value, subgradient descent and FGP prox (counterpart
of ``tomojax.tv``).

Semantics are the reference's (``tomojax/tv/__init__.py``): the TV value
is isotropic with periodic wrap and eps = 1e-6; TV-GD takes normalised
steps along the periodic 4-term subgradient with the global norm; the FGP
prox uses the zero-boundary divergence/gradient chain, dual step
1/(26 lam), no dual momentum, a nonnegativity clamp and the isotropic
dual-ball projection. All dispatch by device inside their kernel wrappers
(plain PyTorch on the CPU, the CUDA kernels on the card).

A 4D (Nel, ...) stack is a batch of independent elements (the reference's
4D TV runs the 3D kernels per element): ``tv`` sums their TV values (one
K5 launch for the stack),
``tv_fgp`` runs the 3D chain per element, and ``tv_gd`` with
axis_norm=(1, 2, 3) runs K7 per element with each element's norm.

With ``group=`` (a `tomojax_torch.dist.SlabGroup`, even of size 1) a 3D
volume is this rank's slice-last slab (N, N, n_loc) of a z-sharded volume,
and a 4D stack is this rank's slab (Nel, N, N, n_loc) of each element. The
functions compute what they compute on the whole volume or stack: the
stencils take their slab-axis neighbours from halo planes (K5 with a
right halo, one launch for a stack; K9a/K9b and K9c per element) and the
scalars are all-reduced. Every rank loops over the elements in the same
order, so the halo exchanges and all-reduces pair up across the ranks.
"""

from __future__ import annotations

import torch

from tomojax_torch.dist import SlabGroup, all_reduce_sum, halo_exchange
from tomojax_torch.tv.cuda_fgp import tv_fgp_fused, tv_fgp_two_pass
from tomojax_torch.tv.cuda_fgp_sharded import tv_fgp_sharded
from tomojax_torch.tv.cuda_tv_value import EPS_TV, tv_value
from tomojax_torch.tv.cuda_tvgd import tv_descent, tv_grad, tv_step
from tomojax_torch.tv.cuda_tvgd_sharded import tv_gd_sharded

COMPAT = ("global", "reference-mpi")


def tv(x: torch.Tensor, group: SlabGroup | None = None) -> torch.Tensor:
    """Isotropic periodic TV of a 3D volume, or the summed per-element TV
    of a 4D (Nel, ...) stack (0-dim tensor). With a group: the TV of the
    whole z-sharded volume (or stack), the wrap on the slice axis crossing
    the slabs as a ring, on every rank: one right halo plane per element
    and one K5 launch."""
    if group is not None:
        _, hi = halo_exchange(x[..., 0].contiguous(), None, group, ring=True)
        return all_reduce_sum(tv_value(x, hi), group)
    return tv_value(x)


def tv_fgp(x: torch.Tensor, n_iter: int, lam: float, dual_dtype=None,
           group: SlabGroup | None = None):
    """Reference-faithful FGP TV denoise of a 3D volume, of this rank's
    slab with a group (K9a/K9b), or of each element of a 4D (Nel, ...)
    stack (the 3D chain, or with a group the slab chain, per element; the
    TV values are summed).

    Returns (denoised, tv_of_input), as ``tomojax.tv.tv_fgp`` does. The
    duals are stored as ``dual_dtype`` (default config.fgp_dual_dtype,
    bfloat16); pass torch.float32 for the reference's all-f32 result."""
    def prox(v):
        if group is None:
            return tv_fgp_fused(v, n_iter, lam, dual_dtype)
        return tv_fgp_sharded(v, n_iter, lam, group, dual_dtype)

    d = torch.stack([prox(xe) for xe in x]) if x.dim() == 4 else prox(x)
    return d, tv(x, group)


def tv_gd(x: torch.Tensor, ng: int, dpocs, group: SlabGroup | None = None,
          compat: str = "global", axis_norm=None):
    """`ng` normalised TV-subgradient steps ``x -= dpocs g / ||g||_2``
    (global norm, no eps), then positivity, of a slice-last 3D volume, or
    of this rank's slab with a group (K9c on the periodic ring).

    Returns (x_new, tv_of_input), as ``tomojax.tv.tv_gd`` does. dpocs is a
    float or a 0-dim tensor on x's device; the norm stays on the device
    (K7, K9c) and each step is one pass on the card (``tv_step``), so the
    steps never wait for the host.

    A 4D (Nel, ...) stack takes axis_norm=(1, 2, 3) (the reference's 4D
    TV-GD): K7 per element, each normalised by its own norm; with a group
    K9c per element, each element's norm all-reduced. 3D volumes take
    axis_norm=None.

    compat='reference-mpi' with a group reproduces the reference's
    multi-rank TV-GD (``tomojax.tv._tv_gd_reference_mpi``): every rank
    descends its slab as an independent periodic volume (K7 on the slab)
    normalised by its local norm, and the returned TV value is the sum of
    the slabs' local periodic TVs. Its result depends on the number of
    ranks, on purpose; without a group, or with one rank, it is the
    default. It models the 3D multi-rank path only, as in the reference."""
    if compat not in COMPAT:
        raise ValueError(f"compat must be one of {COMPAT}: {compat!r}")
    if compat == "reference-mpi" and x.dim() != 3:
        raise ValueError(f"compat='reference-mpi' takes a 3D volume, got "
                         f"{tuple(x.shape)}")
    if x.dim() == 4 and axis_norm == (1, 2, 3):
        if group is None:
            x_new = [tv_descent(xe, ng, dpocs) for xe in x]
        else:
            x_new = [tv_gd_sharded(xe, ng, dpocs, group) for xe in x]
        return torch.stack(x_new), tv(x, group)
    if x.dim() != 3 or axis_norm is not None:
        raise ValueError(f"tv_gd takes a 3D volume with axis_norm None or "
                         f"a 4D stack with axis_norm (1, 2, 3), got "
                         f"{tuple(x.shape)} and {axis_norm!r}")
    if group is None or compat == "global":
        tv0 = tv(x, group)
        if group is not None:
            return tv_gd_sharded(x, ng, dpocs, group), tv0
    else:
        tv0 = all_reduce_sum(tv_value(x), group)
    return tv_descent(x, ng, dpocs), tv0


def tv_4d(x: torch.Tensor, group: SlabGroup | None = None) -> torch.Tensor:
    """Summed per-element TV of a (Nel, ...) stack, or of the z-sharded
    stack whose slabs the ranks of `group` hold (0-dim tensor)."""
    if x.dim() != 4:
        raise ValueError(f"tv_4d takes a 4D stack, got {tuple(x.shape)}")
    return tv(x, group)


def tv_fgp_4d(x: torch.Tensor, n_iter: int, lam: float, dual_dtype=None,
              group: SlabGroup | None = None):
    """Per-element FGP of a (Nel, ...) stack, or of this rank's slabs of
    it with a group: (denoised, summed TV of the input); the stencils never
    cross the element axis. The duals are stored as ``dual_dtype``
    (default config.fgp_dual_dtype)."""
    if x.dim() != 4:
        raise ValueError(f"tv_fgp_4d takes a 4D stack, got "
                         f"{tuple(x.shape)}")
    return tv_fgp(x, n_iter, lam, dual_dtype, group)


def tv_gd_4d(x: torch.Tensor, ng: int, dpocs,
             group: SlabGroup | None = None):
    """Per-element TV-GD of a (Nel, ...) stack, or of this rank's slabs of
    it with a group, each element normalised by its own gradient norm."""
    if x.dim() != 4:
        raise ValueError(f"tv_gd_4d takes a 4D stack, got {tuple(x.shape)}")
    return tv_gd(x, ng, dpocs, group, axis_norm=(1, 2, 3))


__all__ = ["EPS_TV", "tv", "tv_4d", "tv_fgp", "tv_fgp_4d", "tv_fgp_fused",
           "tv_fgp_sharded", "tv_fgp_two_pass", "tv_gd", "tv_gd_4d",
           "tv_gd_sharded", "tv_grad", "tv_step", "tv_value"]
