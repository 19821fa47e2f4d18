"""Total-variation value, subgradient descent and FGP prox (counterpart
of ``tomojax.tv``).

Semantics are the reference's (``tomojax/tv/__init__.py``): the TV value
is isotropic with periodic wrap and eps = 1e-6; TV-GD takes normalised
steps along the periodic 4-term subgradient with the global norm; the FGP
prox uses the zero-boundary divergence/gradient chain, dual step
1/(26 lam), no dual momentum, a nonnegativity clamp and the isotropic
dual-ball projection. All dispatch by device inside their kernel wrappers
(plain PyTorch on the CPU, the CUDA kernels on the card).

With ``group=`` (a `tomojax_torch.dist.SlabGroup`, even of size 1) the
volume is this rank's slice-last slab (N, N, n_loc) of a z-sharded volume
and the functions compute what they compute on the whole volume: the
stencils take their slab-axis neighbours from halo planes (K5 with a
right halo, K9a/K9b, K9c) and the scalars are all-reduced.
"""

from __future__ import annotations

import torch

from tomojax_torch.dist import SlabGroup, all_reduce_sum, halo_exchange
from tomojax_torch.tv.cuda_fgp import tv_fgp_fused
from tomojax_torch.tv.cuda_fgp_sharded import tv_fgp_sharded
from tomojax_torch.tv.cuda_tv_value import EPS_TV, tv_value
from tomojax_torch.tv.cuda_tvgd import tv_grad
from tomojax_torch.tv.cuda_tvgd_sharded import tv_gd_sharded

COMPAT = ("global", "reference-mpi")


def tv(x: torch.Tensor, group: SlabGroup | None = None) -> torch.Tensor:
    """Isotropic periodic TV of a 3D volume, or the summed per-element TV
    of a 4D (Nel, ...) stack (0-dim tensor). With a group: the TV of the
    whole z-sharded volume, the wrap on axis 2 crossing the slabs as a
    ring, on every rank."""
    if group is not None:
        if x.dim() != 3:
            raise ValueError(f"tv with a group takes a 3D slab, got "
                             f"{tuple(x.shape)}")
        _, hi = halo_exchange(x[:, :, 0].contiguous(), None, group,
                              ring=True)
        return all_reduce_sum(tv_value(x, hi), group)
    if x.dim() == 4:
        return torch.stack([tv_value(xe) for xe in x]).sum()
    return tv_value(x)


def tv_fgp(x: torch.Tensor, n_iter: int, lam: float, dual_dtype=None,
           group: SlabGroup | None = None):
    """Reference-faithful FGP TV denoise of a 3D volume, or of this rank's
    slab with a group (K9a/K9b).

    Returns (denoised, tv_of_input), as ``tomojax.tv.tv_fgp`` does. The
    duals are stored as ``dual_dtype`` (default config.fgp_dual_dtype,
    bfloat16); pass torch.float32 for the reference's all-f32 result."""
    if group is None:
        return tv_fgp_fused(x, n_iter, lam, dual_dtype), tv(x)
    return tv_fgp_sharded(x, n_iter, lam, group, dual_dtype), tv(x, group)


def tv_gd(x: torch.Tensor, ng: int, dpocs, group: SlabGroup | None = None,
          compat: str = "global"):
    """`ng` normalised TV-subgradient steps ``x -= dpocs g / ||g||_2``
    (global norm, no eps), then positivity, of a slice-last 3D volume, or
    of this rank's slab with a group (K9c on the periodic ring).

    Returns (x_new, tv_of_input), as ``tomojax.tv.tv_gd`` does for 3D
    inputs. dpocs is a float or a 0-dim tensor on x's device; the norm
    stays on the device (K7, K9c), so the steps never wait for the host.

    compat='reference-mpi' with a group reproduces the reference's
    multi-rank TV-GD (``tomojax.tv._tv_gd_reference_mpi``): every rank
    descends its slab as an independent periodic volume (K7 on the slab)
    normalised by its local norm, and the returned TV value is the sum of
    the slabs' local periodic TVs. Its result depends on the number of
    ranks, on purpose; without a group, or with one rank, it is the
    default."""
    if x.dim() != 3:
        raise ValueError(f"tv_gd takes a 3D volume, got {tuple(x.shape)}")
    if compat not in COMPAT:
        raise ValueError(f"compat must be one of {COMPAT}: {compat!r}")
    if group is None or compat == "global":
        tv0 = tv(x, group)
        if group is not None:
            return tv_gd_sharded(x, ng, dpocs, group), tv0
    else:
        tv0 = all_reduce_sum(tv_value(x), group)
    for _ in range(ng):
        g, gsq = tv_grad(x)
        x = x - dpocs * g / torch.sqrt(gsq)
    return torch.clamp_min(x, 0.0), tv0


__all__ = ["EPS_TV", "tv", "tv_fgp", "tv_fgp_fused", "tv_fgp_sharded",
           "tv_gd", "tv_gd_sharded", "tv_grad", "tv_value"]
