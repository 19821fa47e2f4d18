"""Total-variation value and FGP prox (counterpart of ``tomojax.tv``).

Semantics are the reference's (``tomojax/tv/__init__.py``): the TV value
is isotropic with periodic wrap and eps = 1e-6; the FGP prox uses the
zero-boundary divergence/gradient chain, dual step 1/(26 lam), no dual
momentum, a nonnegativity clamp and the isotropic dual-ball projection.
Both dispatch by device inside their kernel wrappers (plain PyTorch on
the CPU, the CUDA kernels on the card).
"""

from __future__ import annotations

import torch

from tomojax_torch.tv.cuda_fgp import tv_fgp_fused
from tomojax_torch.tv.cuda_tv_value import EPS_TV, tv_value


def tv(x: torch.Tensor) -> torch.Tensor:
    """Isotropic periodic TV of a 3D volume, or the summed per-element TV
    of a 4D (Nel, ...) stack (0-dim tensor)."""
    if x.dim() == 4:
        return torch.stack([tv_value(xe) for xe in x]).sum()
    return tv_value(x)


def tv_fgp(x: torch.Tensor, n_iter: int, lam: float, dual_dtype=None):
    """Reference-faithful FGP TV denoise of a 3D volume.

    Returns (denoised, tv_of_input), as ``tomojax.tv.tv_fgp`` does. The
    duals are stored as ``dual_dtype`` (default config.fgp_dual_dtype,
    bfloat16); pass torch.float32 for the reference's all-f32 result."""
    return tv_fgp_fused(x, n_iter, lam, dual_dtype), tv(x)


__all__ = ["EPS_TV", "tv", "tv_fgp", "tv_fgp_fused", "tv_value"]
