"""Total-variation value, subgradient descent and FGP prox (counterpart
of ``tomojax.tv``).

Semantics are the reference's (``tomojax/tv/__init__.py``): the TV value
is isotropic with periodic wrap and eps = 1e-6; TV-GD takes normalised
steps along the periodic 4-term subgradient with the global norm; the FGP
prox uses the zero-boundary divergence/gradient chain, dual step
1/(26 lam), no dual momentum, a nonnegativity clamp and the isotropic
dual-ball projection. All dispatch by device inside their kernel wrappers
(plain PyTorch on the CPU, the CUDA kernels on the card).
"""

from __future__ import annotations

import torch

from tomojax_torch.tv.cuda_fgp import tv_fgp_fused
from tomojax_torch.tv.cuda_tv_value import EPS_TV, tv_value
from tomojax_torch.tv.cuda_tvgd import tv_grad


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


def tv_gd(x: torch.Tensor, ng: int, dpocs):
    """`ng` normalised TV-subgradient steps ``x -= dpocs g / ||g||_2``
    (global norm, no eps), then positivity, of a slice-last 3D volume.

    Returns (x_new, tv_of_input), as ``tomojax.tv.tv_gd`` does for 3D
    inputs. dpocs is a float or a 0-dim tensor on x's device; the norm
    stays on the device (K7), so the steps never wait for the host."""
    if x.dim() != 3:
        raise ValueError(f"tv_gd takes a 3D volume, got {tuple(x.shape)}")
    tv0 = tv(x)
    for _ in range(ng):
        g, gsq = tv_grad(x)
        x = x - dpocs * g / torch.sqrt(gsq)
    return torch.clamp_min(x, 0.0), tv0


__all__ = ["EPS_TV", "tv", "tv_fgp", "tv_fgp_fused", "tv_gd", "tv_grad",
           "tv_value"]
