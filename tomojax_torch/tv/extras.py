"""Extra TV denoisers: Chambolle dual projection and Split-Bregman
(counterpart of ``tomojax/tv/extras.py``).

The reference runs both as XLA loops with no Pallas kernel, so they are
plain PyTorch here, on whatever device the volume lies; only their TV
value of the input goes through ``tv.tv`` (K5 on the card).

  * chambolle: A. Chambolle, "An algorithm for total variation
    minimization and applications" (2004), the fixed-point dual iteration
    p <- (p + tau grad(div p - x/lam)) / (1 + tau |...|); denoised =
    x - lam div(p).
  * split_bregman: Goldstein & Osher, "The split Bregman method for
    L1-regularized problems" (2009), anisotropic TV by a few gradient
    steps on the quadratic subproblem, shrinkage and Bregman updates.

Both take a volume (..., n0, n1, n2), a 3D volume or a 4D (Nel, ...)
stack, and apply one zero-flux rule on each of the last three axes, so
they give the same result under a permutation of those axes: the port's
slice-last volumes and stacks run here as they are, and their result is
the reference's on the slice-first layout, permuted. Only the float32
summation order of the three axes' terms differs.
"""

from __future__ import annotations

import torch

from tomojax_torch.tv import tv
from tomojax_torch.tv.cuda_fgp import _bdiff, _fdiff


def _axes(x: torch.Tensor):
    a = x.dim()
    return a - 3, a - 2, a - 1


def _grad3(x, ax):
    return tuple(_fdiff(x, a) for a in ax)


def _div3(p1, p2, p3, ax):
    return _bdiff(p1, ax[0]) + _bdiff(p2, ax[1]) + _bdiff(p3, ax[2])


def tv_chambolle(x: torch.Tensor, n_iter: int = 20, lam: float = 0.1,
                 tau: float = 1.0 / 12.0):
    """Chambolle-projection TV denoise. Returns (denoised, tv_of_input)."""
    ax = _axes(x)
    tv0 = tv(x)
    p1 = p2 = p3 = torch.zeros_like(x)
    for _ in range(n_iter):
        # Chambolle's `div` is the negative transpose of the gradient;
        # _div3 is the positive one, hence the signs.
        g1, g2, g3 = _grad3(-_div3(p1, p2, p3, ax) - x / lam, ax)
        denom = 1.0 + tau * torch.sqrt(g1 * g1 + g2 * g2 + g3 * g3)
        p1 = (p1 + tau * g1) / denom
        p2 = (p2 + tau * g2) / denom
        p3 = (p3 + tau * g3) / denom
    return x + lam * _div3(p1, p2, p3, ax), tv0


def _shrink(v: torch.Tensor, t: float) -> torch.Tensor:
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)


def tv_split_bregman(x: torch.Tensor, n_iter: int = 10, lam: float = 0.1,
                     mu: float = 2.0, n_inner: int = 2, nonneg: bool = True):
    """Split-Bregman anisotropic-TV denoise of x: min_u lam sum|grad u|_1 +
    0.5 ||u - x||^2 by the splitting d = grad u with penalty mu. Returns
    (denoised, tv_of_input)."""
    ax = _axes(x)
    tv0 = tv(x)
    z = torch.zeros_like(x)
    u, d, b = x, (z, z, z), (z, z, z)
    for _ in range(n_iter):
        # (I + mu grad^T grad) u = x + mu div(d - b), by n_inner gradient
        # steps of size 1 / (1 + 6 mu)
        rhs_div = _div3(*(dk - bk for dk, bk in zip(d, b)), ax)
        for _ in range(n_inner):
            lap = _div3(*_grad3(u, ax), ax)
            u = u - ((u - x) + mu * (lap - rhs_div)) / (1.0 + 6.0 * mu)
        if nonneg:
            u = torch.clamp_min(u, 0.0)
        g = _grad3(u, ax)
        d = tuple(_shrink(gk + bk, lam / mu) for gk, bk in zip(g, b))
        b = tuple(bk + gk - dk for bk, gk, dk in zip(b, g, d))
    return u, tv0


__all__ = ["tv_chambolle", "tv_split_bregman"]
