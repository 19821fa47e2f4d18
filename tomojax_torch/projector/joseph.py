"""Matched Joseph projector pair in the public slice-first layout.

Counterpart of ``tomojax/projector/joseph.py``: ``fp`` maps (Ns, N, N)
volumes to (Ns, Nproj, Nray) sinograms and ``bp`` is its exact transpose.
Both use the closed form of that module's docstring,

    W[a, j, r, c] = hat((j - J*)/D_a) / D_a,
    J*[a, r, c]   = x_c cos_a + y_r sin_a + (Nray-1)/2,
    D_a           = max(|cos_a|, |sin_a|),

which holds at most two nonzero taps per (pixel, angle), so both operators
are 2-point gathers. The work happens slice-last in
``projector/cuda_joseph.py``: the plain gathers on the CPU, kernels K1
and K2 with their epilogues off on the card. ``fp_adjointable`` and
``bp_adjointable`` are the same operators for autograd, each
differentiated by the other (the reference's ``jax.custom_vjp`` pair).
"""

from __future__ import annotations

import torch

from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import bp_sl, fp_sl


def fp(x: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Forward projection A x : (Ns, N, N) -> (Ns, Nproj, Nray)."""
    ax = fp_sl(x.permute(1, 2, 0).contiguous(), geom)
    return ax.permute(2, 0, 1).contiguous()


def bp(y: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Matched backprojection A^T y : (Ns, Nproj, Nray) -> (Ns, N, N)."""
    aty = bp_sl(y.permute(1, 2, 0).contiguous(), geom)
    return aty.permute(2, 0, 1).contiguous()


class _FpAdjointable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, geom):
        ctx.geom = geom
        return fp(x, geom)

    @staticmethod
    def backward(ctx, g):
        return bp(g, ctx.geom), None


class _BpAdjointable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, geom):
        ctx.geom = geom
        return bp(y, geom)

    @staticmethod
    def backward(ctx, g):
        return fp(g, ctx.geom), None


def fp_adjointable(x: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """`fp` whose gradient is `bp` of the output's gradient."""
    return _FpAdjointable.apply(x, geom)


def bp_adjointable(y: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """`bp` whose gradient is `fp` of the output's gradient."""
    return _BpAdjointable.apply(y, geom)
