"""Elementwise and reduction volume ops (counterparts of tomojax.ops)."""

from __future__ import annotations

import torch


def positivity(x: torch.Tensor) -> torch.Tensor:
    """Clamp negatives to zero."""
    return torch.clamp_min(x, 0.0)


def set_background(x: torch.Tensor, value: float) -> torch.Tensor:
    """Fill exact zeros with `value`."""
    return torch.where(x == 0.0, torch.as_tensor(value, dtype=x.dtype,
                                                 device=x.device), x)


def nesterov(xk: torch.Tensor, xk_old: torch.Tensor, beta) -> torch.Tensor:
    """y = x + beta (x - x_old)."""
    return xk + beta * (xk - xk_old)


def rmse(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error against ground truth."""
    d = x - ref
    return torch.sqrt(torch.mean(d * d))


def rmse_per_element(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-element RMSE (Nel,) of 4D (Nel, ...) stacks."""
    d = x - ref
    return torch.sqrt(torch.mean(d * d, dim=tuple(range(1, x.dim()))))


def data_distance(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unnormalised ||g - b||_F between model and measured projections."""
    d = g - b
    return torch.sqrt(torch.sum(d * d))
