"""Weighted/filtered backprojection (counterpart of
``tomojax/solvers/wbp.py``).

One filter over the detector axis of the whole sinogram
(``projector/filters.filter_sinogram``: ``torch.fft``), one
backprojection (K2, epilogue off), the angular integration factor
dtheta = ptp(angles) / (Na - 1) (pi for a single angle), then the
positivity clamp. ``fbp_sl`` works slice-last; ``fbp`` takes the
reference's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import bp_sl
from tomojax_torch.projector.filters import filter_sinogram
from tomojax_torch.solvers.fista import from_sl, to_sl


def angular_step(geom: Geometry) -> float:
    """The mean angular spacing ptp(angles) / (Na - 1), pi for one angle:
    the Riemann weight of the backprojection (the reference's wbp.py)."""
    if geom.nproj > 1:
        return float(np.ptp(geom.angles)) / (geom.nproj - 1)
    return np.pi


def fbp_sl(b: torch.Tensor, geom: Geometry, filter_name: str = "ram-lak",
           apply_positivity: bool = True) -> torch.Tensor:
    """b (Na, Nt, Ns) -> (N, N, Ns)."""
    q = filter_sinogram(b, filter_name)
    x = bp_sl(q.contiguous(), geom) * angular_step(geom)
    return torch.clamp_min(x, 0.0) if apply_positivity else x


def fbp(b: torch.Tensor, geom: Geometry, filter_name: str = "ram-lak",
        apply_positivity: bool = True) -> torch.Tensor:
    """`fbp_sl` in the reference's layout: b (Ns, Na, Nt) -> (Ns, N, N)."""
    return from_sl(fbp_sl(to_sl(b.to(torch.float32)), geom, filter_name,
                          apply_positivity))
