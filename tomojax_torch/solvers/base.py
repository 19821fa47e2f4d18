"""Precomputed per-geometry weights (counterpart of
``tomojax/solvers/base.py``).

One weight set serves every slice, as in the reference: row sums A 1
over the sinogram plane, column sums A^T 1 over the image plane, and the
Lipschitz estimate max(A^T A 1). The port keeps them without the
reference's leading batch axis: ``row_sum`` is (Na, Nt) and ``col_sum``
(N, N). ``bp_single_angle`` gives the per-angle column sums that SART
weights its steps with (``solvers/iterative.make_sart_weights``), and
``row_norms_sq`` the Cimmino SIRT's row weights.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import bp_sl, fp_sl

_WEIGHT_EPS = 1e-6


def _safe_inv(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w > _WEIGHT_EPS,
                       1.0 / torch.clamp_min(w, _WEIGHT_EPS), 0.0)


@dataclasses.dataclass(frozen=True)
class System:
    """Geometry plus its SIRT weights, all on one device."""

    geom: Geometry
    row_sum: torch.Tensor  # (Na, Nt) = A 1 (ray lengths)
    col_sum: torch.Tensor  # (N, N) = A^T 1
    lipschitz: torch.Tensor  # 0-dim: max(A^T A 1)

    @cached_property
    def inv_row(self) -> torch.Tensor:
        return _safe_inv(self.row_sum)

    @cached_property
    def inv_col(self) -> torch.Tensor:
        return _safe_inv(self.col_sum)


def make_system(geom: Geometry, device) -> System:
    """SIRT weights and the Lipschitz estimate on `device` (one FP, two
    BPs of a single slice)."""
    device = torch.device(device)
    f32 = torch.float32
    ones_img = torch.ones((geom.n, geom.n, 1), dtype=f32, device=device)
    row = fp_sl(ones_img, geom)  # (Na, Nt, 1)
    ones_sino = torch.ones((geom.nproj, geom.nray, 1), dtype=f32,
                           device=device)
    col = bp_sl(ones_sino, geom)
    lip = torch.max(bp_sl(row, geom))
    return System(geom, row[:, :, 0].contiguous(), col[:, :, 0].contiguous(),
                  lip)


def row_norms_sq(geom: Geometry, device) -> torch.Tensor:
    """Per-ray squared row norms ||a_r||^2 of the Joseph operator, (Na, Nt)
    float32 on `device`: the Cimmino weights M = diag(1/||a_r||^2)
    (counterpart of ``tomojax/solvers/base.py:row_norms_sq``, the same
    float64 arithmetic from the interpolation weights, no image data)."""
    n, nt = geom.n, geom.nray
    out = np.zeros((geom.nproj, nt), np.float32)
    tj = np.arange(nt) - (nt - 1) / 2.0
    ctr = (n - 1) / 2.0
    steps = np.arange(n, dtype=np.float64)
    for a in range(geom.nproj):
        c, s = geom.cos[a], geom.sin[a]
        if geom.row_driven[a]:
            denom, shear, coord = c, -s / c, ctr - steps
            pos = tj[:, None] / denom + coord[None, :] * shear + ctr
        else:
            denom, shear, coord = s, c / s, steps - ctr
            pos = ctr - tj[:, None] / denom + coord[None, :] * shear
        f = np.floor(pos)
        frac = pos - f
        i0 = f.astype(np.int64)
        w0 = np.where((i0 >= 0) & (i0 < n), 1.0 - frac, 0.0)
        w1 = np.where((i0 + 1 >= 0) & (i0 + 1 < n), frac, 0.0)
        out[a] = ((w0**2 + w1**2).sum(1) / denom**2).astype(np.float32)
    return torch.as_tensor(out, device=torch.device(device))


def bp_single_angle(y: torch.Tensor, cosv, sinv, n: int) -> torch.Tensor:
    """Backprojection of one angle per row of ``y``: (B, Nt) -> (B, N, N).

    Counterpart of ``tomojax/solvers/base.py:bp_single_angle``, with the
    same float32 arithmetic (D = max(|cos|, |sin|) and 1/D in float32).
    cosv and sinv are 0-dim (every row at that angle) or (B,) tensors or
    numbers (row b at angle b); ``bp_single_angle(ones((Na, Nt)), cos,
    sin, n)`` gives all Na per-angle column sums at once."""
    f32 = torch.float32
    nb, nt = y.shape
    cosv = torch.as_tensor(cosv, dtype=f32, device=y.device).reshape(-1, 1, 1)
    sinv = torch.as_tensor(sinv, dtype=f32, device=y.device).reshape(-1, 1, 1)
    xc = torch.arange(n, dtype=f32, device=y.device) - (n - 1) / 2.0
    yr = (n - 1) / 2.0 - torch.arange(n, dtype=f32, device=y.device)
    invd = 1.0 / torch.maximum(cosv.abs(), sinv.abs())
    jstar = cosv * xc[None, None, :] + sinv * yr[None, :, None] + (nt - 1) / 2.0
    j0 = torch.floor(jstar).to(torch.int64)
    j1 = j0 + 1
    w0 = torch.clamp_min(1.0 - torch.abs(j0 - jstar) * invd, 0.0) * invd
    w1 = torch.clamp_min(1.0 - torch.abs(j1 - jstar) * invd, 0.0) * invd
    w0 = torch.where((j0 >= 0) & (j0 < nt), w0, 0.0)
    w1 = torch.where((j1 >= 0) & (j1 < nt), w1, 0.0)

    def gather(j):  # y[b, j[b or 0, r, c]] -> (B, N, N)
        idx = j.clamp(0, nt - 1).reshape(j.shape[0], n * n).expand(nb, -1)
        return torch.gather(y, 1, idx).reshape(nb, n, n)

    return gather(j0) * w0 + gather(j1) * w1
