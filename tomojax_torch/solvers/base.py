"""Precomputed per-geometry weights (counterpart of
``tomojax/solvers/base.py``).

One weight set serves every slice, as in the reference: row sums A 1
over the sinogram plane, column sums A^T 1 over the image plane, and the
Lipschitz estimate max(A^T A 1). The port keeps them without the
reference's leading batch axis: ``row_sum`` is (Na, Nt) and ``col_sum``
(N, N).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

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
