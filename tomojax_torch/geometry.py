"""Parallel-beam tilt-series geometry (numpy only).

Same conventions as ``tomojax.geometry`` (the reference package), which
cannot be imported here because importing ``tomojax`` imports JAX:

  * a 2D slice image is ``(N, N)`` with row ``r`` (top row = 0) and column
    ``c``; pixel centres sit at ``x = c - (N-1)/2`` and ``y = (N-1)/2 - r``;
  * detector bin ``j`` has offset ``t_j = j - (Nray-1)/2`` and a point
    projects to ``t = x cos(theta) + y sin(theta)``;
  * angles are radians; trig values below 1e-12 in magnitude are zeroed so
    that 0/90/180-degree views take exactly one driving axis.

The port keeps the whole state slice-last, ``(N, N, Ns)`` volumes and
``(Na, Nray, Ns)`` sinograms, so that the slice axis is the contiguous
axis the CUDA kernels vectorise over.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static description of a batched 2D parallel-beam tilt geometry.

    Attributes:
      n: image side.
      nray: detector bins per projection (== n unless given).
      angles_key: tuple of float angles in radians (hashable form).
    """

    n: int
    nray: int
    angles_key: tuple

    @staticmethod
    def make(n: int, angles_rad, nray: int | None = None) -> "Geometry":
        angles = np.asarray(angles_rad, dtype=np.float64).reshape(-1)
        return Geometry(
            n=int(n),
            nray=int(nray) if nray is not None else int(n),
            angles_key=tuple(float(a) for a in angles),
        )

    @cached_property
    def angles(self) -> np.ndarray:
        return np.asarray(self.angles_key, dtype=np.float64)

    @property
    def nproj(self) -> int:
        return len(self.angles_key)

    @cached_property
    def cos(self) -> np.ndarray:
        c = np.cos(self.angles)
        c[np.abs(c) < 1e-12] = 0.0
        return c

    @cached_property
    def sin(self) -> np.ndarray:
        s = np.sin(self.angles)
        s[np.abs(s) < 1e-12] = 0.0
        return s

    @cached_property
    def row_driven(self) -> np.ndarray:
        """True per angle when |cos| >= |sin|: the Joseph projector then
        steps over image rows and interpolates along columns."""
        return np.abs(self.cos) >= np.abs(self.sin)

    @cached_property
    def driving(self) -> np.ndarray:
        """D_a = max(|cos|, |sin|), the Joseph footprint scale per angle."""
        return np.maximum(np.abs(self.cos), np.abs(self.sin))

    @property
    def det_center(self) -> float:
        return (self.nray - 1) / 2.0

    @property
    def img_center(self) -> float:
        return (self.n - 1) / 2.0

    @cached_property
    def perm(self) -> np.ndarray:
        """Permutation putting row-driven angles first."""
        return np.concatenate(
            [np.nonzero(self.row_driven)[0], np.nonzero(~self.row_driven)[0]]
        )

    @cached_property
    def inv_perm(self) -> np.ndarray:
        inv = np.empty(self.nproj, dtype=np.int64)
        inv[self.perm] = np.arange(self.nproj)
        return inv

    def with_angles(self, angles_rad) -> "Geometry":
        """New geometry with a different angle set (streaming mode)."""
        return Geometry.make(self.n, angles_rad, self.nray)

    def extended(self, new_angles_rad) -> "Geometry":
        """Append angles (the reference's tomoengine.cpp:130-149 grows
        Nproj)."""
        allang = np.concatenate([self.angles, np.atleast_1d(new_angles_rad)])
        return Geometry.make(self.n, allang, self.nray)
