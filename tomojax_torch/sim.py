"""Simulation utilities (counterpart of ``tomojax/sim.py``).

The phantoms are the reference's numpy code, so the same seed gives the
same volume in both packages. ``create_projections`` forward-projects a
volume without noise; Poisson noise (snr != 0) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.joseph import fp


def shepp_logan(n: int) -> np.ndarray:
    """Standard Shepp-Logan head phantom on an n x n grid (row 0 = top)."""
    # (A, a, b, x0, y0, phi_deg) -- classic parameter set.
    ellipses = [
        (1.0, 0.69, 0.92, 0.0, 0.0, 0),
        (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0),
        (-0.2, 0.11, 0.31, 0.22, 0.0, -18),
        (-0.2, 0.16, 0.41, -0.22, 0.0, 18),
        (0.1, 0.21, 0.25, 0.0, 0.35, 0),
        (0.1, 0.046, 0.046, 0.0, 0.1, 0),
        (0.1, 0.046, 0.046, 0.0, -0.1, 0),
        (0.1, 0.046, 0.023, -0.08, -0.605, 0),
        (0.1, 0.023, 0.023, 0.0, -0.606, 0),
        (0.1, 0.023, 0.046, 0.06, -0.605, 0),
    ]
    c = np.linspace(-1, 1, n, endpoint=True)
    xx, yy = np.meshgrid(c, -c)  # y axis up
    img = np.zeros((n, n), np.float32)
    for amp, a, b, x0, y0, phi in ellipses:
        th = np.deg2rad(phi)
        xr = (xx - x0) * np.cos(th) + (yy - y0) * np.sin(th)
        yr = -(xx - x0) * np.sin(th) + (yy - y0) * np.cos(th)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += amp
    return img


def nanocube_phantom(nslice: int, n: int, seed: int = 0) -> np.ndarray:
    """Synthetic 'nanocube' 3D phantom (Ns, N, N): a few random
    axis-aligned cubes from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    vol = np.zeros((nslice, n, n), np.float32)
    for _ in range(6):
        cz, cy, cx = rng.integers(
            [nslice // 4, n // 4, n // 4],
            [3 * nslice // 4, 3 * n // 4, 3 * n // 4],
        )
        h = int(rng.integers(max(2, n // 12), max(3, n // 6)))
        amp = float(rng.uniform(0.5, 1.0))
        vol[
            max(0, cz - h) : cz + h,
            max(0, cy - h) : cy + h,
            max(0, cx - h) : cx + h,
        ] += amp
    return vol


def create_projections(volume: torch.Tensor, geom: Geometry,
                       snr: int = 0) -> torch.Tensor:
    """Forward-project a ground-truth (Ns, N, N) volume, on its own
    device, into a noiseless (Ns, Na, Nt) float32 sinogram."""
    if snr:
        raise NotImplementedError("Poisson noise (snr != 0) is not ported "
                                  "yet; pass snr=0")
    return fp(volume.to(torch.float32).contiguous(), geom)
