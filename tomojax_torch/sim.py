"""Simulation utilities (counterpart of ``tomojax/sim.py``).

The phantoms are the reference's numpy code, so the same seed gives the
same volume in both packages. ``create_projections`` forward-projects a
volume (K1) and, with snr != 0, fills its zero voxels with a background
of 1 first and applies Poisson noise at count level snr
(``ops.poisson_noise``), as the reference's simulation path does.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch import ops
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import fp_sl


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


def create_projections(volume: torch.Tensor, geom: Geometry, snr: int = 0,
                       seed: int = 0) -> torch.Tensor:
    """Forward-project a ground-truth (Ns, N, N) volume, on its own device,
    into an (Ns, Na, Nt) float32 sinogram. With snr != 0, zero voxels are
    first set to a background of 1 and Poisson noise at count level snr is
    drawn on the host from `seed` (``ops.poisson_noise``)."""
    vol = volume.to(torch.float32)
    if snr:
        vol = ops.set_background(vol, 1.0)
    b = fp_sl(vol.permute(1, 2, 0).contiguous(), geom)
    if snr:
        b = ops.poisson_noise(b, snr, seed)
    return b.permute(2, 0, 1).contiguous()
