"""User-facing reconstructor (counterpart of ``tomojax.api.TomoTPU``).

    from tomojax_torch import TomoTorch
    tomo = TomoTorch(tilt_angles_deg, tilt_series)   # device="cuda"
    tomo.fista(Niter=50, lambda_param=0.1)
    recon = tomo.get_recon()                         # (Nslice, Nray, Nray)

The tilt series is (Nslice, Nray, Nangles), as in the reference. Every
tensor lives on the device given at construction: there is no automatic
device choice, and device="cuda" on a machine without CUDA raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.geometry import Geometry
from tomojax_torch.solvers import (
    fista_init_sl,
    fista_run_sl,
    from_sl,
    make_system,
)


class TomoTorch:
    """Batched tilt-series reconstructor on one device."""

    def __init__(self, tilt_angles_deg, tilt_series=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TomoTorch(device='cuda'): torch finds no CUDA device; "
                "pass device='cpu' to run the plain PyTorch versions")
        self.tilt_angles = np.asarray(tilt_angles_deg, np.float64)
        self.recon = None
        self.cost = None
        if tilt_series is not None:
            self.set_tilt_series(tilt_series)

    def set_tilt_series(self, tilt_series):
        """(Nslice, Nray, Nangles), tilt axis on dim 0."""
        ts = np.asarray(tilt_series, np.float32)
        if ts.ndim != 3 or ts.shape[2] != len(self.tilt_angles):
            raise ValueError(
                f"tilt series {ts.shape} must be (Nslice, Nray, Nangles) "
                f"with Nangles = {len(self.tilt_angles)}")
        self.Nslice, self.Nray, self.Nangles = ts.shape
        self.geom = Geometry.make(self.Nray, np.deg2rad(self.tilt_angles))
        self.sys = make_system(self.geom, self.device)
        # slice-last sinogram (Nangles, Nray, Nslice)
        self.b_sl = torch.as_tensor(
            np.ascontiguousarray(ts.transpose(2, 1, 0)), device=self.device)
        self.restart_recon()

    def restart_recon(self):
        self.x = torch.zeros((self.Nslice, self.Nray, self.Nray),
                             dtype=torch.float32, device=self.device)
        self.recon = None

    def fista(self, Niter: int = 100, momentum: bool = True,
              lambda_param: float = 0.1, nTViter: int = 10,
              show_convergence: bool = True, compat: str = "correct"):
        """FISTA-TV from zero (solvers/fista.py). With show_convergence,
        ``self.cost`` holds the per-iteration cost 0.5 dd^2 + lam tv,
        read from the device once at the end."""
        self.restart_recon()
        st = fista_init_sl(self.x, self.sys, self.b_sl)
        st, metrics = fista_run_sl(st, self.b_sl, self.sys, lambda_param,
                                   Niter, nTViter, momentum, compat,
                                   compute_metrics=show_convergence)
        self.cost = metrics[:, 0].cpu().numpy()
        self.x = from_sl(st.x)
        return self

    def get_recon(self) -> np.ndarray:
        """The reconstruction, (Nslice, Nray, Nray) float32 numpy."""
        if self.recon is None:
            self.recon = self.x.cpu().numpy()
        return self.recon
