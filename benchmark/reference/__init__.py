"""The plain reference of each timed entry, one file each
(``reference/<name>.py``, found by the name a traffic file gives it).
Each file's ``run(inputs, solvers, device, dtype)`` takes the inputs the
benchmark handed to the program (host numpy arrays and angles in
degrees), the configuration's keyword arguments of every call
(``solvers``), a device and a data type, and returns the outputs the
harness compares, as float64 numpy arrays under the names the program's
outputs have. This package holds what they share.

Nothing here imports jax, tomojax or tomojax_torch (a benchmark test
checks this).
"""

from __future__ import annotations

import numpy as np
import torch

# the atomic numbers of the elements the configurations use
PERIODIC_Z = {"c": 6, "o": 8, "ti": 22, "zn": 30, "sr": 38}


def sinogram(series: np.ndarray, device, dt) -> torch.Tensor:
    """(Nslice, Nray, Nangles) -> slice-last (Nangles, Nray, Nslice)."""
    t = torch.as_tensor(np.ascontiguousarray(
        np.transpose(np.asarray(series, np.float32), (2, 1, 0))))
    return t.to(device=device, dtype=dt)


def volume(x_sl: torch.Tensor) -> np.ndarray:
    """Slice-last (..., N, N, Ns) -> (..., Ns, N, N) float64 numpy."""
    return x_sl.movedim(-1, -3).double().cpu().numpy()
