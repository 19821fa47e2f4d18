"""Carry system weights and FISTA state across from the reference package.

Takes numpy arrays only (``np.asarray`` of the JAX arrays), so it imports
no JAX. The reference's slice-last FISTA state pads its sinogram fields
to (na_pad, nt, ns_pad) for its TPU kernels (na_pad = na rounded up to
16, ns_pad = ns rounded up to the kernels' slice block); the port's state
is unpadded, so the padding is cut off here.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.geometry import Geometry
from tomojax_torch.solvers.base import System
from tomojax_torch.solvers.fista import FistaStateSL


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def system_from_numpy(geom: Geometry, row_sum, col_sum, lipschitz,
                      device) -> System:
    """A System from the reference's weights: row_sum (1, Na, Nt) or
    (Na, Nt), col_sum (1, N, N) or (N, N), lipschitz a scalar."""
    row = np.asarray(row_sum).reshape(geom.nproj, geom.nray)
    col = np.asarray(col_sum).reshape(geom.n, geom.n)
    return System(geom, _tensor(row, device), _tensor(col, device),
                  _tensor(np.asarray(lipschitz).reshape(()), device))


def sart_weights_from_numpy(inv_col_a, device) -> torch.Tensor:
    """The (Na, N, N) per-angle inverse column sums of the reference's
    ``make_sart_weights`` as a contiguous float32 tensor on `device`."""
    w = np.asarray(inv_col_a)
    if w.ndim != 3 or w.shape[1] != w.shape[2]:
        raise ValueError(f"inv_col_a: shape {w.shape}, expected (Na, N, N)")
    return _tensor(w, device)


def state_sl_from_numpy(x, x_old, yk, t, ax_pad, resid_pad, na: int,
                        ns: int, device) -> FistaStateSL:
    """A FistaStateSL from the reference's slice-last state: volumes
    (N, N, Ns) as they are, ax and resid cut from (na_pad, Nt, ns_pad) to
    (na, Nt, ns)."""
    ax = np.asarray(ax_pad)[:na, :, :ns]
    resid = np.asarray(resid_pad)[:na, :, :ns]
    return FistaStateSL(
        x=_tensor(x, device), x_old=_tensor(x_old, device),
        yk=_tensor(yk, device),
        t=_tensor(np.asarray(t).reshape(()), device),
        ax=_tensor(ax, device), resid=_tensor(resid, device))
