"""Carry system weights, fusion systems and FISTA state across from the
reference package.

Takes numpy arrays only (``np.asarray`` of the JAX arrays), so it imports
no JAX. The reference's slice-last FISTA state pads its sinogram fields
to (na_pad, nt, ns_pad) for its TPU kernels (na_pad = na rounded up to
16, ns_pad = ns rounded up to the kernels' slice block); the port's state
is unpadded, so the padding is cut off here.

For slab-sharded runs, `slab_from_numpy` cuts one rank's z-slab out of
the reference's whole arrays, so that a test feeds both packages the same
slabs.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.dist import SlabGroup, pad_slices, shard_global
from tomojax_torch.fusion import FusionSystem
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


def fusion_system_from_numpy(haadf_sys, chem_sys, weights, gamma: float,
                             l_aps, l_asig, device) -> FusionSystem:
    """A FusionSystem from the reference's arrays: haadf_sys and chem_sys
    are each (Geometry, row_sum, col_sum, lipschitz) as `system_from_numpy`
    takes them, weights (Nel,), l_aps and l_asig scalars."""
    return FusionSystem(
        system_from_numpy(*haadf_sys, device), system_from_numpy(*chem_sys,
                                                                 device),
        _tensor(np.asarray(weights).reshape(-1), device), float(gamma),
        _tensor(np.asarray(l_aps).reshape(()), device),
        _tensor(np.asarray(l_asig).reshape(()), device))


def sart_weights_from_numpy(inv_col_a, device) -> torch.Tensor:
    """The (Na, N, N) per-angle inverse column sums of the reference's
    ``make_sart_weights`` as a contiguous float32 tensor on `device`."""
    w = np.asarray(inv_col_a)
    if w.ndim != 3 or w.shape[1] != w.shape[2]:
        raise ValueError(f"inv_col_a: shape {w.shape}, expected (Na, N, N)")
    return _tensor(w, device)


def exp_sart_weights(na: int, nt: int, n: int):
    """The random SART weights of the reference's SART experiments
    (scripts/exp_sart_pipeline.py:429-431, exp_sart_ablate.py:217-219):
    ``default_rng(1)``, inv_row (Na, Nt) drawn first, then inv_col_a
    (Na, N, N); float32 numpy arrays."""
    rng = np.random.default_rng(1)
    inv_row = rng.random((na, 1, nt)).astype(np.float32).reshape(na, nt)
    return inv_row, rng.random((na, n, n)).astype(np.float32)


def slab_from_numpy(a, group: SlabGroup, axis: int) -> torch.Tensor:
    """This rank's slab of the whole array `a` (float32 on the group's
    device), `axis` first padded with zero slices to a multiple of the
    group size, as ``TomoTorch`` and ``tomojax.dist.pad_slices`` pad it."""
    padded, _ = pad_slices(torch.from_numpy(np.asarray(a, np.float32)),
                           group, axis)
    return shard_global(padded, group, axis)


def state_sl_from_numpy(x, x_old, yk, t, ax_pad, resid_pad, na: int,
                        ns: int, device,
                        group: SlabGroup | None = None) -> FistaStateSL:
    """A FistaStateSL from the reference's slice-last state: volumes
    (N, N, Ns) as they are, ax and resid cut from (na_pad, Nt, ns_pad) to
    (na, Nt, ns). With a group: this rank's slabs of them (on the group's
    device; `device` is not read)."""
    ax = np.asarray(ax_pad)[:na, :, :ns]
    resid = np.asarray(resid_pad)[:na, :, :ns]
    if group is not None:
        device = group.device

    def field(a) -> torch.Tensor:
        return (_tensor(a, device) if group is None
                else slab_from_numpy(a, group, 2))

    return FistaStateSL(
        x=field(x), x_old=field(x_old), yk=field(yk),
        t=_tensor(np.asarray(t).reshape(()), device), ax=field(ax),
        resid=field(resid))
