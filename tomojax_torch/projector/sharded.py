"""The projector pair on a z-slab of a sharded volume (counterpart of
``tomojax/projector/sharded.py``).

The data term is parallel over slices: the reference's MPI slabs exchange
nothing for FP/BP (mpi_astra_ctvlib.cpp:211-231), and ``tomojax`` runs
its kernel per shard under ``shard_map``. Here each rank holds its slab
(the slices [r n_loc, (r + 1) n_loc) of the volume padded to a multiple of
the group size, ``dist.pad_slices``) and runs K1 or K2 on it; no
collective is needed.
"""

from __future__ import annotations

import torch

from tomojax_torch.dist import SlabGroup, slab
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.joseph import bp, fp


def _check_slab(t: torch.Tensor, group: SlabGroup, tail: tuple,
                nslice: int | None, name: str) -> None:
    """Raise unless `t` is a (n_loc, *tail) slab on the group's device,
    with n_loc = ceil(nslice / group.size) where `nslice` is given."""
    n_loc = None if nslice is None else slab(nslice, group).n
    if (t.device != group.device or t.dim() != 3
            or tuple(t.shape[1:]) != tail
            or (n_loc is not None and t.shape[0] != n_loc)):
        want = "n_loc" if n_loc is None else n_loc
        raise ValueError(f"{name} must be this rank's slab ({want}, *{tail}) "
                         f"on {group.device}, got {tuple(t.shape)} on "
                         f"{t.device}")


def fp_sharded(x: torch.Tensor, geom: Geometry, group: SlabGroup,
               nslice: int | None = None) -> torch.Tensor:
    """A x of this rank's slice-first slab: (n_loc, N, N) ->
    (n_loc, Nproj, Nray), K1 on the card. With `nslice`, the global slice
    count before padding, the slab must hold ceil(nslice / group.size)
    slices, the group's cut; without it only the trailing shape and the
    device are checked."""
    _check_slab(x, group, (geom.n, geom.n), nslice, "x")
    return fp(x, geom)


def bp_sharded(y: torch.Tensor, geom: Geometry, group: SlabGroup,
               nslice: int | None = None) -> torch.Tensor:
    """A^T y of this rank's slice-first sinogram slab: (n_loc, Nproj, Nray)
    -> (n_loc, N, N), K2 on the card; `nslice` as in `fp_sharded`."""
    _check_slab(y, group, (geom.nproj, geom.nray), nslice, "y")
    return bp(y, geom)


__all__ = ["fp_sharded", "bp_sharded"]
