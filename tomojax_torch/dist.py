"""Z-slab decomposition over ``torch.distributed`` (counterpart of
``tomojax/dist.py``).

The volume is split on its slice axis into one contiguous slab per rank,
as the reference's MPI ranks split it (mpi_astra_ctvlib.cpp:53-64) and
as ``tomojax`` shards it over a 1-D ``'z'`` mesh. Rank r of a group of
size R holds slices ``[r n_loc, (r + 1) n_loc)`` of the volume padded to
a multiple of R (`slab`). The port keeps every slab slice-last, so a
rank's volume is (N, N, n_loc) and its sinogram (Na, Nt, n_loc):

* the data term (FP, BP, the SART sweep) treats slices as a batch and runs
  on each slab unchanged;
* the TV stencils cross slab boundaries only through one (N, N) plane per
  field and direction: `halo_exchange` moves it, as a chain with zeros at
  both ends (the FGP prox's zero boundary) or a periodic ring (TV value,
  TV-GD);
* scalars (||A x - b||^2, the TV value, ||g||^2, the ASD-POCS norms) are
  per-slab partial sums made whole by `all_reduce_sum`, on the device.

There is no global mesh state: the functions that shard take a
`SlabGroup` (``group=``), the counterpart of ``config.mesh_scope``. Every
rank of a group must make the same calls in the same order; the solvers
branch only on all-reduced values, which every rank reads alike.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

_RIGHTWARD, _LEFTWARD = 1, 2  # P2P tags: planes sent to rank + 1 / rank - 1


@dataclasses.dataclass(frozen=True)
class SlabGroup:
    """The ranks of the default process group, which share one volume, one
    slab each, and this rank's device."""

    rank: int
    size: int
    device: torch.device

    def neighbours(self, ring: bool):
        """(left, right) ranks; None past the ends of a chain."""
        left, right = self.rank - 1, self.rank + 1
        if ring:
            return left % self.size, right % self.size
        return (left if left >= 0 else None,
                right if right < self.size else None)


def init_distributed(init_method: str, world_size: int, rank: int,
                     device="cuda") -> SlabGroup:
    """Join the default process group (replaces MPI_Init,
    mpi_astra_ctvlib.cpp:48) and return it as a SlabGroup.

    init_method: a rendezvous URL every rank is given, e.g.
    ``"tcp://localhost:29500"`` or ``"file:///path/to/new/file"``.
    device: "cuda" (this rank's card: ``cuda:<rank % device_count>``, or
    the index given), joined over NCCL, or "cpu", joined over gloo."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank)
    return SlabGroup(dist.get_rank(), dist.get_world_size(), device)


Slab = NamedTuple("Slab", [("lo", int), ("n", int), ("real", int)])


def slab(ns: int, group: SlabGroup | None) -> Slab:
    """This rank's slab of `ns` slices: the axis padded with zero slices at
    the high end to a multiple of the group size and cut into one
    contiguous block per rank, in rank order (without a group, the whole
    axis). Its first slice `lo`, its length `n` and its `real` slices,
    the first of the block, below `ns` (the rest are padding)."""
    if group is None:
        return Slab(0, ns, ns)
    n = -(-ns // group.size)
    lo = group.rank * n
    return Slab(lo, n, max(0, min(n, ns - lo)))


def pad_slices(x: torch.Tensor, group: SlabGroup, axis: int = 0):
    """Zero slices at the high end of `axis` up to a multiple of the group
    size (``tomojax.dist.pad_slices``). Returns (padded, original count).

    The periodic TV wrap then couples the last real slice to a zero slice
    instead of slice 0; see ``TomoTorch``."""
    ns = x.shape[axis]
    pad = slab(ns, group).n * group.size - ns
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    return x, ns


def unpad_slices(x: torch.Tensor, ns: int, axis: int = 0) -> torch.Tensor:
    return torch.narrow(x, axis, 0, ns)


def shard_global(x, group: SlabGroup, axis: int = 0) -> torch.Tensor:
    """This rank's slab of a host array (numpy or tensor) that every rank
    holds in full (``tomojax.dist.shard_global``), as a contiguous float32
    tensor on the group's device. `axis` must divide by the group size:
    pad first (`pad_slices`)."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    n = x.shape[axis]
    if n % group.size:
        raise ValueError(f"axis {axis} of length {n} does not divide into "
                         f"{group.size} slabs; pad_slices first")
    s = slab(n, group)
    part = torch.narrow(x, axis, s.lo, s.n)
    return part.to(device=group.device, dtype=torch.float32).contiguous()


def gather_slabs(x: torch.Tensor, group: SlabGroup,
                 axis: int = 0) -> torch.Tensor:
    """The whole array on every rank: the slabs of all ranks concatenated
    on `axis` in rank order (all_gather)."""
    x = x.contiguous()
    if group.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=axis)


def all_reduce_sum(t: torch.Tensor, group: SlabGroup) -> torch.Tensor:
    """Sum `t` over the group, in place on its device (no host read: on
    CUDA the collective is queued behind the current stream's work).
    Returns `t`."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_max(t: torch.Tensor, group: SlabGroup) -> torch.Tensor:
    """The maximum of `t` over the group, in place on its device, as
    `all_reduce_sum` does the sum. Returns `t`."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def _bytes(t: torch.Tensor) -> torch.Tensor:
    # gloo refuses some dtypes (bfloat16) for P2P; bytes travel anywhere
    return t.view(torch.uint8)


def halo_exchange(lo: torch.Tensor | None, hi: torch.Tensor | None,
                  group: SlabGroup, ring: bool = False):
    """Swap boundary planes with the slab neighbours.

    lo: this rank's low boundary plane(s), sent to the left neighbour;
    hi: its high boundary plane(s), sent to the right neighbour. Either may
    be None, and nothing then moves in that direction. Every rank passes
    planes of the same shapes and dtypes. Returns (from_left, from_right):
    the left neighbour's hi (None when hi is None) and the right
    neighbour's lo (None when lo is None). On a chain (ring=False) the
    ends receive zeros, as ``lax.ppermute`` gives shards with no source;
    on a ring rank 0's left neighbour is rank size - 1. Planes are
    contiguous tensors on the group's device and travel in their own
    dtype, with batch_isend_irecv between distinct ranks; at size 1 the
    ring returns the rank's own planes, with no collective."""
    if ring and group.size == 1:
        return hi, lo
    left, right = group.neighbours(ring)
    from_left = from_right = None
    ops = []
    # Sends first, hi before lo, then receives from the left before the
    # right: on a ring of two both neighbours are one peer, and then the
    # order of posting alone pairs each send with its receive, as NCCL,
    # which ignores tags, needs. The CPU tests show the order suffices over
    # gloo with every tag equal; no run over NCCL between two cards has
    # tried it yet.
    if hi is not None and right is not None:
        ops.append(dist.P2POp(dist.isend, _bytes(hi), right, tag=_RIGHTWARD))
    if lo is not None and left is not None:
        ops.append(dist.P2POp(dist.isend, _bytes(lo), left, tag=_LEFTWARD))
    if hi is not None:
        if left is None:
            from_left = torch.zeros_like(hi)
        else:
            from_left = torch.empty_like(hi)
            ops.append(dist.P2POp(dist.irecv, _bytes(from_left), left,
                                  tag=_RIGHTWARD))
    if lo is not None:
        if right is None:
            from_right = torch.zeros_like(lo)
        else:
            from_right = torch.empty_like(lo)
            ops.append(dist.P2POp(dist.irecv, _bytes(from_right), right,
                                  tag=_LEFTWARD))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


def process_zero_value(x, group: SlabGroup):
    """Rank 0's value of `x` on every rank (the reference's rank-0
    broadcast, mpi_logger.py:176-180): a tensor on the group's device, or
    any picklable host value."""
    if group.size == 1:
        return x
    if torch.is_tensor(x):
        t = x.clone()
        dist.broadcast(t, src=0)
        return t
    box = [x]
    dist.broadcast_object_list(box, src=0)
    return box[0]
