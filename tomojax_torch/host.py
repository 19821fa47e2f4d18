"""The port's host boundary: the device a reconstructor is built on, the
series' copy to it (with a group, only this rank's slab crosses) and the
only reads of a value back to the host (`to_host`, `read_scalars`), each
in its span and counted as one ``reads``; a result's read lands in
pinned memory (`to_host`)."""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch import profiling
from tomojax_torch.dist import SlabGroup, slab


def device(device, group: SlabGroup | None, owner: str) -> torch.device:
    """The group's device, or torch.device(device), "cuda" when None;
    raises for both, and for CUDA where torch finds none (no automatic
    move to the CPU)."""
    if group is not None:
        if device is not None:
            raise ValueError("pass a device or a group, not both: a group's "
                             "tensors live on group.device")
        device = group.device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}(device='cuda'): torch finds no CUDA device; pass "
            f"device='cpu' to run the plain PyTorch versions")
    return device


def host_series(a) -> np.ndarray:
    """`a` as a C-contiguous float32 numpy array: `a` itself where it is
    one, else a host copy, counted in "series_host_copies"."""
    h = np.ascontiguousarray(a, np.float32)
    if not (isinstance(a, np.ndarray) and np.may_share_memory(a, h)):
        profiling.count("series_host_copies")
    return h


def series_to_device(series: list, shape: tuple, device: torch.device,
                     group: SlabGroup | None) -> torch.Tensor:
    """The host series (each float32 numpy of `shape`, slices on axis 0)
    stacked on `device` in that layout: (len(series), *shape). With a
    group, only this rank's slab of the slices crosses (`dist.slab`): its
    pad slices are zeroed on the device."""
    s = slab(shape[0], group)
    out = torch.empty((len(series), s.n, *shape[1:]), dtype=torch.float32,
                      device=device)
    for o, h in zip(out, series):
        o[:s.real].copy_(torch.from_numpy(h[s.lo:s.lo + s.real]))
    if s.real < s.n:
        out[:, s.real:].zero_()
    return out


PINNED_MIN_BYTES = 1 << 20  # a CUDA read this large lands in pinned memory


def to_host(t: torch.Tensor) -> np.ndarray:
    """`t` as host numpy, with the shape, dtype, strides and values that
    ``t.cpu().numpy()`` gives: one read, in an "api.d2h" span (a wait for
    the device's queue, then the copy).

    A CUDA tensor of at least `PINNED_MIN_BYTES` (a result volume or
    sinogram) is copied into page-locked memory from torch's process-wide
    host cache, at the link's speed, and counted in "d2h_pinned". The
    returned array owns that block: it goes back to the cache only when
    the caller drops the array's last reference, and a later read reuses
    it. The cache rounds a block up to a power of two and keeps the
    page-locked memory for the process's life, so a caller who keeps k
    results holds about k such blocks (up to twice their bytes).
    Smaller reads (costs, single values) are bound by latency and stay on
    ``t.cpu()``'s pageable route."""
    with profiling.annotate("api.d2h"):
        profiling.count("reads")
        if t.is_cuda and t.numel() * t.element_size() >= PINNED_MIN_BYTES:
            profiling.count("d2h_pinned")
            out = torch.empty_like(t, device="cpu", pin_memory=True)
            return out.copy_(t).numpy()
        return t.cpu().numpy()


def read_scalars(*ts: torch.Tensor) -> tuple[float, ...]:
    """The 0-dim tensors `ts` as Python floats, each the float that
    ``float(t)`` gives: one read of them stacked, in a "solvers.read"
    span."""
    with profiling.annotate("solvers.read"):
        profiling.count("reads")
        return tuple(torch.stack(ts).cpu().tolist())
