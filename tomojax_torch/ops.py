"""Elementwise and reduction volume ops (counterparts of tomojax.ops), and
Poisson noise."""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.dist import all_reduce_sum, slab


def positivity(x: torch.Tensor) -> torch.Tensor:
    """Clamp negatives to zero."""
    return torch.clamp_min(x, 0.0)


def set_background(x: torch.Tensor, value: float) -> torch.Tensor:
    """Fill exact zeros with `value`."""
    return torch.where(x == 0.0, torch.as_tensor(value, dtype=x.dtype,
                                                 device=x.device), x)


def soft_threshold(x: torch.Tensor, lam) -> torch.Tensor:
    """sign(x) max(|x| - lam, 0)."""
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - lam, 0.0)


def nesterov(xk: torch.Tensor, xk_old: torch.Tensor, beta) -> torch.Tensor:
    """y = x + beta (x - x_old)."""
    return xk + beta * (xk - xk_old)


def norm2(x: torch.Tensor) -> torch.Tensor:
    """Frobenius norm sqrt(sum x^2)."""
    return torch.sqrt(torch.sum(x * x))


def l1_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x))


def euclidean_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(sum (a - b)^2)."""
    d = a - b
    return torch.sqrt(torch.sum(d * d))


def rmse(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error against ground truth."""
    d = x - ref
    return torch.sqrt(torch.mean(d * d))


def rmse_per_element(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-element RMSE (Nel,) of 4D (Nel, ...) stacks."""
    d = x - ref
    return torch.sqrt(torch.mean(d * d, dim=tuple(range(1, x.dim()))))


def data_distance(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unnormalised ||g - b||_F between model and measured projections."""
    d = g - b
    return torch.sqrt(torch.sum(d * d))


def _slice_first_host(b: torch.Tensor) -> np.ndarray:
    """A slice-last (Na, Nt, Ns) sinogram as a C-contiguous float32 numpy
    copy in the reference's slice-first layout (Ns, Na, Nt)."""
    return np.array(b.detach().permute(2, 0, 1).cpu().numpy(), np.float32,
                    order="C")


def _slice_last(noisy: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(noisy).permute(1, 2, 0).contiguous().to(
        like.device)


def slab_seed(seed: int, offsets) -> int:
    """The seed of a slab whose first element lies at `offsets` (slice-first
    indices) of the whole sinogram, by the reference's formula
    (tomojax/ops.py:104-107)."""
    sseed = int(seed) & 0x7FFFFFFF
    for o in offsets:
        sseed = (sseed * 1000003 + int(o) * 7919 + 1) & 0x7FFFFFFF
    return sseed


def poisson_slab(b_host: np.ndarray, scale: float, seed: int) -> np.ndarray:
    """Poisson counts at mean b * scale, scaled back: numpy's
    ``default_rng(seed).poisson`` drawn in b_host's C order (a
    C-contiguous float32 slice-first array)."""
    rng = np.random.default_rng(seed)
    return (rng.poisson(b_host * scale) / scale).astype(np.float32)


def poisson_noise_slab(b: torch.Tensor, n_counts: int, seed: int,
                       total: float, size: int, start: int) -> torch.Tensor:
    """One rank's part of `poisson_noise` with a group: b its slice-last
    slab, total and size the whole sinogram's sum and element count, start
    the slab's first slice. Draws over the slab in slice-first C order
    with the seed of `slab_seed` at offsets (start, 0, 0)."""
    scale = n_counts * size / total
    return _slice_last(poisson_slab(_slice_first_host(b), scale,
                                    slab_seed(seed, (start, 0, 0))), b)


def poisson_noise(b: torch.Tensor, n_counts: int, seed: int = 0,
                  group=None) -> torch.Tensor:
    """Poisson-corrupt a slice-last sinogram (Na, Nt, Ns) at a mean count
    level (counterpart of ``tomojax.ops.poisson_noise``, the reference's
    tomoengine.cpp:471-484): scale so that the mean count is `n_counts`
    (scale = n_counts * size / sum), draw Poisson counts, scale back.
    Returns a new float32 tensor on b's device.

    The sampling runs on the host, as the reference runs it by design
    (jax.random.poisson at high counts was a rejection sampler that took
    minutes on the TPU): numpy's ``default_rng(seed & 0x7FFFFFFF)``, the
    reference's numpy branch (``jax.random.key_data(PRNGKey(s))[-1]`` is
    s). numpy draws in the array's C order, so the draws run over a
    C-contiguous float32 copy in the reference's slice-first layout
    (Ns, Na, Nt), and the total is that copy's sum (numpy's pairwise sum
    depends on the memory order): the result equals the reference's numpy
    branch bit for bit. The reference's other host branch (its native
    module, std::poisson over OpenMP threads) depends on the thread count
    and is not reproducible; the port does not imitate it.

    With a group (the reference's sharded branch, tomojax/ops.py:97-114):
    b is this rank's slab (slices [rank Ns, (rank + 1) Ns) of a sinogram
    padded to equal slabs); the float32 sum is all-reduced over the group
    (the reference's psum), the size is the whole sinogram's, and each
    rank draws over its own slab (`poisson_noise_slab`). The noise then
    depends on the slab layout, as the reference's does on its shards'."""
    if group is None:
        host = _slice_first_host(b)
        total = float(host.sum())
        scale = n_counts * host.size / total
        return _slice_last(poisson_slab(host, scale, int(seed) & 0x7FFFFFFF),
                           b)
    total_t = torch.sum(b.to(device=group.device, dtype=torch.float32))
    total = float(all_reduce_sum(total_t, group))
    if total <= 0:
        return b
    return poisson_noise_slab(b, n_counts, seed, total,
                              b.numel() * group.size,
                              slab(b.shape[2] * group.size, group).lo)
