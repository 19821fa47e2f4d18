"""The STO nanocube: a frozen copy of the generator of
``tomojax_torch.sim``, six axis-aligned cubes drawn from
``numpy.random.default_rng(seed)``, filled on the device. The spec's
``seed`` gives one volume (Ns, N, N); its ``seeds`` give one per element
(Nel, Ns, N, N)."""

from __future__ import annotations

import numpy as np
import torch


def cube(nslice: int, n: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    vol = torch.zeros((nslice, n, n), dtype=torch.float32, device=device)
    for _ in range(6):
        cz, cy, cx = rng.integers(
            [nslice // 4, n // 4, n // 4],
            [3 * nslice // 4, 3 * n // 4, 3 * n // 4],
        )
        h = int(rng.integers(max(2, n // 12), max(3, n // 6)))
        amp = float(rng.uniform(0.5, 1.0))
        vol[max(0, cz - h):cz + h, max(0, cy - h):cy + h,
            max(0, cx - h):cx + h] += amp
    return vol


def make(spec: dict, nslice: int, n: int, device) -> torch.Tensor:
    if "seeds" in spec:
        return torch.stack([cube(nslice, n, s, device)
                            for s in spec["seeds"]])
    return cube(nslice, n, spec["seed"], device)
