"""One disk per element, the same in every slice (the chemistry
quickstart's phantom): element e is 1 where (x - cx n)^2 + (y - cy n)^2
< (r n)^2, for its centre (cx, cy) and radius r as fractions of the side
n. Returns (Nel, Ns, N, N) float32 on the device."""

from __future__ import annotations

import torch


def make(spec: dict, nslice: int, n: int, device) -> torch.Tensor:
    yy, xx = torch.meshgrid(torch.arange(n, dtype=torch.float64),
                            torch.arange(n, dtype=torch.float64),
                            indexing="ij")
    out = torch.zeros((len(spec["radii"]), nslice, n, n),
                      dtype=torch.float32)
    for e, ((cx, cy), r) in enumerate(zip(spec["centres"], spec["radii"])):
        disk = (xx - cx * n) ** 2 + (yy - cy * n) ** 2 < (r * n) ** 2
        out[e, :, disk] = 1.0
    return out.to(device)
