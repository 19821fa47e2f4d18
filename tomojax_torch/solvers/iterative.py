"""SART weights and sweep in the public layout (counterpart of the SART
part of ``tomojax/solvers/iterative.py``).

The sweep itself runs slice-last in ``solvers/cuda_sart.py`` (K8); this
module converts at the boundary: x (Ns, N, N) and b (Ns, Na, Nt), as the
reference takes them.
"""

from __future__ import annotations

import torch

from tomojax_torch.solvers.base import System, _safe_inv, bp_single_angle
from tomojax_torch.solvers.cuda_sart import sart_sweep_sl
from tomojax_torch.solvers.fista import from_sl, to_sl


def make_sart_weights(sys: System) -> torch.Tensor:
    """Per-angle inverse column sums (Na, N, N) on sys's device: the
    one-angle backprojection of a ones sinogram for every angle at once,
    inverted where it exceeds 1e-6 and 0 elsewhere."""
    geom = sys.geom
    ones = torch.ones((geom.nproj, geom.nray), dtype=torch.float32,
                      device=sys.row_sum.device)
    return _safe_inv(bp_single_angle(ones, geom.cos, geom.sin, geom.n))


def sart_sweep(x: torch.Tensor, b: torch.Tensor, sys: System,
               inv_col_a: torch.Tensor, beta=1.0,
               order=None) -> torch.Tensor:
    """One ordered pass over the angle blocks (ASTRA SART ``run(Nproj)``).

    x (Ns, N, N); b (Ns, Na, Nt); inv_col_a from `make_sart_weights`;
    beta a float or 0-dim tensor; order None (sequential) or the (Na,)
    angle visiting order (any integer sequence). Returns the new
    (Ns, N, N) volume."""
    dev = x.device
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    if order is None:
        order = torch.arange(sys.geom.nproj, dtype=torch.int32, device=dev)
    order = torch.as_tensor(order, device=dev).to(torch.int32).contiguous()
    out = sart_sweep_sl(to_sl(x.to(torch.float32)), to_sl(b), sys.geom,
                        sys.inv_row, inv_col_a, beta, order)
    return from_sl(out)
