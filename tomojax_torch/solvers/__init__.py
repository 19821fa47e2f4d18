"""Reconstruction solvers (counterpart of ``tomojax.solvers``); the port
holds so far the system weights, slice-last FISTA-TV, the SART sweep and
ASD-POCS."""

from tomojax_torch.solvers.asd_pocs import (
    AsdPocsParams,
    asd_pocs_host_loop,
    asd_pocs_iteration,
    asd_pocs_run,
    data_distance_sl,
)
from tomojax_torch.solvers.base import System, bp_single_angle, make_system
from tomojax_torch.solvers.cuda_sart import sart_sweep_sl
from tomojax_torch.solvers.fista import (
    FistaStateSL,
    fista_init_sl,
    fista_run_sl,
    fista_step_sl,
    from_sl,
    to_sl,
)
from tomojax_torch.solvers.iterative import make_sart_weights, sart_sweep

__all__ = [
    "System",
    "make_system",
    "bp_single_angle",
    "FistaStateSL",
    "fista_init_sl",
    "fista_run_sl",
    "fista_step_sl",
    "to_sl",
    "from_sl",
    "make_sart_weights",
    "sart_sweep",
    "sart_sweep_sl",
    "AsdPocsParams",
    "asd_pocs_iteration",
    "asd_pocs_host_loop",
    "asd_pocs_run",
    "data_distance_sl",
]
