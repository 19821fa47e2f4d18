"""Reconstruction solvers (counterpart of ``tomojax.solvers``): the system
weights, FISTA-TV (slice-last, and the slice-first wrappers), SIRT, the
SART and ART sweeps, CGLS, Poisson-ML, the least-squares step, FBP and
ASD-POCS."""

from tomojax_torch.solvers.asd_pocs import (
    AsdPocsParams,
    asd_pocs_host_loop,
    asd_pocs_iteration,
    asd_pocs_run,
    data_distance_sl,
)
from tomojax_torch.solvers.base import (
    System, bp_single_angle, make_system, row_norms_sq,
)
from tomojax_torch.solvers.cuda_art import art_sweep_sl
from tomojax_torch.solvers.cuda_sart import sart_sweep_sl
from tomojax_torch.solvers.fista import (
    FistaState,
    FistaStateSL,
    fista_init,
    fista_run,
    fista_step,
    fista_init_sl,
    fista_run_sl,
    fista_step_sl,
    from_sl,
    to_sl,
)
from tomojax_torch.solvers.iterative import (
    POISSON_EPS,
    art_sweep,
    cgls_run,
    cgls_run_sl,
    least_squares_step,
    make_sart_weights,
    poisson_ml_step,
    poisson_ml_step_sl,
    sart_sweep,
    sirt_sweep,
    sirt_sweep_sl,
)
from tomojax_torch.solvers.wbp import fbp, fbp_sl

__all__ = [
    "System",
    "make_system",
    "bp_single_angle",
    "row_norms_sq",
    "FistaState",
    "fista_init",
    "fista_run",
    "fista_step",
    "FistaStateSL",
    "fista_init_sl",
    "fista_run_sl",
    "fista_step_sl",
    "to_sl",
    "from_sl",
    "make_sart_weights",
    "sart_sweep",
    "sart_sweep_sl",
    "sirt_sweep",
    "sirt_sweep_sl",
    "art_sweep",
    "art_sweep_sl",
    "cgls_run",
    "cgls_run_sl",
    "fbp",
    "fbp_sl",
    "POISSON_EPS",
    "poisson_ml_step",
    "poisson_ml_step_sl",
    "least_squares_step",
    "AsdPocsParams",
    "asd_pocs_iteration",
    "asd_pocs_host_loop",
    "asd_pocs_run",
    "data_distance_sl",
]
