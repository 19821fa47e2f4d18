"""Reconstruction solvers (counterpart of ``tomojax.solvers``); this
slice of the port holds the system weights and slice-last FISTA-TV."""

from tomojax_torch.solvers.base import System, make_system
from tomojax_torch.solvers.fista import (
    FistaStateSL,
    fista_init_sl,
    fista_run_sl,
    fista_step_sl,
    from_sl,
    to_sl,
)

__all__ = [
    "System",
    "make_system",
    "FistaStateSL",
    "fista_init_sl",
    "fista_run_sl",
    "fista_step_sl",
    "to_sl",
    "from_sl",
]
