"""Matched forward/back projector pair (counterpart of
``tomojax.projector``): the public slice-first ``fp``/``bp`` and the
slice-last kernel wrappers K1 (``fp_resid_sl``, ``fp_sl``) and K2
(``bp_sirt_sl``, ``bp_sl``)."""

from tomojax_torch.projector.cuda_joseph import (
    bp_sirt_sl,
    bp_sl,
    fp_resid_sl,
    fp_sl,
)
from tomojax_torch.projector.joseph import (
    bp,
    bp_adjointable,
    fp,
    fp_adjointable,
)

__all__ = ["fp", "bp", "fp_adjointable", "bp_adjointable", "fp_sl",
           "fp_resid_sl", "bp_sl", "bp_sirt_sl"]
