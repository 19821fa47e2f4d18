"""The Joseph projector's share of its roofline over the projector calls
one job of the cell makes (tomojax_torch.projector.cuda_joseph: K1 with
and without its residual epilogue, K2 with and without its SIRT update),
each timed by CUDA events at its own shapes on its own data."""

from benchmark import layers, work

MODULE = "tomojax_torch.projector.cuda_joseph"
CAPTURE = {(MODULE, name): work.WORK[name]
           for name in ("fp_sl", "fp_resid_sl", "bp_sl", "bp_sirt_sl")}


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return layers.roofline_pct(ctx.calls, CAPTURE)
