"""The FGP TV prox's share of its roofline over the prox calls one job of
the cell makes (tomojax_torch.tv.cuda_fgp.tv_fgp_fused: FISTA's prox with
its Nesterov step, or each element's prox of the fusion's 4D TV), timed
by CUDA events at their shapes, with the duals in the type the program
stores them."""

from benchmark import layers, work

CAPTURE = {("tomojax_torch.tv.cuda_fgp", "tv_fgp_fused"):
           work.WORK["tv_fgp_fused"]}


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return layers.roofline_pct(ctx.calls, CAPTURE)
