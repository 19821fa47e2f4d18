"""TV-GD's share of its roofline over the descent calls one job of the
cell makes (tomojax_torch.tv.cuda_tvgd.tv_descent: ng normalised
subgradient steps, K7 and the step kernel), timed by CUDA events."""

from benchmark import layers, work

CAPTURE = {("tomojax_torch.tv.cuda_tvgd", "tv_descent"):
           work.WORK["tv_descent"]}


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return layers.roofline_pct(ctx.calls, CAPTURE)
