"""The SART sweep's share of its roofline over the sweeps one job of the
cell makes (tomojax_torch.solvers.cuda_sart.sart_sweep_sl, K8), timed by
CUDA events: torch.profiler under-reads K8's cluster kernel."""

from benchmark import layers, work

CAPTURE = {("tomojax_torch.solvers.cuda_sart", "sart_sweep_sl"):
           work.WORK["sart_sweep_sl"]}


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return layers.roofline_pct(ctx.calls, CAPTURE)
