"""Kernel launches per SART sweep over whole reconstruction jobs: the
program's ``sart_launches`` counted in the traced window, over its
``solvers.sart`` spans (one a sweep of K8, tomojax_torch.solvers.
cuda_sart.sart_sweep_sl). 1 on the resident route, 2 a tilt step on the
streaming route: the number names the route the cell's shape takes."""

from benchmark import spans


def read(ctx):
    got = spans.window_spans(ctx)
    return (None if got is None
            else spans.per_span(got, "sart_launches", "solvers.sart"))
