"""The api layer's host work over whole reconstruction jobs: the self
time of the program's ``api.*`` spans that are not waits (the sinogram's
transpose and normalisation, the copy to the card, the system, the
methods' own Python) over the traced window, in %."""

from benchmark import spans


def read(ctx):
    got = spans.window_spans(ctx)
    if got is None:
        return None
    return spans.api_host_pct(got, ctx.trace.window_s)
