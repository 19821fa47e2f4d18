"""The api layer's host work over consecutive tilt updates: the self time
of the program's ``api.*`` spans that are not waits (each tilt's new
system, the buffer's fill, the rounds' own Python) over the traced
window, in %."""

from benchmark import spans


def read(ctx):
    got = spans.window_spans(ctx)
    if got is None:
        return None
    return spans.api_host_pct(got, ctx.trace.window_s)
