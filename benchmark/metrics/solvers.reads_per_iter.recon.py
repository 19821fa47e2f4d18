"""Blocking device-to-host reads per solver iteration over whole
reconstruction jobs: the program's ``reads`` counted in the traced
window, over its ``solvers.iteration`` spans."""

from benchmark import spans


def read(ctx):
    got = spans.window_spans(ctx)
    return (None if got is None
            else spans.per_span(got, "reads", "solvers.iteration"))
