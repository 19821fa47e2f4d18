"""The projector's per-geometry tables built per tilt update: the
program's ``plan_builds`` (cache misses of ``angle_tables`` and K1's
plan) counted in the traced window, over its ``api.iterate_cs`` calls."""

from benchmark import spans


def read(ctx):
    got = spans.window_spans(ctx)
    return (None if got is None
            else spans.per_span(got, "plan_builds", "api.iterate_cs"))
