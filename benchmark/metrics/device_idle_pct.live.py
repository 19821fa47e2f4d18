"""The device's idle share over consecutive tilt updates, from the
profiler's trace: 1 - (union of device-busy intervals) / (the span from
the first update's first host call to the last update's return), in %."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct
