"""The device's idle share over whole reconstruction jobs, from the
profiler's trace: 1 - (union of device-busy intervals) / (the span from
the first job's first host call to the last job's return), in %."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct
