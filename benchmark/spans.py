"""The program's own spans and counters over the traced window
(``tomojax_torch.profiling``), for the per-layer metrics of the api,
solvers and projector layers.

While a torch profiler runs, the port records a span at each layer
boundary it crosses (``api.*``, ``solvers.*``, ``tv.*``), on the
profiler's host clock, with the counts made inside it (``reads``,
``plan_builds``) and the time its children's instrumentation took
outside their stamps (``inner_ns``). Only the traced window runs the
profiler, so the store holds that window's spans. Each reader gives None
off the card, without a trace, where the port records no spans (a port
without the recorder) and where the store dropped some of the window's
spans.
"""

from __future__ import annotations

import collections

WAITS = ("api.d2h",)  # api spans that wait for the device's queue


def window_spans(ctx):
    """The traced window's spans, or None where there is nothing to read."""
    if ctx.device.type != "cuda" or ctx.trace is None:
        return None
    from tomojax_torch import profiling
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    store = recorded()
    if store.spans_dropped:
        return None
    return list(store.spans) or None


def api_host_pct(spans, window_s: float):
    """The self time of the api spans that are not waits, over the window,
    in %: a span's duration less its direct child spans and less the
    entries and exits of those children (``inner_ns``), so that the count
    of spans does not move it."""
    inner = collections.defaultdict(int)
    for s in spans:
        if s.parent is not None:
            inner[s.parent] += s.end_ns - s.start_ns
    host = sum(s.end_ns - s.start_ns - inner[s.id] - s.inner_ns
               for s in spans
               if s.name.startswith("api.") and s.name not in WAITS)
    return 100.0 * host / 1e9 / window_s


def per_span(spans, counter: str, name: str):
    """The counts of `counter` over all spans, per span named `name`; None
    where no span has that name."""
    n = sum(s.name == name for s in spans)
    if not n:
        return None
    return sum(s.counts.get(counter, 0) for s in spans) / n
