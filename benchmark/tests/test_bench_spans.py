"""The four readers of the program's spans and counters on a synthetic
store: the hand-computed value on the card with a trace, None off the
card, without a trace, where the port has no recorder and where the
store dropped spans."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark import harness

MS = 1_000_000  # ns


def _span(name, sid, parent, root, start_ms, end_ms, inner_ms=0,
          **counts):
    return types.SimpleNamespace(name=name, id=sid, parent=parent,
                                 root=root, start_ns=start_ms * MS,
                                 end_ns=end_ms * MS, inner_ns=inner_ms * MS,
                                 counts=counts)


# Two jobs in a 0.5 s window. Job 1: construction 0-40 ms (a sinogram of
# 20, a copy of 5, a system of 10, their entries and exits 1: 4 of its
# own), the method 40-200 (two iterations of 60 with a read of 2 reads
# each, a cost read of 30, their entries and exits 2: 8 of its own),
# get_recon 200-240 (a copy of 35: 5 of its own). Job 2: the method
# 300-400 alone (one iteration of 90 with 3 reads: 10 of its own).
JOBS = [
    _span("api.sinogram", 2, 1, 1, 0, 20),
    _span("api.h2d", 3, 1, 1, 20, 25),
    _span("api.system", 4, 1, 1, 25, 35, plan_builds=2),
    _span("api.TomoTorch", 1, None, 1, 0, 40, inner_ms=1),
    _span("solvers.read", 7, 6, 5, 90, 95, reads=2),
    _span("solvers.iteration", 6, 5, 5, 40, 100),
    _span("solvers.iteration", 8, 5, 5, 100, 160, reads=2),
    _span("api.d2h", 9, 5, 5, 160, 190, reads=1),
    _span("api.fista", 5, None, 5, 40, 200, inner_ms=2),
    _span("api.d2h", 11, 10, 10, 200, 235, reads=1),
    _span("api.get_recon", 10, None, 10, 200, 240),
    _span("solvers.iteration", 13, 12, 12, 300, 390, reads=3),
    _span("api.asd_pocs", 12, None, 12, 300, 400),
]
# host: 4 + 20 + 5 + 10 (construction), 8 (fista), 5 (get_recon), 10
# (asd_pocs) = 62 ms; the waits (api.d2h), the solvers' spans and the
# children's entries and exits are not the api's host work
JOBS_HOST_PCT = 100.0 * 0.062 / 0.5
JOBS_READS_PER_ITER = (2 + 2 + 1 + 1 + 3) / 3

# Two tilt updates in a 0.1 s window, each a new angle set: add 0-1 ms,
# the round 1-40 (a system of 6 with 3 plan builds, a fill of 2, one
# iteration of 25 with its read, their entries and exits 1: 5 of its
# own); the second the same 50 ms later with 2 plan builds.
LIVE = []
for k, t0 in enumerate((0, 50)):
    i = 10 * k
    LIVE += [
        _span("api.add_projections", i + 1, None, i + 1, t0, t0 + 1),
        _span("api.system", i + 3, i + 2, i + 2, t0 + 1, t0 + 7,
              plan_builds=3 - k),
        _span("api.fill", i + 4, i + 2, i + 2, t0 + 7, t0 + 9),
        _span("solvers.read", i + 6, i + 5, i + 2, t0 + 30, t0 + 34,
              reads=1),
        _span("solvers.iteration", i + 5, i + 2, i + 2, t0 + 9, t0 + 34),
        _span("api.iterate_cs", i + 2, None, i + 2, t0 + 1, t0 + 40,
              inner_ms=1),
    ]
LIVE_HOST_PCT = 100.0 * 2 * (1 + 6 + 2 + 5) / 1e3 / 0.1
LIVE_BUILDS_PER_UPDATE = 5 / 2

READERS = {
    "api.host_pct.recon": (JOBS, 0.5, JOBS_HOST_PCT),
    "solvers.reads_per_iter.recon": (JOBS, 0.5, JOBS_READS_PER_ITER),
    "api.host_pct.live": (LIVE, 0.1, LIVE_HOST_PCT),
    "projector.plan_builds_per_update.live": (LIVE, 0.1,
                                              LIVE_BUILDS_PER_UPDATE),
}


@pytest.fixture
def store(monkeypatch):
    """The port's store replaced by a synthetic one."""
    from tomojax_torch import profiling

    fake = types.SimpleNamespace(spans=[], spans_dropped=0)
    monkeypatch.setattr(profiling, "recorded", lambda: fake)
    return fake


def _ctx(window_s, device="cuda", traced=True):
    trace = types.SimpleNamespace(window_s=window_s) if traced else None
    return types.SimpleNamespace(trace=trace, calls={},
                                 device=torch.device(device))


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_gives_the_hand_computed_value(store, metric):
    spans, window_s, want = READERS[metric]
    store.spans = list(spans)
    got = harness.reader(metric).read(_ctx(window_s))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_gives_none_off_the_card_and_without_a_trace(store, metric):
    spans, window_s, _ = READERS[metric]
    store.spans = list(spans)
    read = harness.reader(metric).read
    assert read(_ctx(window_s, device="cpu")) is None
    assert read(_ctx(window_s, traced=False)) is None


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_gives_none_where_nothing_was_recorded(store, metric,
                                                      monkeypatch):
    spans, window_s, _ = READERS[metric]
    read = harness.reader(metric).read
    assert read(_ctx(window_s)) is None  # an empty store
    store.spans, store.spans_dropped = list(spans), 1
    assert read(_ctx(window_s)) is None  # the window's record is cut
    from tomojax_torch import profiling

    monkeypatch.delattr(profiling, "recorded")  # a port without a recorder
    assert read(_ctx(window_s)) is None


def test_counter_readers_give_none_without_their_denominator(store):
    store.spans = [s for s in JOBS if s.name != "solvers.iteration"]
    assert harness.reader("solvers.reads_per_iter.recon").read(
        _ctx(0.5)) is None
    store.spans = list(JOBS)
    assert harness.reader("projector.plan_builds_per_update.live").read(
        _ctx(0.5)) is None
