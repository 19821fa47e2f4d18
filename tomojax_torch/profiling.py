"""Tracing, the program's spans and counters, and per-iteration
throughput (counterpart of ``tomojax/profiling.py``), on
``torch.profiler``.

* `trace(log_dir)` records host and (where torch finds CUDA) device
  activity and writes a Chrome-format trace into `log_dir`, which
  TensorBoard's profiler plugin and Perfetto open.
* `annotate(name)` is a span: a named region of the program. With no
  torch profiler running it is one shared no-op context and records
  nothing. While one runs (`trace`, or any ``torch.profiler.profile``) it
  enters ``torch.profiler.record_function(name)``, so the region shows in
  the trace beside the kernels it launched, and appends a `Span` to an
  in-memory store: its name, start and end from ``time.time_ns()`` (the
  profiler's host clock: a stamp lies at the trace's
  ``kineto_results.trace_start_ns()`` plus the event's microseconds), its
  id, its parent's id, the id of its outermost open span (its root: one
  per public API call), the counts made while it was the innermost open
  span, and `inner_ns`: the host time its direct children's entries and
  exits took outside their own stamps (the instrumentation inside it).
* `count(name, n)` adds to the innermost open span, and does nothing when
  none is open.
* `spanned(name)` runs each call of a function inside `annotate(name)`.
* `recorded()` is the store: at most `STORE_SPANS` spans, oldest first; a
  full store drops its oldest and counts them in ``spans_dropped``.
  `trace` clears it on entry.
* `IterationMeter` keeps per-iteration wall times and voxel-iters/s, with
  the reference's one-line summary.

The port opens spans at its layer boundaries only (``api.*``,
``solvers.*``, ``tv.*``, and the two sides of a fusion step,
``fusion.*``), never one per kernel launch. It counts
``reads`` (each blocking device-to-host read the api, solvers and stream
code make, whatever the device: all go through ``tomojax_torch.host``) and
``plan_builds`` (the bodies of the cached per-geometry tables of
``projector.cuda_joseph``, which run only on a miss).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

STORE_SPANS = 1 << 16  # spans the store keeps; older ones are dropped

_OFF = contextlib.nullcontext()  # the span while no profiler runs
_ids = itertools.count(1)


class _Open(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self):
        self.spans = []


_open = _Open()


class Span:
    """One recorded span (and, while open, the context that records it)."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "root",
                 "counts", "inner_ns", "_outer", "_rf", "_enter_ns")

    def __init__(self, name: str):
        self.name = name
        self.counts = {}
        self.inner_ns = 0

    def __enter__(self):
        enter_ns = time.time_ns()
        stack = _open.spans
        outer = stack[-1] if stack else None
        self._outer = outer
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.root = self.id if outer is None else outer.root
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        stack.append(self)
        self.start_ns = time.time_ns()
        self._enter_ns = self.start_ns - enter_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _open.spans.remove(self)
        self._rf.__exit__(*exc)
        self._rf = None
        _STORE.add(self)
        outer, self._outer = self._outer, None
        if outer is not None:
            # the parent's self time holds this span's entry and exit
            outer.inner_ns += self._enter_ns + time.time_ns() - self.end_ns
        return False


class Store:
    """The spans recorded, oldest first: at most `limit`; `spans_dropped`
    counts the oldest dropped to keep that bound."""

    def __init__(self, limit: int = STORE_SPANS):
        self.spans = collections.deque(maxlen=limit)
        self.spans_dropped = 0
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.spans_dropped += 1
            self.spans.append(span)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.spans_dropped = 0


_STORE = Store()


def recorded() -> Store:
    """The store of recorded spans (``.spans``, ``.spans_dropped``)."""
    return _STORE


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body: CPU activity, and CUDA kernels and copies where
    torch finds a CUDA device. The store of spans is cleared on entry, so
    `recorded` then holds the body's spans. On leaving, the card's queued
    work is waited for and the trace is written into `log_dir` as
    ``<host>_<pid>.<time>.pt.trace.json``. Yields the
    ``torch.profiler.profile``, whose ``events()`` and ``key_averages()``
    can be read after the body."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    _STORE.clear()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


def annotate(name: str):
    """A span named `name` (a context manager): recorded while a torch
    profiler runs, the shared no-op otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return Span(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside `annotate(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the innermost open span."""
    stack = _open.spans
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n


@dataclass
class IterationMeter:
    """Voxels/s accounting (BASELINE.md 'voxels/s/chip' metric).

    `lap()` reads the host clock. The reference's callers block on a
    device value (``float(...)``) before each lap; here, given a CUDA
    `device`, `lap()` synchronises that device first, so a lap times the
    card's work and not only the launch queue."""

    voxels: int
    name: str = "iter"
    times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None
    device: Optional[torch.device] = None

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def lap(self):
        self._sync()
        now = time.perf_counter()
        if self._t0 is not None:
            self.times.append(now - self._t0)
        self._t0 = now

    def _sync(self):
        dev = None if self.device is None else torch.device(self.device)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @property
    def mean_s(self) -> float:
        # the first lap is dropped to match tomojax/profiling.py:62
        laps = self.times[1:] if len(self.times) > 1 else self.times
        return sum(laps) / max(len(laps), 1)

    @property
    def voxel_iters_per_s(self) -> float:
        m = self.mean_s
        return self.voxels / m if m > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{self.name}: {len(self.times)} laps, "
            f"{self.mean_s * 1e3:.1f} ms/iter, "
            f"{self.voxel_iters_per_s / 1e6:.1f} Mvoxel-iters/s"
        )
