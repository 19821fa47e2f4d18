"""Tracing and per-iteration throughput (counterpart of
``tomojax/profiling.py``), on ``torch.profiler``.

* `trace(log_dir)` records host and (where torch finds CUDA) device
  activity and writes a Chrome-format trace into `log_dir`, which
  TensorBoard's profiler plugin and Perfetto open.
* `annotate(name)` names a region in that trace
  (``torch.profiler.record_function``).
* `IterationMeter` keeps per-iteration wall times and voxel-iters/s, with
  the reference's one-line summary.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body: CPU activity, and CUDA kernels and copies where
    torch finds a CUDA device. On leaving, the card's queued work is
    waited for and the trace is written into `log_dir` as
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
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


def annotate(name: str):
    """A named region in the trace (a context manager)."""
    return torch.profiler.record_function(name)


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
        # skip the first lap (compile)
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
