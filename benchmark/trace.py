"""Reading a torch.profiler trace of whole jobs: device busy time, the
idle share, the device operations that took most time and the longest
idle gaps by the host operation the main thread was in.

The gap arithmetic is that of ``chip_smoke.py``'s ``_gap_split`` and
``_profile_summary``, copied: each gap between device events is shared
out over the outermost host ops it overlaps, by name, and the rest is
"no op" (Python between ops). The window is measured from the start of
the first job's annotation to the end of the last, so host work before
a job's first kernel counts as idle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

import torch

JOB = "bench.job"  # the annotation around each traced job or update


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list  # [[name, seconds], ...], the 10 largest
    idle_gaps: list  # [[host op, seconds], ...], the 10 largest

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


@contextlib.contextmanager
def profiled(device: torch.device):
    """torch.profiler over the body, host and (on a card) device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize()


def job_span():
    """The annotation to put around each traced job."""
    return torch.profiler.record_function(JOB)


def _annotation(e) -> bool:
    return getattr(e, "is_user_annotation", False) or e.name == JOB


def read(prof) -> Trace | None:
    """The trace of the jobs in `prof`, or None where it holds no device
    event or no job."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    jobs = [e for e in events if e.name == JOB and e.device_type != cuda]
    dev = [e for e in events if e.device_type == cuda and not _annotation(e)]
    if not jobs or not dev:
        return None
    lo = min(e.time_range.start for e in jobs)
    hi = max(e.time_range.end for e in jobs)
    busy = []
    for a, b in sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                       for e in dev):
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    if not busy or hi <= lo:
        return None
    by_name = collections.defaultdict(float)
    for e in dev:
        by_name[e.name] += e.time_range.end - e.time_range.start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = _gap_split(events, busy, lo, hi)
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(hi - lo) / 1e6,
                 busy_s=sum(b - a for a, b in busy) / 1e6,
                 device_ops=[[name, us / 1e6] for name, us in ops],
                 idle_gaps=[[name, us / 1e6] for name, us in top_gaps])


def _gap_split(events, busy, lo, hi) -> dict:
    """Idle microseconds of the window by the outermost host op of the
    main thread that each gap overlaps; the rest is "no op"."""
    cuda = torch.autograd.DeviceType.CUDA
    edges = [(lo, lo)] + [tuple(b) for b in busy] + [(hi, hi)]
    gaps = [(a[1], b[0]) for a, b in zip(edges, edges[1:]) if b[0] > a[1]]
    host = [e for e in events if e.device_type != cuda and not _annotation(e)]
    split = collections.defaultdict(float)
    if host and gaps:
        main = collections.Counter(e.thread for e in host).most_common(1)[0][0]

        def outermost(e):
            q = e.cpu_parent
            while q is not None and _annotation(q):
                q = q.cpu_parent
            return q is None

        ends = [g[1] for g in gaps]
        for e in host:
            if e.thread != main or not outermost(e):
                continue
            s, t = e.time_range.start, e.time_range.end
            i = bisect.bisect_right(ends, s)
            while i < len(gaps) and gaps[i][0] < t:
                split[e.name] += max(0.0, min(t, gaps[i][1])
                                     - max(s, gaps[i][0]))
                i += 1
    idle = sum(b - a for a, b in gaps)
    split["no op"] = idle - sum(split.values())
    return split
