"""Layer calls of a job, captured and timed on the card.

A roofline metric names the port's functions that make up its layer
(``CAPTURE`` in its metric file: (module, function) -> work function).
During one untimed job the harness puts a recording wrapper in place of
each such function in every loaded module of the port that holds it, so
the calls the cell's own path makes are seen with their own arguments.
Each distinct call (function, shapes and types, geometry, and the
integer, flag and string arguments that set its work; not the float
scalars that change from iteration to iteration, such as a momentum or a
step size) keeps a copy of its first arguments and a count. After the job the wrappers are taken
out, each distinct call is timed by CUDA events over back-to-back calls,
and the layer's share of its roofline is

    sum(count * least time) / sum(count * measured time)

over its calls: the path's own mix, at its shapes, on its data.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import sys

import torch

from benchmark import work

PACKAGE = "tomojax_torch"
MIN_BATCH_MS = 50.0  # each call timed over at least this long a batch
MAX_REPS = 200


@dataclasses.dataclass
class Call:
    fn: object
    work: object
    args: tuple
    kwargs: dict
    count: int = 0


def _key(name, args, kwargs):
    def one(v):
        if isinstance(v, torch.Tensor):
            return ("T", tuple(v.shape), str(v.dtype))
        if isinstance(v, (tuple, list)):
            return tuple(one(u) for u in v)
        if hasattr(v, "angles_key"):
            return ("G", v.n, v.nray, v.angles_key)
        if isinstance(v, float):
            return "float"  # a per-iteration scalar sets no work
        if isinstance(v, (int, str, bool, type(None))):
            return v
        return type(v).__name__
    return (name, tuple(one(a) for a in args),
            tuple(sorted((k, one(v)) for k, v in kwargs.items())))


def _copy(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple):
        return tuple(_copy(u) for u in v)
    if isinstance(v, list):
        return [_copy(u) for u in v]
    return v


@contextlib.contextmanager
def capturing(spec: dict, calls: dict):
    """Record into `calls` every call of the functions of `spec`
    ((module, name) -> work function) while the body runs."""
    swapped = []
    for (mod_name, name), work_fn in spec.items():
        home = importlib.import_module(mod_name)
        orig = getattr(home, name)

        def wrapper(*args, __orig=orig, __name=name, __work=work_fn,
                    **kwargs):
            key = _key(__name, args, kwargs)
            if key not in calls:
                calls[key] = Call(__orig, __work, _copy(args),
                                  _copy(kwargs))
            calls[key].count += 1
            return __orig(*args, **kwargs)

        # every importer's name is swapped; the defining module keeps its
        # own, which its body reads (the launch counters)
        for mod in list(sys.modules.values()):
            modname = getattr(mod, "__name__", "") or ""
            if modname.split(".")[0] != PACKAGE or mod is home:
                continue
            for attr, val in list(vars(mod).items()):
                if val is orig:
                    setattr(mod, attr, wrapper)
                    swapped.append((mod, attr, orig))
    try:
        yield calls
    finally:
        for mod, attr, orig in reversed(swapped):
            setattr(mod, attr, orig)


def batch_s(fn, args, kwargs) -> float:
    """Seconds a call over a batch of back-to-back calls between two CUDA
    events, after a warm-up call; the batch spans MIN_BATCH_MS at least."""
    def timed(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    fn(*args, **kwargs)
    torch.cuda.synchronize()
    first = timed(1)
    reps = min(MAX_REPS, max(3, math.ceil(MIN_BATCH_MS / max(first, 1e-3))))
    return timed(reps) / reps / 1e3


def roofline_pct(calls: dict, spec: dict) -> float | None:
    """The share of its roofline of the layer whose functions `spec`
    names, over the calls captured of them; None where none was."""
    names = {name for _, name in spec}
    mine = [c for k, c in calls.items() if k[0] in names]
    if not mine:
        return None
    least = spent = 0.0
    for c in mine:
        least += c.count * work.bound_s(*c.work(*c.args, **c.kwargs))
        spent += c.count * batch_s(c.fn, c.args, c.kwargs)
    return 100.0 * least / spent
