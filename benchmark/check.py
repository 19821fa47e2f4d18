"""The comparison that decides ``correct``.

Each output the program returns is compared with the reference's:

* a volume (``recon``) by its relative gap ||p - r|| / ||r||;
* a convergence vector by its widest gap relative to the reference's
  largest value, max |p_i - r_i| / max |r_i|.

The number ``<output>_gap`` of a cell is the largest over the samples it
checks. A cell's limits sit in ``cells/<cell>.json`` under ``limits``;
each was set between the readings of sound runs and of the control, as
``PERF.md`` records. A run is correct when every number with a limit is
finite and at most its limit, and no job failed.
"""

from __future__ import annotations

import math

import numpy as np


def gap(name: str, prog, ref) -> float:
    p = np.asarray(prog, np.float64)
    r = np.asarray(ref, np.float64)
    if p.shape != r.shape:
        return math.inf
    if name == "recon":
        return float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-300))
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-300))


def numbers(pairs: list) -> dict:
    """{"<output>_gap": the largest gap over the samples} from a list of
    (program outputs, reference outputs)."""
    out = {}
    for prog, ref in pairs:
        for name, r in ref.items():
            v = gap(name, prog[name], r)
            key = f"{name}_gap"
            out[key] = max(out.get(key, 0.0), v) if math.isfinite(v) \
                else math.inf
    return out


def verdict(nums: dict, limits: dict, failed: int):
    """(correct, {name: {"value", "limit"}}) over the numbers with a
    limit; a number the limits name and the run did not read fails."""
    checks = {}
    ok = failed == 0 and bool(limits)
    for name, limit in limits.items():
        v = nums.get(name, math.inf)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks
