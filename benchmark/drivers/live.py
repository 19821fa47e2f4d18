"""Tilts handed one at a time, in acquisition order, to a streaming
reconstructor, in a closed loop.

Each update is ``add_projections`` of one (angle, image) and one round
(the traffic's ``round``). After the last tilt a new acquisition starts,
with a new reconstructor, on the next input set. The state before and
after a sample of updates is kept for the correctness check: the first
update of the window (a round from zero), the last tilt of the window's
first acquisition, and two more drawn from the seed. A round from zero
returns its volume as ``recon_first``, every other round as ``recon``:
the first is read but has no limit, since a rounding-level change of
the input moves it by some 15 % (PERF.md); its ``dd`` is compared.
"""

from __future__ import annotations

import random
import time

import numpy as np


class Driver:
    """Tilt-by-tilt updates; `step` runs one and returns its seconds."""

    def __init__(self, traffic: dict, solvers: dict, inputs: list, device,
                 seed: int, make):
        self.t, self.solvers, self.device = traffic, solvers, device
        self.make = make
        # each input set's tilts as contiguous (Nslice, Nray) images
        self.images = [np.ascontiguousarray(np.moveaxis(i["series"], 2, 0))
                       for i in inputs]
        self.angles = [np.asarray(i["angles"], np.float64) for i in inputs]
        self.acq = 0  # acquisitions begun
        self.k = 0  # tilts handed over in this acquisition
        self.rec = None
        self.done = 0
        self.rng = random.Random(seed)
        self.keep = set()  # update indices whose state is kept
        self.snaps = {}
        self.window_start = None

    def mark_window(self):
        """The next update is the window's first: keep it (a round from
        zero), the window's first last tilt, and draw two more."""
        self.window_start = self.done
        na = len(self.angles[0])
        first = self.done + (na - self.k) % na
        self.keep = {self.done, first + na - 1}
        self.snaps = {}

    def keep_more(self, rounds):
        """Keep also the updates of these tilt indices of the window's
        first acquisition."""
        na = len(self.angles[0])
        first = self.done + (na - self.k) % na
        self.keep |= {first + k for k in rounds}

    def at_boundary(self) -> bool:
        """The window closes only after a whole acquisition, so that every
        window holds the same mix of short (early) and long (late)
        rounds."""
        return self.k == 0

    def _want(self, i: int) -> bool:
        if i in self.keep:
            return True
        if self.window_start is None:
            return False
        # reservoir of two over the window's other updates
        seen = i - self.window_start + 1
        return self.rng.random() < 2.0 / seen

    def step(self) -> float:
        na = len(self.angles[0])
        d = self.acq % len(self.images)
        i = self.done
        snap = None
        if self._want(i):
            x = None if self.rec is None or self.k == 0 else self.rec.x
            snap = {"x": None if x is None else x.clone(),
                    "dpocs": 0.0 if self.k == 0 else float(self.rec._dpocs),
                    "d": d, "k": self.k}
        t0 = time.perf_counter()
        if self.k == 0:
            self.rec = self.make(None, self.solvers.get(self.t["entry"], {}),
                                 self.device)
        self.rec.add_projections([(float(self.angles[d][self.k]),
                                   self.images[d][self.k])])
        dd = getattr(self.rec, self.t["round"])(
            **self.solvers.get(self.t["round"], {}))
        dt = time.perf_counter() - t0
        if snap is not None:
            snap["out"] = {"recon": self.rec.x.clone(),
                           "dd": np.asarray([dd])}
            if i not in self.keep:  # a reservoir slot: replace a drawn one
                drawn = [j for j in self.snaps if j not in self.keep]
                if len(drawn) >= 2:
                    del self.snaps[self.rng.choice(drawn)]
            self.snaps[i] = snap
        self.done += 1
        self.k += 1
        if self.k == na:
            self.k = 0
            self.acq += 1
        return dt

    def samples(self, seed: int) -> list:
        """[(reference inputs, program outputs)] of the kept updates."""
        out = []
        for i in sorted(self.snaps):
            s = self.snaps[i]
            k = s["k"]
            inp = {"x": s["x"], "dpocs": s["dpocs"],
                   "angles": self.angles[s["d"]][:k + 1],
                   "images": self.images[s["d"]][:k + 1]}
            vol = "recon_first" if s["x"] is None else "recon"
            prog = {vol: s["out"]["recon"].cpu().numpy(),
                    "dd": s["out"]["dd"]}
            out.append((inp, prog))
        return out

    def release(self):
        self.rec = None
