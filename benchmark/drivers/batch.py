"""Whole reconstruction jobs, one after another, in a closed loop.

A job builds the traffic's entry of the public API from one input set
(the host tilt series), makes its calls with the configuration's keyword
arguments, and returns ``get_recon()`` (a host numpy volume) with the
convergence values the traffic names. Jobs cycle through the input sets.
The last output of each input set is kept for the correctness check.
"""

from __future__ import annotations

import random
import time

import numpy as np


class Driver:
    """Whole jobs; `step` runs one and returns its seconds."""

    def __init__(self, traffic: dict, solvers: dict, inputs: list, device,
                 seed: int, make):
        self.t, self.solvers, self.inputs = traffic, solvers, inputs
        self.device, self.make = device, make
        self.done = 0  # jobs completed
        self.last = {}  # input set -> outputs of its last job

    def job(self, d: int) -> dict:
        t = self.t
        obj = self.make(self.inputs[d], self.solvers.get(t["entry"], {}),
                        self.device)
        for call in t["calls"]:
            getattr(obj, call)(**self.solvers.get(call, {}))
        out = {"recon": obj.get_recon()}
        for name in t["outputs"]:
            out[name] = np.asarray(getattr(obj, name))
        return out

    def step(self) -> float:
        d = self.done % len(self.inputs)
        t0 = time.perf_counter()
        out = self.job(d)
        dt = time.perf_counter() - t0
        self.done += 1
        self.last[d] = out
        return dt

    def samples(self, seed: int) -> list:
        """[(reference inputs, program outputs)] of one job, its input set
        drawn from the seed among those completed."""
        d = random.Random(seed).choice(sorted(self.last))
        return [(self.inputs[d], self.last[d])]

    def mark_window(self):
        """Nothing to mark: every job's output is kept."""

    def keep_more(self, rounds):
        """Nothing to add: a job is checked whole."""

    def at_boundary(self) -> bool:
        """Every job is whole: the window may close after any."""
        return True

    def release(self):
        self.last = {}
