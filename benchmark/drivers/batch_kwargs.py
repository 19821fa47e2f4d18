"""Whole jobs as ``drivers/batch.py`` runs them, with the traffic's
``"kwargs"`` (call -> keyword arguments) laid over the configuration's
arguments of the program's calls: a mix that runs a configuration's path
with one option changed, such as ``data_fusion(fused=True)``. The plain
reference is handed the configuration's own arguments (the harness gives
it the configuration's ``solvers``), so a changed option must leave what
the reference computes as it is."""

from __future__ import annotations

from pathlib import Path

from benchmark import found

_batch = found.module("drivers", "batch", Path(__file__).resolve().parents[1])


class Driver(_batch.Driver):
    """The batch driver on the configuration's arguments with the
    traffic's laid over them."""

    def __init__(self, traffic: dict, solvers: dict, inputs: list, device,
                 seed: int, make):
        over = traffic.get("kwargs", {})
        merged = {call: {**solvers.get(call, {}), **over.get(call, {})}
                  for call in {*solvers, *over}}
        super().__init__(traffic, merged, inputs, device, seed, make)
