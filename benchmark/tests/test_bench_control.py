"""The control of each cell, the plain reference computed in bfloat16 in
the program's place, comes out not correct under the cell's own limits,
and the program comes out correct, at a tiny size on the CPU (the chip's
readings at the cells' own sizes, from which the limits were set, are in
cells/<cell>.json and PERF.md)."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, check, harness
from benchmark.tests.tiny import tiny_root

CELLS = ["haadf256.fista", "haadf256.asd_pocs", "chem2el128.fusion",
         "haadf256.live_cs"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(root, cell):
    spec = harness.load(cell, root, root / "benchmark")
    lines = []
    calibrate.readings(spec, [7, 8], [7, 8], torch.device("cpu"),
                       lines.append)
    for line in lines:
        ok, _ = check.verdict(line["numbers"], spec.limits, 0)
        assert ok is (line["kind"] == "program"), line
