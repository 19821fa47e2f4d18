"""BENCHMARK.json against the contract the harness is written to: its
keys, names, units and limits, every configuration with a cell, each
per-layer metric reported wherever its end-to-end metric is, and a file
for every configuration, traffic mix, cell and metric it names."""

from __future__ import annotations

import json
import re

from benchmark import harness
from benchmark.tests.tiny import REPO

M = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_tok")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(map(_line, M["command"]))
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_entries():
    names = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and \
            _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for e in M["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in M["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(p["layer"])
    for entry in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["name"] not in names
        names.add(entry["name"])
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in M[group]}) == len(M[group])


def test_every_config_has_a_cell_and_every_cell_its_files():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    bench = REPO / "benchmark"
    for w in M["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").exists()
        assert (bench / "cells" / f"{w['name']}.json").exists()
        cell = harness.load(w["name"])
        assert cell.limits, f"{w['name']} compares nothing"
    for p in M["per_layer"]:
        assert callable(harness.reader(p["name"]).read)


def test_each_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in M["workloads"]:
        cell = harness.load(w["name"])
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for e in e2e - {"setup_s"}:
            assert e in harness.E2E


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for p in M["per_layer"]:
        moves = e2e[p["moves"]]
        for cell in p.get("workloads", cells):
            assert cell in cells
            assert harness.reports(moves, cell, ())


def test_setup_bound_and_the_check_fits_its_budget():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    rs = M["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
