"""One run of one cell: set-up, the measured window, the traced layer
metrics, the correctness check, and the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration's file, ``traffic/<traffic>.json``,
``cells/<cell>.json`` (the limits of its comparison), the driver, entry
and reference that the traffic file names (``drivers/``, ``entries/``,
``reference/``) and ``metrics/<metric>.py`` for each per-layer metric it
reports (``found.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from benchmark import check, data, found, layers, trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
TRACE_SECONDS = 3.0  # the traced window: this long, then to a boundary
FORBIDDEN = ("jax", "jaxlib", "flax", "tomojax")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list
    bench: Path  # the folder its parts are found in

    def driver(self, inputs: list, device, seed: int):
        """The traffic's driver over `inputs`, building its entry."""
        t = self.traffic
        make = found.module("entries", t["entry"], self.bench).make
        return found.module("drivers", t["driver"], self.bench).Driver(
            t, self.config["solvers"], inputs, device, seed, make)

    def reference(self):
        """The traffic's plain reference: run(inputs, solvers, device,
        dtype)."""
        return found.module("reference", self.traffic["reference"],
                            self.bench).run


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def manifest(root: Path = ROOT) -> dict:
    return _read(root / "BENCHMARK.json")


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether `cell` reports the metric: its "workloads", or, for a
    per-layer metric without them, every cell that reports its `moves`."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load(name: str, root: Path = ROOT, bench: Path = HERE) -> Cell:
    """The cell `name` of the manifest under `root`, its files under
    `bench`."""
    m = manifest(root)
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in m["configs"] if c["name"] == w["config"])
    e2e = [e for e in m["end_to_end"] if reports(e, name, ())]
    names = {e["name"] for e in e2e}
    per = [p for p in m["per_layer"] if reports(p, name, names)]
    limits_path = bench / "cells" / f"{name}.json"
    limits = (_read(limits_path)["limits"] if limits_path.exists() else {})
    return Cell(name, w["chips"], _read(root / c["file"]),
                _read(bench / "traffic" / f"{w['traffic']}.json"), limits,
                e2e, per, Path(bench))


def reader(metric: str, bench: Path = HERE):
    """The module of metrics/<metric>.py."""
    return found.module("metrics", metric, bench)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or
    tomojax (compared whole: tomojax_torch is not tomojax)."""
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


def card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
           "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        limit, clock = smi.stdout.splitlines()[0].split(",")
        out["power_limit_w"] = float(limit)
        out["max_sm_clock_mhz"] = float(clock)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return out


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


@dataclasses.dataclass
class Window:
    times: list  # seconds of each completed job or update
    seconds: float  # the whole window
    attempted: int
    failed: int


def _window(driver, seconds: float, traced: bool, log) -> Window:
    times, failed = [], 0
    t0 = time.perf_counter()
    while True:
        try:
            if traced:
                with trace.job_span():
                    times.append(driver.step())
            else:
                times.append(driver.step())
        except Exception:  # a failed job ends the window and the run's
            failed += 1    # correctness; its traceback goes to stderr
            log(traceback.format_exc())
            break
        if time.perf_counter() - t0 >= seconds and driver.at_boundary():
            break
    return Window(times, time.perf_counter() - t0, len(times) + failed,
                  failed)


def _p95(values: list) -> float:
    """The 95th percentile, nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


E2E = {
    "recon_s": lambda w: w.seconds / len(w.times),
    "update_ms": lambda w: 1e3 * w.seconds / len(w.times),
    "update_ms_p95": lambda w: 1e3 * _p95(w.times),
}


def run(name: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, root: Path = ROOT, bench: Path = HERE,
        log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """One run of the cell; returns the result object of the contract,
    "checks" last."""
    device = torch.device(device)
    cell = load(name, root, bench)
    t, cfg = cell.traffic, cell.config
    dev = card(device)
    log(f"cell {name} seed {seed} seconds {seconds} trace {int(traced)} "
        f"on {dev}")

    # 1. the kernel library from the checkout's build cache
    if device.type == "cuda":
        from tomojax_torch import _build
        info = _build.build()
        _build.lib()
        log(f"kernel library {info.path.name}: built in {info.seconds:.2f}"
            f" s (0 = found in the cache)")
    # 2. the inputs from the seed
    t1 = time.perf_counter()
    inputs = data.make(cfg, seed, t["draws"], device, cell.bench)
    log(f"inputs: {t['draws']} draws in {time.perf_counter() - t1:.3f} s")
    # 3. one job of the cell's shapes (a whole acquisition when live)
    driver = cell.driver(inputs, device, seed)
    t1 = time.perf_counter()
    for _ in range(t.get("warmup_steps", 1)):
        driver.step()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"warm-up: {t.get('warmup_steps', 1)} steps in "
        f"{time.perf_counter() - t1:.3f} s")
    driver.mark_window()
    setup_s = time.perf_counter() - t_start

    # 4. the window
    metrics = {}
    if not traced:
        w = _window(driver, seconds, False, log)
        if w.times:
            for e in cell.end_to_end:
                if e["name"] == "setup_s":
                    value = setup_s
                else:
                    value = E2E[e["name"]](w)
                metrics[e["name"]] = {"value": value, "unit": e["unit"]}
        log(f"window: {len(w.times)} of {w.attempted} completed in "
            f"{w.seconds:.3f} s; median {statistics.median(w.times or [0]):.6f}"
            f" s, max {max(w.times or [0]):.6f} s")
    else:
        with trace.profiled(device) as prof:
            w = _window(driver, min(seconds, TRACE_SECONDS), True, log)
        tr = trace.read(prof)
        del prof
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    dev["memory_peak_bytes"] = peak
    log(f"memory peak {peak} bytes (torch.cuda.max_memory_allocated over "
        f"the window)")

    # the outputs of the window's own jobs, before anything else runs
    samples = driver.samples(seed) if w.times else []
    breakdown = None
    if traced:
        calls = {}
        readers = {p["name"]: reader(p["name"], bench) for p in cell.per_layer}
        spec = {}
        for r in readers.values():
            spec.update(getattr(r, "CAPTURE", {}))
        if spec and device.type == "cuda" and not w.failed:
            with layers.capturing(spec, calls):
                driver.step()
        ctx = Context(trace=tr, calls=calls, device=device)
        for p in cell.per_layer:
            v = readers[p["name"]].read(ctx)
            if v is not None:
                metrics[p["name"]] = {"value": v, "unit": p["unit"]}
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
            breakdown = {"device_ops": tr.device_ops,
                         "idle_gaps": tr.idle_gaps}
            log(f"traced: {len(w.times)} steps, busy {tr.busy_s:.6f} of "
                f"{tr.window_s:.6f} s")
        del calls, ctx

    # 5. the check, once the program's state is freed
    driver.release()
    del driver, inputs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = cell.reference()
    pairs = [(prog, ref(inp, cfg["solvers"], device, torch.float32))
             for inp, prog in samples]
    nums = check.numbers(pairs)
    correct, checks = check.verdict(nums, cell.limits, w.failed)
    log(f"reference: {len(pairs)} samples in {time.perf_counter() - t1:.3f}"
        f" s; numbers {nums}")
    result = {"correct": bool(correct and w.times), "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    return result


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads: the trace of the window
    (or None), the layer calls captured in one job, and the device."""

    trace: object
    calls: dict
    device: torch.device
