"""Readings for the limits of a cell's comparison, in one process.

    python3 benchmark/calibrate.py --workload haadf256.fista \
        --seeds 11,12,13 --control-seeds 11,12,13 [--out FILE]

For each seed of ``--seeds`` it makes the cell's inputs, runs the timed
path once (one job, or one acquisition of tilt updates with the rounds
the harness samples and the early rounds of few tilts, EARLY) and
compares it with the plain reference: the lower readings. For each seed of ``--control-seeds`` it runs the
control, the reference computed in bfloat16 (the precision below the
configuration's float32) from the same inputs, and compares it with the
float32 reference: the upper readings. Every reading is printed as one
JSON line; the last line is the largest program reading and the smallest
control reading of each number. A limit goes between them (PERF.md).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


EARLY = range(1, 6)  # live: the rounds after the first, few tilts each


def samples(cell, seed: int, device) -> list:
    """[(reference inputs, program outputs)] of one job or acquisition;
    of an acquisition, the rounds a run samples and the early ones."""
    from benchmark import data

    t = cell.traffic
    inputs = data.make(cell.config, seed, 1, device, cell.bench)
    driver = cell.driver(inputs, device, seed)
    driver.mark_window()
    driver.keep_more(EARLY)
    for _ in range(t.get("warmup_steps", 1)):
        driver.step()
    out = driver.samples(seed)
    driver.release()
    return out


def readings(cell, seeds, control_seeds, device, emit) -> dict:
    import torch

    from benchmark import check

    ref = cell.reference()
    solvers = cell.config["solvers"]
    high, low = {}, {}
    for kind, group in (("program", seeds), ("control", control_seeds)):
        for seed in group:
            t0 = time.perf_counter()
            pairs = samples(cell, seed, device)
            refs = [ref(inp, solvers, device, torch.float32)
                    for inp, _ in pairs]
            if kind == "program":
                got = [p for _, p in pairs]
            else:
                got = [ref(inp, solvers, device, torch.bfloat16)
                       for inp, _ in pairs]
            nums = check.numbers(list(zip(got, refs)))
            emit({"seed": seed, "kind": kind, "numbers": nums,
                  "per_sample": [check.numbers([pr]) for pr in
                                 zip(got, refs)],
                  "tilts": [len(inp.get("angles", ())) for inp, _ in pairs],
                  "seconds": time.perf_counter() - t0})
            for k, v in nums.items():
                if kind == "program":
                    high[k] = max(high.get(k, 0.0), v)
                else:
                    low[k] = min(low.get(k, float("inf")), v)
            del pairs, refs, got
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return {"program_max": high, "control_min": low}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    from benchmark.run import fixed_caches

    fixed_caches()
    import torch

    from benchmark import harness

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load(a.workload)
    out = open(a.out, "a") if a.out else None

    def emit(obj):
        line = json.dumps({"workload": a.workload, **obj})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit({"device": harness.card(device)})
    seeds = [int(s) for s in a.seeds.split(",") if s]
    ctl = [int(s) for s in a.control_seeds.split(",") if s]
    emit(readings(cell, seeds, ctl, device, emit))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
