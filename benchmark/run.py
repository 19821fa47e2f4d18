"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload haadf256.fista --seed 7 \
        --seconds 30 --trace 0

Set-up (the kernel library from the checkout's build cache, the inputs
from the seed, one warm-up job) counts into ``setup_s``; then the window
runs jobs for ``--seconds``; with ``--trace 1`` a shorter traced window
gives the per-layer metrics instead. The outputs are checked against the
plain reference once the window has closed. The last line of standard
output is the result object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

The run needs a CUDA device (it exits with 2 and prints no result where
torch finds none, or fewer than the cell asks for) and exits with 3 if a
module of jax, jaxlib, flax or tomojax was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def fixed_caches() -> None:
    """Every cache a kernel build could use at a fixed path in the
    checkout; no library the port uses may load jax; one host thread for
    torch's and numpy's pools (the jobs' host work is single-threaded, and
    idle pool threads only compete with it for the shared host's cores)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    fixed_caches()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                         "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of {', '.join(bad)}: the benchmark runs the "
              f"port alone", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result object as the last line of standard
    output."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
