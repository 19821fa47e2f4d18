"""Timing and the command line shared by the experiment drivers.

On the card a driver times a batch of back-to-back calls between two CUDA
events (``batch_ms``); the host queues the launches ahead, so the gaps
between them stay hidden. It has no need of the reference scripts' slope
timing, which worked around a TPU server that cached identical calls, and
it does not read ``torch.profiler``'s kernel records, which under-reported
the drivers' kernels on an H100. With
``--device cpu`` the drivers run their plain versions and time them with
the host clock, for a check of the control flow only: those are not card
times, and every line names the device it ran on.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch


def parse_args(argv, doc: str, n: int = 256, ns_of=lambda n: n):
    """(n, ns, device) from ``[n] [ns] [--device cpu|cuda]``; ns defaults to
    ns_of(n). Raises when the card is asked for and torch finds no CUDA."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=n)
    p.add_argument("ns", nargs="?", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return a.n, a.ns or ns_of(a.n), device_of(a.device)


def device_of(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the experiment drivers run on the card: torch "
                           "finds no CUDA device (pass --device cpu for the "
                           "plain versions)")
    return torch.device(name)


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    'cpu (host clock)' off the card."""
    if device.type != "cuda":
        return "cpu (host clock)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[torch.cuda.current_device()]


def batch_ms(fn, reps: int, device: torch.device) -> float:
    """Time per call of `reps` back-to-back calls of `fn` after a warm-up
    call: CUDA events around the batch on the card (the host queues the
    launches ahead, so for kernels of a millisecond or more this is their
    device time), the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|."""
    return float((got - ref).abs().max()) / float(ref.abs().max())
