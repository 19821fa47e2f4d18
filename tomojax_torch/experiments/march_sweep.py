"""K5 and K11 under other values of their tuning constants, on the card.

    python3 -m tomojax_torch.experiments.march_sweep

The constants are the choices behind the plane-march kernels' speed:
``V_STEP`` and ``V_GROUPS`` in ``csrc/tv_value.cu`` (K5's planes a march
step and steps in its ring) and ``TV2_MIN_BLOCKS`` in
``csrc/tv_march.cuh`` (K11's resident blocks an SM, which caps its
registers). Each variant is a copy of ``tomojax_torch/csrc`` with some of
them replaced, built into ``build/march_sweep/<n>/`` and loaded beside the
others. Every variant is first held against the plain versions (K5 rtol
2e-5 with and without a right halo, K11 equal with bf16 duals), then all
are timed in turns, three rounds in alternating order, by device time
(torch.profiler, mean of 10 calls) at 256^3 with bf16 duals, each beside
K3, which no variant changes, as the yardstick of the card's state. Rows
name the card and its power limit; the last line is JSON (the medians).
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import sys
from pathlib import Path

import torch

from tomojax_torch import _build
from tomojax_torch.experiments.timing import card_label, device_of
from tomojax_torch.tv.cuda_fgp import fgp_iter2_ref
from tomojax_torch.tv.cuda_tv_value import tv_value_ref

LAM = 0.1
VARIANTS = (
    ("as built", {}),
    ("K5 1 plane a step; K11 3 blocks an SM",
     {"V_STEP": 1, "TV2_MIN_BLOCKS": 3}),
    ("K5 2 planes a step; K11 4 blocks an SM",
     {"V_STEP": 2, "TV2_MIN_BLOCKS": 4}),
    ("K5 8 planes a step, 3 steps in the ring; K11 6 blocks an SM",
     {"V_STEP": 8, "V_GROUPS": 3, "TV2_MIN_BLOCKS": 6}),
    ("K5 6 steps in the ring", {"V_GROUPS": 6}),
)


def variant_sources(subs: dict, where: Path) -> Path:
    """A copy of csrc at `where` with each `constexpr int NAME = v;` of
    subs replaced (each name must occur once)."""
    shutil.rmtree(where, ignore_errors=True)
    shutil.copytree(_build.CSRC, where)
    for name, value in subs.items():
        hits = 0
        for f in sorted(where.iterdir()):
            text, k = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};",
                              f.read_text())
            if k:
                f.write_text(text)
                hits += k
        if hits != 1:
            raise RuntimeError(f"{name} found {hits} times in the sources")
    return where


class Variant:
    """One variant's library, called on tensors on the card."""

    def __init__(self, lib):
        self.lib = lib

    def tv_value(self, x, hi=None):
        nel = x.shape[0] if x.dim() == 4 else 1
        n0, n1, n2 = x.shape[-3:]
        partials = torch.empty(self.lib.tj_tv_value_partials(nel, n0, n1, n2),
                               device=x.device)
        out = torch.empty((), device=x.device)
        _build.check(self.lib.tj_tv_value(
            x.data_ptr(), None if hi is None else hi.data_ptr(),
            partials.data_ptr(), out.data_ptr(), nel, n0, n1, n2,
            _build.stream()), "tj_tv_value")
        return out

    def fgp(self, entry: str, x, p):
        q = tuple(torch.empty_like(v) for v in p)
        _build.check(getattr(self.lib, entry)(
            x.data_ptr(), *(v.data_ptr() for v in p),
            *(v.data_ptr() for v in q), *x.shape,
            int(p[0].dtype == torch.bfloat16), LAM, 1.0 / (26.0 * LAM),
            _build.stream()), entry)
        return q


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time of the kernels one call of fn launches, after a
    warm-up call (torch.profiler's CUDA events; a window in which the
    profiler recorded no kernel is taken again, at most twice)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start
                 for e in prof.events() if e.device_type == cuda)
        if us > 0:
            return us / reps / 1e3
    raise RuntimeError("torch.profiler recorded no device time")


def check(v: Variant, gen) -> None:
    """The variant against the plain versions at shapes across the march's
    boundaries."""
    dev = torch.device("cuda")
    for shape in ((70, 33, 130), (40, 16, 1), (1, 8, 32), (33, 8, 36)):
        x = torch.rand(shape, generator=gen, device=dev)
        for hi in (None, torch.rand(shape[:2], generator=gen, device=dev)):
            ref = float(tv_value_ref(x, hi))
            rel = abs(float(v.tv_value(x, hi)) - ref) / ref
            if rel > 2e-5:
                raise RuntimeError(f"K5 at {shape}: rel {rel:.3e}")
        p = tuple((torch.rand(shape, generator=gen, device=dev) - 0.5)
                  .bfloat16() for _ in range(3))
        if not all(torch.equal(a, b) for a, b in zip(
                v.fgp("tj_fgp_iter2", x, p), fgp_iter2_ref(x, *p, LAM))):
            raise RuntimeError(f"K11 at {shape} differs from its plain "
                               f"version")


def main(argv=None) -> int:
    dev = device_of("cuda")
    card = card_label(dev)
    root = Path(__file__).resolve().parents[2] / "build" / "march_sweep"
    variants = {}
    for i, (name, subs) in enumerate(VARIANTS):
        src = variant_sources(subs, root / str(i) / "csrc")
        info = _build.build(src, root / str(i) / "lib")
        variants[name] = Variant(_build.load(info.path))
    gen = torch.Generator(device=dev).manual_seed(0)
    for v in variants.values():
        check(v, gen)
    n = 256
    x = torch.rand((n, n, n), generator=gen, device=dev)
    p = tuple((torch.rand((n, n, n), generator=gen, device=dev) - 0.5)
              .bfloat16() for _ in range(3))
    times = {name: [] for name in variants}
    for rnd in range(3):
        order = list(variants) if rnd % 2 == 0 else list(variants)[::-1]
        for name in order:
            v = variants[name]
            k3 = device_ms(lambda: v.fgp("tj_fgp_iter", x, p))
            k5 = device_ms(lambda: v.tv_value(x))
            k11 = device_ms(lambda: v.fgp("tj_fgp_iter2", x, p))
            times[name].append((k3, k5, k11))
            print(f"round {rnd} {name}: K5 {k5:.4f} ms "
                  f"({4 * x.numel() / k5 / 1e9:.3f} TB/s), K11 {k11:.4f} ms,"
                  f" K3 {k3:.4f} ms, device, 256^3, bf16 duals [{card}]")
    med = {name: {k: statistics.median(t[i] for t in ts)
                  for i, k in enumerate(("K3", "K5", "K11"))}
           for name, ts in times.items()}
    print(json.dumps({"march_sweep_ms": med, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
