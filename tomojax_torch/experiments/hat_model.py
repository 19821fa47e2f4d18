"""Split a projector's time into tap arithmetic and loads on the card.

    python -m tomojax_torch.experiments.hat_model [n] [ns] [--device cpu]

The port of scripts/exp_hat_model.py (n = ns = 256, 90 angles over
+-76 deg by default). E1 (forward) and E2 (back) run in the weight forms
of csrc/exp_hat.cuh:

  FULL   the production hat weights, tap for tap;
  NOHAT  a constant weight on the same taps (every load kept): the floor of
         loads and sums without the hat;
  NODOT  the FULL weights summed without reading the volume / sinogram:
         the hat arithmetic without the loads;
  HAT5   (FP) the min/fma hat with the 1/D after the sum;
  BF16   the hat's tail in bf16.

Then the production kernels at the same shape (K1 ``fp_sl``, K2 ``bp_sl``,
one K3 FGP iteration) and an operation-count model of the hat: taps per
call x operations per tap over the card's float32 instruction rate, against
the measured FULL - NOHAT. Times are per call of a batch of back-to-back
calls (CUDA events), each beside the card's name and power limit; the last
line is JSON.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from tomojax_torch import config
from tomojax_torch.experiments import timing
from tomojax_torch.experiments.cuda_projector_variants import (
    bp_variant, fp_variant,
)
from tomojax_torch.geometry import Geometry

NA = 90
# 67 TFLOP/s float32 outside the tensor cores counts an FMA as two; a
# separate add, multiply, min or max issues at half that rate
F32_INSTR_PER_S = 33.5e12
HAT_OPS = 10  # per tap: J* (2 multiplies, 2 adds), the hat chain (6)


def problem(n: int, ns: int, device, na: int = NA):
    """The scripts' geometry and random operands (default_rng(0))."""
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((n, n, ns), np.float32)).to(device)
    y = torch.from_numpy(rng.random((na, n, ns), np.float32)).to(device)
    return geom, x, y


def run(n: int, ns: int, device, card: str, reps: int | None = None) -> dict:
    from tomojax_torch.projector.cuda_joseph import bp_sl, fp_sl
    from tomojax_torch.tv.cuda_fgp import fgp_iter

    reps = reps or (5 if device.type == "cuda" else 1)
    geom, x, y = problem(n, ns, device)
    print(f"device: {card}  {n}^2x{ns}, {NA} angles", flush=True)
    res = {}

    def row(tag, key, fn, ref=None):
        ms = timing.batch_ms(fn, reps, device)
        res[key] = ms
        out = fn()
        err = "" if ref is None else f"  rel|d|={timing.rel_max(out, ref):.2e}"
        print(f"{tag}: {ms:8.4f} ms{err} [{card}]", flush=True)
        return out

    forms = (("FULL", "NOHAT", "NODOT", "HAT5", "BF16") if n <= 256
             else ("FULL", "NOHAT", "NODOT"))
    ref = None
    for form in forms:
        out = row(f"FP E1 {form:5s}", f"fp_{form}",
                  lambda: fp_variant(x, geom, form), ref)
        ref = out if ref is None else ref
    ref = None
    for form in ("FULL", "NOHAT", "NODOT", "BF16"):
        out = row(f"BP E2 {form:5s}", f"bp_{form}",
                  lambda: bp_variant(y, geom, form), ref)
        ref = out if ref is None else ref

    duals = tuple(torch.zeros_like(x, dtype=config.fgp_dual_dtype)
                  for _ in range(3))
    row("production FP (K1 fp_sl)", "fp_prod", lambda: fp_sl(x, geom))
    row("production BP (K2 bp_sl)", "bp_prod", lambda: bp_sl(y, geom))
    row("production FGP iteration (K3)", "fgp_iter",
        lambda: fgp_iter(x, *duals, 0.1))

    taps = {"fp": NA * geom.nray * ns * n * 2, "bp": n * n * ns * NA * 2}
    for k in ("fp", "bp"):
        model = taps[k] * HAT_OPS / F32_INSTR_PER_S * 1e3
        hat = res[f"{k}_FULL"] - res[f"{k}_NOHAT"]
        loads = res[f"{k}_FULL"] - res[f"{k}_NODOT"]
        res[f"{k}_model_ms"] = model
        print(f"{k}: taps/call {taps[k] / 1e6:.0f}M, model {HAT_OPS}-op hat "
              f"= {model:.4f} ms, measured hat (FULL - NOHAT) = {hat:.4f} "
              f"ms, loads (FULL - NODOT) = {loads:.4f} ms, floor (NOHAT) = "
              f"{res[f'{k}_NOHAT']:.4f} ms [{card}]", flush=True)
    return {"device": card, "n": n, "ns": ns, "na": NA, "ms": res}


def main(argv=None) -> None:
    n, ns, device = timing.parse_args(argv, __doc__)
    print(json.dumps(run(n, ns, device, timing.card_label(device))))


if __name__ == "__main__":
    main(sys.argv[1:])
