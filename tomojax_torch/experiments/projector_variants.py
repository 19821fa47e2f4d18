"""Angles per block and the 4-operation hat of the projectors on the card.

    python -m tomojax_torch.experiments.projector_variants [n] [ns]
        [--device cpu]

The port of scripts/exp_projector_variants.py (n = ns = 256, 90 angles over
+-76 deg by default): E1 (forward) with 1, 16 and 32 angles per block (the
TPU's a_blk 16 and 32, beside a block of one angle) in the FULL weights and
in W4, w = max(0, invd - |j invd^2 - invd^2 J*|), algebraically the FULL
hat with fewer operations; E2 (back) in FULL and W4. Times per call of a
batch of back-to-back calls (CUDA events) and max|d| against the first
row, each beside the card's name and power limit; the last line is JSON.
"""

from __future__ import annotations

import json
import sys

from tomojax_torch.experiments import timing
from tomojax_torch.experiments.cuda_projector_variants import (
    bp_variant, fp_variant,
)
from tomojax_torch.experiments.hat_model import NA, problem


def run(n: int, ns: int, device, card: str, reps: int | None = None) -> dict:
    reps = reps or (5 if device.type == "cuda" else 1)
    geom, x, y = problem(n, ns, device)
    print(f"device: {card}  {n}^2x{ns}, {NA} angles", flush=True)
    res = {}
    for kind, cases in (
            ("fp", [(ab, form) for ab in (1, 16, 32)
                    for form in ("FULL", "W4")]),
            ("bp", [(None, "FULL"), (None, "W4")])):
        ref = None
        for ab, form in cases:
            fn = ((lambda: fp_variant(x, geom, form, ab=ab)) if kind == "fp"
                  else (lambda: bp_variant(y, geom, form)))
            ms = timing.batch_ms(fn, reps, device)
            out = fn()
            ref = out if ref is None else ref
            key = f"fp_ab{ab}_{form}" if kind == "fp" else f"bp_{form}"
            res[key] = ms
            tag = (f"FP E1 ab={ab:2d} {form:4s}" if kind == "fp"
                   else f"BP E2       {form:4s}")
            print(f"{tag}: {ms:8.4f} ms  max|d|="
                  f"{float((out - ref).abs().max()):.2e} [{card}]",
                  flush=True)
    return {"device": card, "n": n, "ns": ns, "na": NA, "ms": res}


def main(argv=None) -> None:
    n, ns, device = timing.parse_args(argv, __doc__)
    print(json.dumps(run(n, ns, device, timing.card_label(device))))


if __name__ == "__main__":
    main(sys.argv[1:])
