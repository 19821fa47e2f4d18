"""Angles per block through the production FP, and BP with two angles per
step, on the card.

    python -m tomojax_torch.experiments.projector_variants2 [n] [ns]
        [--device cpu]

The port of scripts/exp_projector_variants2.py (n = 256, 90 angles over
+-76 deg; ns = n, or 128 from n = 512, by default). FP: the production
kernel (K1 ``fp_sl``, up to 8 angles a block from its plan; the port's
dispatch has no a_blk) beside E1 FULL with 16 and 32 angles per block.
BP: the production K2 ``bp_sl`` beside E2 FULL with two angles per step
(APS 2: both angles'
taps loaded before their products, the counterpart of the TPU's two
angles per contraction). Times per call of a batch of back-to-back calls
(CUDA events) and max|d| against the production kernel, each beside the
card's name and power limit; the last line is JSON.
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
    from tomojax_torch.projector.cuda_joseph import bp_sl, fp_sl

    reps = reps or (5 if device.type == "cuda" else 1)
    geom, x, y = problem(n, ns, device)
    print(f"device: {card}  {n}^2x{ns}, {NA} angles", flush=True)
    res = {}
    for key, tag, fn, base in (
            ("fp_K1", "FP K1 (production)  ", lambda: fp_sl(x, geom), None),
            ("fp_ab16", "FP E1 FULL a_blk=16 ",
             lambda: fp_variant(x, geom, ab=16), "fp_K1"),
            ("fp_ab32", "FP E1 FULL a_blk=32 ",
             lambda: fp_variant(x, geom, ab=32), "fp_K1"),
            ("bp_K2", "BP K2 (production)  ", lambda: bp_sl(y, geom), None),
            ("bp_aps2", "BP E2 FULL two/step ",
             lambda: bp_variant(y, geom, aps=2), "bp_K2")):
        res[key] = timing.batch_ms(fn, reps, device)
        out = fn()
        if base is None:
            ref, err = out, "(baseline)"
        else:
            err = f"max|d|={float((out - ref).abs().max()):.2e}"
        print(f"{tag}: {res[key]:8.4f} ms  {err} [{card}]", flush=True)
    return {"device": card, "n": n, "ns": ns, "na": NA, "ms": res}


def main(argv=None) -> None:
    n, ns, device = timing.parse_args(
        argv, __doc__, ns_of=lambda n: 128 if n >= 512 else n)
    print(json.dumps(run(n, ns, device, timing.card_label(device))))


if __name__ == "__main__":
    main(sys.argv[1:])
