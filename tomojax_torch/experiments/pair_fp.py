"""Forward projection of +-theta from one tap walk, on the card.

    python -m tomojax_torch.experiments.pair_fp [n] [ns] [--device cpu]

The port of scripts/exp_pair_fp.py (n = ns = 256, 90 angles over +-76 deg
by default). For a symmetric series, J*(-theta, row r) = J*(theta, row
N-1-r): the ray of -theta is the ray of +theta through the row-flipped
volume, with the same taps and weights. Rows:

  baseline   E1 FULL over the 90 angles (and the production K1);
  paired     E1 PAIR: 45 walks, each writing the +theta ray and the -theta
             ray (the mirrored window staged beside the window), with
             rel|d| of both halves against the baseline;
  control    the script's control, paired angles without shared taps: E1
             FULL over the 45 positive angles of the [x | row-flipped x]
             stack (the flip and the stack included in the time).

Times per call of a batch of back-to-back calls (CUDA events), each beside
the card's name and power limit; the last line is JSON.
"""

from __future__ import annotations

import json
import sys

import torch

from tomojax_torch.experiments import timing
from tomojax_torch.experiments.cuda_projector_variants import fp_variant
from tomojax_torch.experiments.hat_model import NA, problem
from tomojax_torch.geometry import Geometry


def run(n: int, ns: int, device, card: str, reps: int | None = None) -> dict:
    from tomojax_torch.projector.cuda_joseph import fp_sl

    reps = reps or (5 if device.type == "cuda" else 1)
    geom, x, _ = problem(n, ns, device)
    half = Geometry.make(n, geom.angles[NA // 2:])
    print(f"device: {card}  {n}^2x{ns}, {NA} angles", flush=True)
    res = {}
    res["base_E1"] = timing.batch_ms(lambda: fp_variant(x, geom), reps,
                                      device)
    ref = fp_variant(x, geom)
    print(f"baseline E1 FULL, {NA} angles: {res['base_E1']:8.4f} ms "
          f"[{card}]", flush=True)
    res["base_K1"] = timing.batch_ms(lambda: fp_sl(x, geom), reps, device)
    print(f"baseline K1 (production), {NA} angles: {res['base_K1']:8.4f} ms "
          f"[{card}]", flush=True)
    res["pair"] = timing.batch_ms(lambda: fp_variant(x, geom, pair=True),
                                   reps, device)
    out = fp_variant(x, geom, pair=True)
    ep = timing.rel_max(out[NA // 2:], ref[NA // 2:])
    em = timing.rel_max(out[:NA // 2], ref[:NA // 2])
    print(f"paired E1 PAIR, {NA // 2} pairs: {res['pair']:8.4f} ms  rel|d| "
          f"+:{ep:.2e} -:{em:.2e} [{card}]", flush=True)
    res["base_repeat"] = timing.batch_ms(lambda: fp_variant(x, geom), reps,
                                          device)
    print(f"baseline repeat: {res['base_repeat']:8.4f} ms [{card}]",
          flush=True)

    def control():
        return fp_variant(torch.cat([x, x.flip(0)], dim=2), half)

    res["control"] = timing.batch_ms(control, reps, device)
    got = control()
    ec = max(timing.rel_max(got[:, :, :ns], ref[NA // 2:]),
             timing.rel_max(got[:, :, ns:].flip(0), ref[:NA // 2]))
    print(f"control, {NA // 2} angles on the [x | flipped x] stack (no "
          f"shared taps): {res['control']:8.4f} ms  rel|d|={ec:.2e} "
          f"[{card}]", flush=True)
    return {"device": card, "n": n, "ns": ns, "na": NA, "ms": res,
            "rel": {"pair_plus": ep, "pair_minus": em, "control": ec}}


def main(argv=None) -> None:
    n, ns, device = timing.parse_args(argv, __doc__)
    print(json.dumps(run(n, ns, device, timing.card_label(device))))


if __name__ == "__main__":
    main(sys.argv[1:])
