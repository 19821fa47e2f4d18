"""Where a SART sweep's time goes on the card: ablations of E3.

    python -m tomojax_torch.experiments.sart_ablate [n] [ns] [--device cpu]

The port of scripts/exp_sart_ablate.py (n = ns = 256, 90 angles over
+-76 deg by default). Each of the script's variants is a mode of E3
(`csv.e3_route`: K8's cluster-resident sweep at (8, 4) up to N = 288, K8's
two launches per angle above), named in its row:

  full, rot, phase   TAPS_F32  (rot and phase only restructure the TPU's
                                chunk loop)
  nohat              NOHAT     the constant weight 0.01 on the same taps
  nofp               NOFP      no FP walk (resid = b inv_row): the update
                               pass alone
  noupd              NOUPD     the FP walks, x unchanged: the FP pass alone
  na30               TAPS_F32  at 30 angles (linearity in the angle count)

Per row: the time of one sweep (a batch of sweeps between CUDA events)
beside K8's, rel|d| of one sweep of random data against full, and the rmse
against the phantom after 10 sweeps on the consistent nanocube problem
(meaningful for the TAPS_F32 rows only). Then the split of the step: the
hat (full - nohat), the FP (full - nofp) and the update (full - noupd).
Every number carries the card's name and power limit; the last line is
JSON.
"""

from __future__ import annotations

import json
import sys

from tomojax_torch.experiments import timing
from tomojax_torch.experiments.sart_pipeline import NA, Problems, sweep_of

ABLATIONS = {"full": "TAPS_F32", "nohat": "NOHAT", "nofp": "NOFP",
             "noupd": "NOUPD", "rot": "TAPS_F32", "phase": "TAPS_F32"}


def run(n: int, ns: int, device, card: str, reps: int | None = None) -> dict:
    from tomojax_torch.experiments.cuda_sart_variants import e3_route
    from tomojax_torch.solvers.cuda_sart import sart_shape

    reps = reps or (3 if device.type == "cuda" else 1)
    pb = Problems(n, ns, NA, device)
    route = e3_route(n, pb.geom.nray)
    k8 = sweep_of("K8", None, None)
    k8_ms = timing.batch_ms(lambda: pb.random_sweep(k8), reps, device)
    print(f"device: {card}  {n}^2x{ns}; E3 on the {route} route, K8 on "
          f"{sart_shape(n, pb.geom.nray) or 'streaming'} {k8_ms:.3f} ms",
          flush=True)
    rows, ref = {}, None
    for name, mode in ABLATIONS.items():
        sweep = sweep_of("E3", mode, None)
        out = pb.random_sweep(sweep)
        ref = out if ref is None else ref
        rows[name] = {
            "ms": timing.batch_ms(lambda: pb.random_sweep(sweep), reps,
                                  device),
            "rel": timing.rel_max(out, ref), "rmse10": pb.rmse10(sweep)}
        print(f"na={NA} {name:6s} (E3 {mode:8s}): {rows[name]['ms']:8.3f} ms "
              f"(K8 {k8_ms:.3f})  rel|d|={rows[name]['rel']:.2e}  rmse@10="
              f"{rows[name]['rmse10']:.5f} [{card}]", flush=True)
    pb30 = Problems(n, ns, 30, device)
    sweep = sweep_of("E3", "TAPS_F32", None)
    rows["na30"] = {"ms": timing.batch_ms(lambda: pb30.random_sweep(sweep),
                                          reps, device)}
    print(f"na=30 full   (E3 TAPS_F32): {rows['na30']['ms']:8.3f} ms "
          f"(x {NA / 30:.0f} = {rows['na30']['ms'] * NA / 30:.3f}; K8 "
          f"{k8_ms:.3f} at na={NA}) [{card}]", flush=True)
    full = rows["full"]["ms"]
    split = {"hat (full - nohat)": full - rows["nohat"]["ms"],
             "FP (full - nofp)": full - rows["nofp"]["ms"],
             "update (full - noupd)": full - rows["noupd"]["ms"]}
    print(f"split of E3's step ({route}): " + ", ".join(
        f"{k} {v:+.3f} ms" for k, v in split.items())
        + f"; full {full:.3f}, K8 {k8_ms:.3f} ms [{card}]", flush=True)
    return {"device": card, "n": n, "ns": ns, "na": NA, "route": route,
            "k8_ms": k8_ms, "rows": rows, "split": split}


def main(argv=None) -> None:
    n, ns, device = timing.parse_args(argv, __doc__)
    print(json.dumps(run(n, ns, device, timing.card_label(device))))


if __name__ == "__main__":
    main(sys.argv[1:])
