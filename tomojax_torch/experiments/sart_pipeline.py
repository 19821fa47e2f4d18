"""SART sweep structures on the card: tap tables, bf16 operands and a
sweep in one launch, against the production K8.

    python -m tomojax_torch.experiments.sart_pipeline [n] [ns] [--device cpu]

The port of scripts/exp_sart_pipeline.py (n = ns = 256, 90 angles over
+-76 deg by default). Each of the script's TPU variants is a mode of E3
(K8's two launches per angle) or E4 (one launch per sweep, a slab of
slices per block for every angle), named in its row:

  dbuf, wv_f32           E3 TAPS_F32    (the TPU's pipelining of one step)
  wvmem, wv_rebuild,     E3 TAPS_BF16   (W, x and the residual in bf16)
  wv_reread, wv_fold
  whbm                   E3 TABLE_BF16  (taps and bf16 weights from tables
                                         built once per geometry)
  res / reshbm           E4 TAPS_BF16 / TABLE_BF16 (the resident sweep)
  res_f32, res_f32_sbS   E4 TAPS_F32    (the port's rows: E4 at K8's
                                         precision, 4 and S = 1, 2, 8
                                         slices per block)

Per row: the time of one sweep (a batch of sweeps between CUDA events), the
rmse against the phantom after 10 sweeps on the consistent nanocube problem
(b = A phantom, real SART weights), and rel|d| of one sweep of random data
(the scripts' default_rng(0) volume and sinogram, default_rng(1) weights)
against K8. One-sweep differences on random data are not a measure of
error (ordered SART amplifies roundings there); the rmse is. Every number
carries the card's name and power limit; the last line is JSON.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tomojax_torch.convert import exp_sart_weights
from tomojax_torch.experiments import cuda_sart_variants as csv
from tomojax_torch.experiments import timing
from tomojax_torch.geometry import Geometry

NA = 90
VARIANTS = {  # the script's variant: (the port's sweep, mode, E4's sb)
    "dbuf": ("E3", "TAPS_F32", None), "wvmem": ("E3", "TAPS_BF16", None),
    "wv_rebuild": ("E3", "TAPS_BF16", None),
    "wv_reread": ("E3", "TAPS_BF16", None),
    "wv_f32": ("E3", "TAPS_F32", None), "wv_fold": ("E3", "TAPS_BF16", None),
    "whbm": ("E3", "TABLE_BF16", None), "res": ("E4", "TAPS_BF16", 4),
    "reshbm": ("E4", "TABLE_BF16", 4), "res_f32": ("E4", "TAPS_F32", 4),
    "res_f32_sb1": ("E4", "TAPS_F32", 1),
    "res_f32_sb2": ("E4", "TAPS_F32", 2),
    "res_f32_sb8": ("E4", "TAPS_F32", 8),
}


def sweep_of(kernel: str, mode: str, tables, sb: int = 4):
    """One sweep as fn(x, b, geom, inv_row, inv_col_a, beta, order): K8
    ("K8"), E3 or E4 (sb slices per block) in `mode`."""
    if kernel == "K8":
        from tomojax_torch.solvers.cuda_sart import sart_sweep_sl
        return sart_sweep_sl
    if kernel == "E3":
        return lambda *a: csv.sart_variant(*a, mode, tables)
    return lambda *a: csv.sart_resident(*a, mode, tables, sb)


class Problems:
    """The random problem of the scripts' timing runs and the consistent
    nanocube problem of their convergence check, on `device`."""

    def __init__(self, n: int, ns: int, na: int, device):
        from tomojax_torch.projector.cuda_joseph import fp_sl
        from tomojax_torch.sim import nanocube_phantom
        from tomojax_torch.solvers import (
            make_sart_weights, make_system, to_sl,
        )

        self.n, self.ns, self.device = n, ns, device
        self.geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
        rng = np.random.default_rng(0)
        self.x = torch.from_numpy(
            rng.random((n, n, ns)).astype(np.float32)).to(device)
        self.b = torch.from_numpy(
            rng.random((na, n, ns)).astype(np.float32)).to(device)
        self.weights = tuple(torch.from_numpy(w).to(device)
                             for w in exp_sart_weights(na, n, n))
        self.beta = torch.tensor(1.0, device=device)
        self.order = torch.arange(na, dtype=torch.int32, device=device)
        sysd = make_system(self.geom, device)
        self.real_weights = (sysd.inv_row, make_sart_weights(sysd))
        self.phantom = torch.from_numpy(nanocube_phantom(ns, n)).to(device)
        self.b_real = fp_sl(to_sl(self.phantom), self.geom)

    def random_sweep(self, sweep):
        return sweep(self.x, self.b, self.geom, *self.weights, self.beta,
                     self.order)

    def rmse10(self, sweep) -> float:
        from tomojax_torch import ops
        from tomojax_torch.solvers import from_sl

        x = torch.zeros((self.n, self.n, self.ns), device=self.device)
        for _ in range(10):
            x = sweep(x, self.b_real, self.geom, *self.real_weights,
                      self.beta, self.order)
        return float(ops.rmse(from_sl(x), self.phantom))


def run(n: int, ns: int, device, card: str, reps: int | None = None) -> dict:
    reps = reps or (3 if device.type == "cuda" else 1)
    pb = Problems(n, ns, NA, device)
    print(f"device: {card}  {n}^2x{ns}, {NA} angles", flush=True)
    t0 = time.perf_counter()
    tables = csv.sart_tables(pb.geom, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    w_bytes = NA * n * n * pb.geom.nray * 2
    print(f"tap tables: {tables.nbytes / 1e6:.1f} MB, built in "
          f"{time.perf_counter() - t0:.3f} s by plain PyTorch (the "
          f"reference's bf16 W: {w_bytes / 1e9:.2f} GB) [{card}]",
          flush=True)
    rows = {}
    base = sweep_of("K8", None, None)
    ref = pb.random_sweep(base)
    rows["base"] = {"ms": timing.batch_ms(lambda: pb.random_sweep(base),
                                          reps, device),
                    "rmse10": pb.rmse10(base)}
    print(f"base        (K8)           : {rows['base']['ms']:8.3f} ms  "
          f"rmse@10={rows['base']['rmse10']:.5f} [{card}]", flush=True)
    for name, (kernel, mode, sb) in VARIANTS.items():
        sweep = sweep_of(kernel, mode, tables, sb)
        ms = timing.batch_ms(lambda: pb.random_sweep(sweep), reps, device)
        rel = timing.rel_max(pb.random_sweep(sweep), ref)
        r10 = pb.rmse10(sweep)
        rows[name] = {"ms": ms, "rmse10": r10, "rel": rel}
        print(f"{name:11s} ({kernel} {mode:10s}): {ms:8.3f} ms  rmse@10="
              f"{r10:.5f} (d={abs(r10 - rows['base']['rmse10']):.2e})  "
              f"1-sweep rel|d|={rel:.2e} [{card}]", flush=True)
    return {"device": card, "n": n, "ns": ns, "na": NA,
            "table_bytes": tables.nbytes, "reference_w_bytes": w_bytes,
            "rows": rows}


def main(argv=None) -> None:
    n, ns, device = timing.parse_args(argv, __doc__)
    print(json.dumps(run(n, ns, device, timing.card_label(device))))


if __name__ == "__main__":
    main(sys.argv[1:])
