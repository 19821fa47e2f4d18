"""SART sweep structures on the card: tap tables, bf16 operands and the
resident sweep's cluster shapes, against the production K8.

    python -m tomojax_torch.experiments.sart_pipeline [n] [ns] [--device cpu]

The port of scripts/exp_sart_pipeline.py (n = ns = 256, 90 angles over
+-76 deg by default; also run at 512 128). Each of the script's TPU
variants is a mode of E3 (`csv.e3_route`: K8's cluster-resident sweep, 8
blocks a cluster and 4 slices a pixel, up to N = 288; K8's two launches per
angle above, where K8 itself runs (16, 2) up to N = 528) or E4 (the
resident sweep at a cluster shape of (blocks, slices a pixel)), named in
its row:

  dbuf, wv_f32           E3 TAPS_F32    (the TPU's pipelining of one step)
  wvmem, wv_rebuild,     E3 TAPS_BF16   (W, x and the residual in bf16)
  wv_reread, wv_fold
  whbm                   E3 TABLE_BF16  (taps and bf16 weights from tables
                                         built once per geometry)
  res / reshbm           E4 TAPS_BF16 / TABLE_BF16 at (8, 4) (the resident
                                         sweep)
  res_f32, res_f32_bBsS  E4 TAPS_F32    (the port's rows: E4 at K8's
                                         precision at (8, 4) and at every
                                         other shape, B = 8 or 16 blocks,
                                         S = 1, 2 or 4 slices)

An E4 row whose shape does not fit at this N is printed as such and left
out; E4 never runs another shape in its place. Per row: the time of one
sweep (a batch of sweeps between CUDA events) beside K8's, the rmse
against the phantom after 10 sweeps on the consistent nanocube problem
(b = A phantom, real SART weights), and rel|d| of one sweep of random data
(the scripts' default_rng(0) volume and sinogram, default_rng(1) weights)
against K8; on the card the E4 rows also give their clusters, the clusters
the card holds at once, the waves and the shared memory a block. Then the
split of E3's step: bf16 operands (TAPS_BF16 - TAPS_F32) and tables
(TABLE_BF16 - TAPS_BF16). One-sweep differences on random data are not a
measure of error (ordered SART amplifies roundings there); the rmse is.
Every number carries the card's name and power limit; the last line is
JSON.
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
K8_SHAPE = (csv.BAND_BLOCKS, csv.CLUSTER_SLICES)
VARIANTS = {  # the script's variant: (the port's sweep, mode, E4's shape)
    "dbuf": ("E3", "TAPS_F32", None), "wvmem": ("E3", "TAPS_BF16", None),
    "wv_rebuild": ("E3", "TAPS_BF16", None),
    "wv_reread": ("E3", "TAPS_BF16", None),
    "wv_f32": ("E3", "TAPS_F32", None), "wv_fold": ("E3", "TAPS_BF16", None),
    "whbm": ("E3", "TABLE_BF16", None), "res": ("E4", "TAPS_BF16", K8_SHAPE),
    "reshbm": ("E4", "TABLE_BF16", K8_SHAPE),
    "res_f32": ("E4", "TAPS_F32", K8_SHAPE),
    **{f"res_f32_b{blk}s{sb}": ("E4", "TAPS_F32", (blk, sb))
       for blk, sb in csv.E4_SHAPES if (blk, sb) != K8_SHAPE},
}


def sweep_of(kernel: str, mode: str, tables, shape=K8_SHAPE):
    """One sweep as fn(x, b, geom, inv_row, inv_col_a, beta, order): K8
    ("K8"), E3 or E4 (at cluster shape (blocks, sb)) in `mode`."""
    if kernel == "K8":
        from tomojax_torch.solvers.cuda_sart import sart_sweep_sl
        return sart_sweep_sl
    if kernel == "E3":
        return lambda *a: csv.sart_variant(*a, mode, tables)
    return lambda *a: csv.sart_resident(*a, mode, tables, *shape)


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
    from tomojax_torch.solvers.cuda_sart import sart_shape

    reps = reps or (3 if device.type == "cuda" else 1)
    pb = Problems(n, ns, NA, device)
    route = csv.e3_route(n, pb.geom.nray)
    k8_route = sart_shape(n, pb.geom.nray) or "streaming"
    print(f"device: {card}  {n}^2x{ns}, {NA} angles; K8 on {k8_route}, E3 "
          f"on the {route} route", flush=True)
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
    k8_ms = timing.batch_ms(lambda: pb.random_sweep(base), reps, device)
    rows["base"] = {"ms": k8_ms, "rmse10": pb.rmse10(base)}
    print(f"base          (K8 {k8_route}): {k8_ms:8.3f} ms  "
          f"rmse@10={rows['base']['rmse10']:.5f} [{card}]", flush=True)
    for name, (kernel, mode, shape) in VARIANTS.items():
        launch = ""
        if kernel == "E4":
            if not csv.shape_fits(n, pb.geom.nray, *shape):
                smem = csv.resident_smem_bytes(n, pb.geom.nray, *shape)
                print(f"{name:13s} (E4 {mode:10s} {shape}): does not fit "
                      f"at {n}^2 ({smem} B a block), not run [{card}]",
                      flush=True)
                continue
            if device.type == "cuda":
                c = csv.resident_clusters(n, pb.geom.nray, ns, *shape, mode)
                launch = (f"  {c['clusters']} clusters, {c['active']} at "
                          f"once, {c['waves']} waves, {c['smem']} B a block")
        sweep = sweep_of(kernel, mode, tables, shape)
        ms = timing.batch_ms(lambda: pb.random_sweep(sweep), reps, device)
        rel = timing.rel_max(pb.random_sweep(sweep), ref)
        r10 = pb.rmse10(sweep)
        rows[name] = {"ms": ms, "rmse10": r10, "rel": rel}
        tag = f"{kernel} {mode:10s}" + (f" {shape}" if shape else "")
        print(f"{name:13s} ({tag}): {ms:8.3f} ms (K8 {k8_ms:.3f})  rmse@10="
              f"{r10:.5f} (d={abs(r10 - rows['base']['rmse10']):.2e})  "
              f"1-sweep rel|d|={rel:.2e}{launch} [{card}]", flush=True)
    split = {"bf16 operands (TAPS_BF16 - TAPS_F32)":
             rows["wvmem"]["ms"] - rows["dbuf"]["ms"],
             "tables (TABLE_BF16 - TAPS_BF16)":
             rows["whbm"]["ms"] - rows["wvmem"]["ms"]}
    print(f"split of E3's step ({route}): " + ", ".join(
        f"{k} {v:+.3f} ms" for k, v in split.items())
        + f"; K8 {k8_ms:.3f} ms [{card}]", flush=True)
    return {"device": card, "n": n, "ns": ns, "na": NA, "route": route,
            "table_bytes": tables.nbytes, "reference_w_bytes": w_bytes,
            "rows": rows, "split": split}


def main(argv=None) -> None:
    n, ns, device = timing.parse_args(argv, __doc__)
    print(json.dumps(run(n, ns, device, timing.card_label(device))))


if __name__ == "__main__":
    main(sys.argv[1:])
