#!/usr/bin/env python3
"""Drive the tomojax_torch main path once on one CUDA card and check it.

    python3 chip_smoke.py            (from the root of the repository)

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmul and cuDNN;
2. build: the kernels from tomojax_torch/csrc/ into build/tomojax_torch/
   (one nvcc per source, in parallel), cached by a hash of the sources;
   build time and ptxas report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (256^3 volumes, 90 x 256 x 256 sinograms), with
   the error, the tolerance, both median times, the least time the card
   could take (bytes over 3.35 TB/s or operations over 67 TFLOP/s f32) and,
   for the projectors, the time of torch.sparse.mm with the CSR form of A
   or A^T (built once, not timed); K10 at ab = 2, 3, 6, 8, 10, 16, 32,
   fused and unfused, against K2 (0.0 expected) with device times beside
   K2's, and at the ragged shapes against its plain version; K11 with f32
   and bf16 duals and K12 with f32 duals (0.0), with device times beside
   two K3 launches, and K12 + K4 against K3;
   K1 and K2 (both epilogues) also at ragged shapes (N 33, Na 7, Ns 5 and
   N 48, Na 13, Ns 37) against their plain versions, and at 128 x 512^2 x
   90 against torch.sparse.mm with the CSR form (rel 1e-5); K1, K2, K10
   (ab 6), E1 FULL and E2 FULL with their staged bytes and the
   L2-to-shared and shared-memory read rates at both full shapes, and one
   K8 sweep;
   the SART sweep (K8) on both routes at three levels (one angle step
   from random x, 1e-5 max|x|; one sweep from zero on nanocube
   projections, 1e-4 max|x|; the rmse after 5 sweeps within 1e-4 of the
   plain version's), with two sweeps identical and out-of-range order
   entries leaving x: the resident route at 256^3 x 90 and at N 33, Na 7,
   Ns 5, the streaming route at 128 x 512^2 x 90; each with its clusters,
   waves and shared memory a block (resident), its ms a sweep over 10
   back-to-back sweeps (CUDA events) beside its bound and (resident) the
   phase cycles of the kernel's timed instantiation;
   the slab kernels K9a/K9b/K9c (and K5's right halo) on a 256^3 volume
   cut into 4 slabs of 64 slices, each rank role (bottom, interior, top)
   against the plain version with random halo planes, and on the whole
   256^3 volume as the one rank of phase 4c's group (the shape and halos
   that path gives them, where they are timed), then 4-slab chains
   in one process (10 FGP iterations with f32 and bf16 duals, 10 TV-GD
   gradients) against K3/K4 and K7 on the whole volume; the TV-GD step
   (tj_tv_step) equal to its plain version (torch.equal), clamped and not;
   K7, K9c, the step, K3, K9a, K11 (f32 and bf16 duals, 0.0) and K5 (with
   and without a right halo; two runs identical) at shapes across the
   plane march's boundaries (n0 below and above its chunk, ragged rows,
   n2 = 1, one plane) against their plain versions, K5 on a 4D stack in
   one launch, K7's and K5's partial counts against tv/march.py; and the
   device times of K3 (256^3 and 256^2 x 128), K9a, K7, K9c, the step, K5
   (256^3, and the 3 x 128 x 256^2 stack in one launch beside the
   per-element loop) and K11 beside two K3 launches, with the
   device-memory rate each reaches;
4. main paths, each with every launch count set to 0 just before it and
   read just after, and with every plain version made to raise:
   a. FISTA-TV: TomoTorch on the 256 x 256^2 x 90 nanocube problem (one
      warm-up iteration, then 10), then the functional fista_init_sl +
      fista_run_sl, timed with CUDA events, and a torch.profiler window of
      2 iterations by kernel with the idle share;
   b. ASD-POCS: TomoTorch.asd_pocs on the same problem (one warm-up
      iteration, then 5) and TomoTorch.sart (2 sweeps), then the
      functional asd_pocs_run and one sart_sweep_sl (its route, one-call
      and batch ms), timed with CUDA events, and a profiler window of 2
      asd_pocs_run iterations;
   c. the slab-sharded path: an NCCL group of world size 1 (file store
      under build/), TomoTorch(..., group=g).fista (10 iterations) and
      .asd_pocs (5) on the same problem, and the functional runs with the
      group; their traces against the unsharded path's (FISTA dd and tv
      rtol 1e-5, ASD-POCS dd rtol 1e-3) and ms/iteration of both paths;
   d. the fusion path: ChemicalTomo on a simulated 3 x 128 x 256^2
      problem (HAADF 90, chemistry 45 angles over +-76 deg):
      chemical_tomography, the data_fusion host loop (K1-K5 must launch
      there), data_fusion(fused=True) and method='sart' (K8); K1, K2, K3,
      K4, K5 and K8 then held against their plain versions at the shapes
      this path gives them (element 0 of its state, 256^2 x 128, under both
      geometries; K5 also on the whole 4D state in one launch), with phase
      3's bounds; then the
      outer iteration as bench.py times it (random data from
      default_rng(0)), ms/iteration over 5 iterations with CUDA events
      and a torch.profiler breakdown with the idle share;
   e. the variant entry points at 256^3: tv_fgp_fused(fuse_pairs=True)
      (K11) against the K3 chain with f32 and bf16 duals, tv_fgp_two_pass
      (K12) against tv_fgp_fused with f32 duals, 10 ASTRA-SIRT iterations
      at 256^3 x 90 with bp_sirt_sl(ab=6) (K10) against K2;
   f. the experiments (tomojax_torch.experiments, the counterparts of
      scripts/exp_*.py): every instantiation of E1 (the FP weight forms
      FULL, HAT5, BF16, NOHAT, NODOT, W4 and PAIR, each at 1, 2, 4, 8, 16
      and 32 angles a block, with device times beside K1's; also at N 33,
      Na 7, Ns 5 and N 48, Na 14, Ns 37) and E2 (the BP forms FULL, BF16,
      NOHAT, NODOT, W4; two angles per step; bit-equal required, also at
      N 33, Na 7, Ns 5 and N 48, Na 13, Ns 37; batch ms beside K2's with
      the split FULL - NOHAT, FULL - NODOT) held against its plain
      version at 256^3 x 90 (bound 1e-5 max|out|, torch.sparse.mm beside
      the forms that compute A x or A^T y), and of E3 (the SART modes
      TAPS_F32, TAPS_BF16, TABLE_BF16, NOHAT, NOFP, NOUPD, two launches per
      angle) and E4 (TAPS_F32, TAPS_BF16, TABLE_BF16, one launch per sweep)
      over one sweep from zero on nanocube projections (bound 1e-4 max|x|);
      cuobjdump -sass of the ablations (E1's and E2's NODOT keep their adds
      with no ring copy or shared load, their NOHAT the ring copies and
      shared loads), with registers and stack bytes per kernel; then the
      six drivers
      (hat_model, projector_variants, projector_variants2, pair_fp,
      sart_pipeline, sart_ablate) at 256^3 x 90, each with the E launch
      counts set to 0 before it and read after, their rows printed, the
      SART variants' rmse after 10 sweeps held against K8's (rtol 1e-4 for
      float32, 2e-2 for bf16) and the paired FP against the unpaired (rel
      1e-5);
   every kernel of a path must have launched in it;
5. golden: the 32 x 256^2 x 90, 20-iteration trace of
   tests/golden/fista_tpu_256.json replayed within rtol 5e-3 (dd, tv) and
   1e-3 (final rmse); the 16 x 64^2 x 30, 10-iteration ASD-POCS trace of
   tests/golden/asd_pocs_jax_cpu.json and the 2 x 8 x 64^2 ChemicalTomo
   trace of tests/golden/fusion_jax_cpu.json (float32 FGP duals; the
   lambda_chem decay iterations first, as a branch check) replayed within
   the bounds stored in them;
6. result: a JSON line of the kernels (K1-K12, then E1-E4 as one row per
   TPU kernel of scripts/exp_*.py), then the device line last.

    python3 chip_smoke.py --projector-times

times only K1, K2, K10 (ab 6), E1 FULL, E2 FULL and one K8 sweep at
256^3 x 90 and 128 x 512^2 x 90, with the tomojax_torch package beside
the file (a copy of it beside another tree times that tree's kernels).

    python3 chip_smoke.py --tv-times

times only K3, K9a, K7, K9c, the TV step kernel (where the tree has it),
the PyTorch step expression, K5 and K11 (bf16 duals) beside two K3 launches
at 256^3 (K3 also at 256^2 x 128), and K5 on the 3 x 128 x 256^2 fusion
stack, one launch (where the tree takes a 4D stack) and the per-element
loop, in the same way beside another tree.

It imports nothing of JAX. Without a CUDA device it exits with 1 before
printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
LAM, N_TV = 0.1, 10


class PhaseFailed(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def time_ms(fn, reps: int) -> float:
    """Median time of one call of `fn` on the card, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10, kernel: str = "") -> float:
    """Device time of the kernels one call of `fn` launches (mean of `reps`
    calls after a warm-up, from torch.profiler's CUDA events), or of those
    whose name holds `kernel`: unlike `time_ms` it leaves out the gaps
    while the host issues the launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == cuda and kernel in e.name)
    return us / reps / 1e3


def max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max())


def sm_clock() -> str:
    """The card's SM clock now and its maximum, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


# ------------------------------------------------------------------ phase 1


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    require(bool(card), "nvidia-smi printed no card")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card.splitlines()[0]


# ------------------------------------------------------------------ phase 2


def phase_build() -> None:
    from tomojax_torch import _build

    info = _build.build()
    how = (f"built in {info.seconds:.2f} s" if info.seconds
           else "reused (same source hash)")
    print(f"build: {info.path.relative_to(ROOT)} {how}")
    for line in info.log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _build.lib()


# ------------------------------------------------------------------ phase 3


def _kernel_table():
    from tomojax_torch.projector import cuda_joseph as cj
    from tomojax_torch.solvers import cuda_sart
    from tomojax_torch.tv import (
        cuda_fgp, cuda_fgp_sharded, cuda_tv_value, cuda_tvgd,
        cuda_tvgd_sharded,
    )

    return {
        "K1_fp_resid": (cj.fp_resid_sl, "tomojax_torch/csrc/joseph.cu",
                        "tomojax/projector/pallas_joseph.py:510"),
        "K1_fp": (cj.fp_sl, "tomojax_torch/csrc/joseph.cu",
                  "tomojax/projector/pallas_joseph.py:290"),
        "K2_bp_sirt": (cj.bp_sirt_sl, "tomojax_torch/csrc/joseph.cu",
                       "tomojax/projector/pallas_joseph.py:660"),
        "K2_bp": (cj.bp_sl, "tomojax_torch/csrc/joseph.cu",
                  "tomojax/projector/pallas_joseph.py:660"),
        "K3_fgp_iter": (cuda_fgp.fgp_iter, "tomojax_torch/csrc/fgp.cu",
                        "tomojax/tv/pallas_fgp.py:124"),
        "K4_fgp_obj_mom": (cuda_fgp.fgp_obj_mom, "tomojax_torch/csrc/fgp.cu",
                           "tomojax/tv/pallas_fgp.py:86"),
        "K5_tv_value": (cuda_tv_value.tv_value,
                        "tomojax_torch/csrc/tv_value.cu",
                        "tomojax/tv/pallas_tv_value.py:32"),
        "K7_tv_grad": (cuda_tvgd.tv_grad, "tomojax_torch/csrc/tvgd.cu",
                       "tomojax/tv/pallas_tvgd.py:49"),
        "K8_sart_sweep": (cuda_sart.sart_sweep_sl,
                          "tomojax_torch/csrc/sart.cu",
                          "tomojax/solvers/pallas_sart.py:217"),
        "K9a_fgp_iter_halo": (cuda_fgp_sharded.fgp_iter_halo,
                              "tomojax_torch/csrc/fgp.cu",
                              "tomojax/tv/pallas_fgp_sharded.py:40"),
        "K9b_fgp_obj_halo": (cuda_fgp_sharded.fgp_obj_halo,
                             "tomojax_torch/csrc/fgp.cu",
                             "tomojax/tv/pallas_fgp_sharded.py:110"),
        "K9c_tv_grad_halo": (cuda_tvgd_sharded.tv_grad_halo,
                             "tomojax_torch/csrc/tvgd.cu",
                             "tomojax/tv/pallas_tvgd_sharded.py:42"),
        "K10_bp_ab": (cj.bp_ab_sl, "tomojax_torch/csrc/joseph.cu",
                      "tomojax/projector/pallas_joseph.py:606"),
        "K11_fgp_iter2": (cuda_fgp.fgp_iter2, "tomojax_torch/csrc/fgp.cu",
                          "tomojax/tv/pallas_fgp.py:217"),
        "K12_fgp_grad": (cuda_fgp.fgp_grad, "tomojax_torch/csrc/fgp.cu",
                         "tomojax/tv/pallas_fgp.py:98"),
        # the TV-GD step, which XLA fused around the TPU kernel
        "tv_step": (cuda_tvgd.tv_step, "tomojax_torch/csrc/tvgd.cu",
                    "tomojax/tv/pallas_tvgd.py:96"),
    }


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def bound(bytes_: float, ops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over the float32
    rate (each input read once, each output written once)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fgp_iter_work(v: int, dual_bytes: int, iters: int = 1):
    """(bytes, operations) of `iters` fused FGP iterations on v voxels: x
    read, three duals read and written once; per voxel and iteration 51
    operations (d at the voxel and its 3 forward neighbours, 8 each; the
    differences, the dual step and the projection, 19)."""
    return v * (4 + 6 * dual_bytes), 51 * v * iters


def _joseph_taps(geom, dev):
    """Both taps of every (angle, pixel), (Na, N, N) each, from the Joseph
    closed form that K2 gathers with (the tables of
    cuda_joseph.angle_tables): the bin j, the weight w and where it is a
    nonzero of A (j in [0, Nt), w != 0)."""
    from tomojax_torch.projector.cuda_joseph import angle_tables

    n, nt = geom.n, geom.nray
    t = angle_tables(geom, dev).bp
    c, s, invd = (t[:, i, None, None] for i in range(3))
    ctr = (n - 1) / 2.0
    xc = torch.arange(n, dtype=torch.float32, device=dev) - ctr
    yr = ctr - torch.arange(n, dtype=torch.float32, device=dev)
    jstar = c * xc[None, None, :] + s * yr[None, :, None] + (nt - 1) / 2.0
    f = torch.floor(jstar)
    j0 = f.long()
    for j, fj in ((j0, f), (j0 + 1, f + 1.0)):
        w = torch.clamp_min(1.0 - torch.abs(fj - jstar) * invd, 0.0) * invd
        yield j, w, (j >= 0) & (j < nt) & (w != 0)


def joseph_nnz(geom) -> int:
    """The nonzeros of A at this geometry, as joseph_csr counts them."""
    return sum(int(keep.sum()) for _, _, keep in
               _joseph_taps(geom, torch.device("cuda")))


def joseph_csr(geom, dev):
    """A (Na Nt x N^2) and A^T as CSR on the card, from the Joseph closed
    form that K2 gathers with (the tables of cuda_joseph.angle_tables), and
    the number of nonzeros: the yardstick `torch.sparse.mm` multiplies with
    (cuSPARSE SpMM), built once and not timed."""
    n, nt, na = geom.n, geom.nray, geom.nproj
    pix = torch.arange(n * n, device=dev).reshape(1, n, n).expand(na, n, n)
    ang = torch.arange(na, device=dev).reshape(na, 1, 1).expand(na, n, n)
    rows, cols, vals = [], [], []
    for j, w, keep in _joseph_taps(geom, dev):
        rows.append((ang * nt + j)[keep])
        cols.append(pix[keep])
        vals.append(w[keep])
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    with warnings.catch_warnings():  # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                    (na * nt, n * n),
                                    check_invariants=False).coalesce()
        at = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals,
                                     (n * n, na * nt),
                                     check_invariants=False).coalesce()
        return a.to_sparse_csr(), at.to_sparse_csr(), int(a.values().numel())


def _launched(wrapper, fn):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    require(wrapper.launches > before, f"{wrapper.__name__} did not launch")
    return out


def phase_kernels(card: str) -> dict:
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector import cuda_joseph as cj
    from tomojax_torch.tv import cuda_fgp, cuda_tv_value, cuda_tvgd
    from tomojax_torch.tv.cuda_fgp import tv_fgp_fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uni(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    n, na, ns = 256, 90, 256
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    rows = {}
    # this run's work: V voxels, S sinogram entries, P pixels per slice,
    # nnz nonzero weights of A (from K2's taps at this geometry)
    V, S, P = n * n * ns, na * n * ns, n * n
    A, At, nnz = joseph_csr(geom, dev)
    spmv = 2 * nnz * ns  # one multiply-add per nonzero and slice

    def report(name, err, tol, ms, plain_ms, extra="", *, work,
               library_ms=None):
        """work = (bytes, operations) the function must move and do."""
        require(err <= tol, f"{name}: error {err:.3e} above {tol:.3e}")
        bound_ms, bound_by = bound(*work)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        print(f"{name}: max|kernel - plain| {err:.3e} <= {tol:.3e}{extra}; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound "
              f"{bound_ms:.4f} ms ({bound_by}) [{card}]")

    # K1 with the residual epilogue
    x, b, ax_old = uni(n, n, ns), uni(na, n, ns), uni(na, n, ns)
    inv_row = uni(na, n, lo=0.1)
    beta = torch.tensor(0.3, device=dev)
    args = (x, geom, b, ax_old, inv_row, beta)
    got = _launched(cj.fp_resid_sl, lambda: cj.fp_resid_sl(*args))
    ref = cj.fp_resid_sl_ref(*args)
    err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
    tol = 1e-5 * max(float(ref[0].abs().max()), float(ref[1].abs().max()))
    dd_rel = abs(float(got[2]) - float(ref[2])) / float(ref[2])
    require(dd_rel <= 2e-5, f"K1 ddsq relative error {dd_rel:.3e}")
    xm = x.reshape(P, ns)
    fp_lib = time_ms(lambda: torch.sparse.mm(A, xm), 5)
    lib_rel = max_err(torch.sparse.mm(A, xm).reshape(got[0].shape), got[0]) \
        / float(got[0].abs().max())
    require(lib_rel <= 1e-5, f"CSR A x vs K1: {lib_rel:.3e}")
    report("K1_fp_resid", err, tol, time_ms(lambda: cj.fp_resid_sl(*args), 5),
           time_ms(lambda: cj.fp_resid_sl_ref(*args), 3),
           f" (ddsq rel {dd_rel:.2e} <= 2e-5; CSR A x ({nnz} nonzeros) vs "
           f"K1 rel {lib_rel:.1e})",
           work=(4 * (V + 4 * S + na * n + 1), spmv + 8 * S),
           library_ms=fp_lib)

    # K1 with the epilogue off, K2 both ways, and the adjoint pair
    got = _launched(cj.fp_sl, lambda: cj.fp_sl(x, geom))
    ref = cj.fp_sl_ref(x, geom)
    report("K1_fp", max_err(got, ref), 1e-5 * float(ref.abs().max()),
           time_ms(lambda: cj.fp_sl(x, geom), 5),
           time_ms(lambda: cj.fp_sl_ref(x, geom), 3),
           work=(4 * (V + S), spmv), library_ms=fp_lib)
    resid = uni(na, n, ns, lo=-1.0)
    y_vol, inv_col = uni(n, n, ns), uni(n, n, hi=0.05)
    args = (resid, geom, y_vol, inv_col)
    got = _launched(cj.bp_sirt_sl, lambda: cj.bp_sirt_sl(*args))
    ref = cj.bp_sirt_sl_ref(*args)
    ym = resid.reshape(na * n, ns)
    bp_lib = time_ms(lambda: torch.sparse.mm(At, ym), 5)
    k2 = cj.bp_sl(resid, geom)
    lib_rel = max_err(torch.sparse.mm(At, ym).reshape(k2.shape), k2) \
        / float(k2.abs().max())
    require(lib_rel <= 1e-5, f"CSR A^T y vs K2: {lib_rel:.3e}")
    report("K2_bp_sirt", max_err(got, ref), 1e-5 * float(ref.abs().max()),
           time_ms(lambda: cj.bp_sirt_sl(*args), 5),
           time_ms(lambda: cj.bp_sirt_sl_ref(*args), 3),
           f" (CSR A^T y vs K2 rel {lib_rel:.1e})",
           work=(4 * (S + 2 * V + P), spmv + 3 * V), library_ms=bp_lib)
    _check_bp_ab(args, report, work=(4 * (S + 2 * V + P), spmv + 3 * V),
                 library_ms=bp_lib)
    got = _launched(cj.bp_sl, lambda: cj.bp_sl(b, geom))
    ref = cj.bp_sl_ref(b, geom)
    lhs = float(torch.sum(cj.fp_sl(x, geom).double() * b.double()))
    rhs = float(torch.sum(x.double() * got.double()))
    adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    require(adj <= 1e-5, f"adjointness {adj:.3e} above 1e-5")
    report("K2_bp", max_err(got, ref), 1e-5 * float(ref.abs().max()),
           time_ms(lambda: cj.bp_sl(b, geom), 5),
           time_ms(lambda: cj.bp_sl_ref(b, geom), 3),
           f" (<Ax,y> vs <x,A^T y> rel {adj:.2e} <= 1e-5)",
           work=(4 * (S + V), spmv), library_ms=bp_lib)
    del A, At
    # their own generator, so that the checks below draw what they drew
    # before these were added
    gen2 = torch.Generator(device=dev).manual_seed(1)

    def uni2(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen2, device=dev) * (hi - lo) + lo

    projector_times(geom, ns, uni2, card, "projectors")
    _check_projector_tiles(uni2, card)

    # K3 + K4: 10 chained FGP iterations, f32 and bf16 duals
    x_old = uni(n, n, ns)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        p = tuple(torch.zeros(x.shape, dtype=dt, device=dev)
                  for _ in range(3))
        for _ in range(N_TV - 1):
            p = cuda_fgp.fgp_iter_ref(x, *p, LAM)
        d_ref, y_ref = cuda_fgp.fgp_obj_mom_ref(x, *p, LAM, x_old, beta)
        d, y = tv_fgp_fused(x, N_TV, LAM, dual_dtype=dt, mom=(x_old, beta))
        torch.cuda.synchronize()
        errs[dt] = max(max_err(d, d_ref), max_err(y, y_ref))
    tol32, tol16 = 1e-4 * float(x.abs().max()), LAM * 2e-2
    require(errs[torch.float32] <= tol32,
            f"FGP chain f32: {errs[torch.float32]:.3e} above {tol32:.3e}")
    print(f"K3+K4 chain of {N_TV}, f32 duals: {errs[torch.float32]:.3e} "
          f"<= {tol32:.3e}")
    p = tuple(torch.zeros(x.shape, dtype=torch.bfloat16, device=dev)
              for _ in range(3))
    got = _launched(cuda_fgp.fgp_iter, lambda: cuda_fgp.fgp_iter(x, *p, LAM))
    ref = cuda_fgp.fgp_iter_ref(x, *p, LAM)
    err3 = max(max_err(g.float(), r.float()) for g, r in zip(got, ref))
    require(err3 <= 2 ** -7, f"K3 single iteration bf16 duals: {err3:.3e}")
    p = got
    report("K3_fgp_iter", errs[torch.bfloat16], tol16,
           time_ms(lambda: cuda_fgp.fgp_iter(x, *p, LAM), 10),
           time_ms(lambda: cuda_fgp.fgp_iter_ref(x, *p, LAM), 5),
           f" (chain of {N_TV}, bf16 duals; one iteration's duals "
           f"{err3:.2e} <= 2^-7)", work=fgp_iter_work(V, 2))
    got = _launched(cuda_fgp.fgp_obj_mom,
                    lambda: cuda_fgp.fgp_obj_mom(x, *p, LAM, x_old, beta))
    ref = cuda_fgp.fgp_obj_mom_ref(x, *p, LAM, x_old, beta)
    report("K4_fgp_obj_mom",
           max(max_err(got[0], ref[0]), max_err(got[1], ref[1])),
           1e-6 * float(ref[1].abs().max()),
           time_ms(lambda: cuda_fgp.fgp_obj_mom(x, *p, LAM, x_old, beta), 10),
           time_ms(lambda: cuda_fgp.fgp_obj_mom_ref(x, *p, LAM, x_old, beta),
                   5), " (one pass, bf16 duals)",
           work=(V * (4 + 3 * 2 + 4 + 4 + 4) + 4, 11 * V))
    _check_fgp_variants(x, p, report)

    # K5
    got = _launched(cuda_tv_value.tv_value, lambda: cuda_tv_value.tv_value(x))
    ref = cuda_tv_value.tv_value_ref(x)
    again = cuda_tv_value.tv_value(x)
    require(float(again) == float(got), "K5 is not repeatable")
    report("K5_tv_value", abs(float(got) - float(ref)),
           2e-5 * abs(float(ref)),
           time_ms(lambda: cuda_tv_value.tv_value(x), 10),
           time_ms(lambda: cuda_tv_value.tv_value_ref(x), 5),
           " (rtol 2e-5; two runs identical)", work=(4 * V + 4, 11 * V))

    # K7: the TV-GD subgradient and ||g||^2
    got, gsq = _launched(cuda_tvgd.tv_grad, lambda: cuda_tvgd.tv_grad(x))
    ref, gsq_ref = cuda_tvgd.tv_grad_ref(x)
    again, gsq_again = cuda_tvgd.tv_grad(x)
    require(torch.equal(again, got) and float(gsq_again) == float(gsq),
            "K7 is not repeatable")
    gsq_rel = abs(float(gsq) - float(gsq_ref)) / float(gsq_ref)
    require(gsq_rel <= 2e-5, f"K7 ||g||^2 relative error {gsq_rel:.3e}")
    report("K7_tv_grad", max_err(got, ref), 1e-5 * float(ref.abs().max()),
           time_ms(lambda: cuda_tvgd.tv_grad(x), 10),
           time_ms(lambda: cuda_tvgd.tv_grad_ref(x), 5),
           f" (||g||^2 rel {gsq_rel:.2e} <= 2e-5; two runs identical)",
           work=(8 * V + 4, 27 * V))
    _check_tv_step(x, got, gsq, report)
    _check_tv_march(uni2, card)

    _check_sart(geom, ns, uni, report, nnz, card)
    _check_halo_kernels(x, uni, report, card)
    tv_times(uni2, card, "tv")
    _check_slab_chains(x, x_old, beta)
    return rows


def _check_tv_step(x, g, gsq, report) -> None:
    """tj_tv_step against tv_step_ref with torch.equal (the same rounding),
    unclamped and clamped, with dpocs a float and a 0-dim tensor."""
    from tomojax_torch.tv import cuda_tvgd

    dp_t = torch.tensor(0.02, device=x.device)
    for dp in (0.02, dp_t):
        for clamp in (False, True):
            got = _launched(cuda_tvgd.tv_step, lambda: cuda_tvgd.tv_step(
                x, g, gsq, dp, clamp))
            require(torch.equal(got, cuda_tvgd.tv_step_ref(x, g, gsq, dp,
                                                           clamp)),
                    f"tv_step (clamp {clamp}, dpocs {type(dp).__name__}) "
                    f"differs from x - dpocs * g / torch.sqrt(gsq)")
    V = x.numel()
    report("tv_step", 0.0, 0.0,
           time_ms(lambda: cuda_tvgd.tv_step(x, g, gsq, dp_t, True), 10),
           time_ms(lambda: cuda_tvgd.tv_step_ref(x, g, gsq, dp_t, True), 5),
           " (torch.equal, clamped and not, dpocs float and 0-dim)",
           work=(12 * V + 8, 4 * V))


TV_SHAPES = ((5, 11, 37), (40, 16, 1), (70, 33, 130), (256, 256, 64),
             (1, 8, 32))


def _check_tv_march(uni, card: str) -> None:
    """K7, K9c, the step, K3, K9a, K11 and K5 against their plain versions
    at shapes that cross the march's boundaries (n0 below and above TV_C,
    ragged n1 and n2, n2 = 1, one plane; the slab of a 4-way split at
    256^2), with phase 3's bounds (K3 f32 duals 1e-6, bf16 one rounding,
    2^-7; K11 0.0; K5 rtol 2e-5, two runs identical, with and without a
    right halo), K5 on a 4D stack in one launch, and K7's and K5's partial
    counts against tv/march.py."""
    from tomojax_torch import _build
    from tomojax_torch.tv import cuda_fgp, cuda_tv_value, cuda_tvgd, march
    from tomojax_torch.tv import cuda_fgp_sharded as fs
    from tomojax_torch.tv import cuda_tvgd_sharded as gs

    worst = {}

    def held(name, err, tol):
        require(err <= tol, f"{name}: {err:.3e} above {tol:.3e}")
        worst[name] = max(worst.get(name, 0.0), err)

    def k5(name, x, hi=None):
        got = cuda_tv_value.tv_value(x, hi)
        again = cuda_tv_value.tv_value(x, hi)
        ref = float(cuda_tv_value.tv_value_ref(x, hi))
        require(float(got) == float(again), f"{name} is not repeatable")
        held(name, abs(float(got) - ref) / abs(ref), 2e-5)

    for shape in TV_SHAPES:
        require(_build.lib().tj_tv_grad_partials(*shape)
                == march.grad_partials(*shape),
                f"K7 partials at {shape}: tj_tv_grad_partials vs "
                f"march.grad_partials")
        require(_build.lib().tj_tv_value_partials(3, *shape)
                == march.value_partials(3, *shape),
                f"K5 partials at 3 x {shape}: tj_tv_value_partials vs "
                f"march.value_partials")
        x = uni(*shape, lo=-0.5, hi=1.5)
        lo, hi = uni(*shape[:2]), uni(*shape[:2])
        k5("K5 rel", x)
        k5("K5 halo rel", x, hi)
        for name, (g, gsq), (g_r, gsq_r) in (
                ("K7", cuda_tvgd.tv_grad(x), cuda_tvgd.tv_grad_ref(x)),
                ("K9c", gs.tv_grad_halo(x, lo, hi),
                 gs.tv_grad_halo_ref(x, lo, hi))):
            held(name, max_err(g, g_r), 1e-5 * float(g_r.abs().max()))
            held(f"{name} ||g||^2 rel", abs(float(gsq) - float(gsq_r))
                 / float(gsq_r), 2e-5)
            require(torch.equal(cuda_tvgd.tv_step(x, g, gsq, 0.05, True),
                                cuda_tvgd.tv_step_ref(x, g, gsq, 0.05, True)),
                    f"tv_step at {shape}")
        for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2 ** -7)):
            p = tuple((uni(*shape) - 0.5).to(dt) for _ in range(3))
            p3_lo = (uni(*shape[:2]) - 0.5).to(dt)
            his = (uni(*shape[:2]), *((uni(*shape[:2]) - 0.5).to(dt)
                                      for _ in range(3)))
            for name, got, ref in (
                    ("K3", cuda_fgp.fgp_iter(x, *p, LAM),
                     cuda_fgp.fgp_iter_ref(x, *p, LAM)),
                    ("K9a", fs.fgp_iter_halo(x, *p, LAM, p3_lo, his),
                     fs.fgp_iter_halo_ref(x, *p, LAM, p3_lo, his)),
                    ("K9a top", fs.fgp_iter_halo(x, *p, LAM, p3_lo),
                     fs.fgp_iter_halo_ref(x, *p, LAM, p3_lo)),
                    ("K11", cuda_fgp.fgp_iter2(x, *p, LAM),
                     cuda_fgp.fgp_iter2_ref(x, *p, LAM))):
                held(f"{name} {str(dt)[6:]}", max(
                    max_err(a.float(), b.float()) for a, b in zip(got, ref)),
                    0.0 if name == "K11" else tol)
    stack = uni(3, 40, 16, 36, lo=-0.5, hi=1.5)
    before = cuda_tv_value.tv_value.launches
    k5("K5 4D rel", stack)
    require(cuda_tv_value.tv_value.launches == before + 2,
            "K5 took more than one launch for a 4D stack")
    torch.cuda.synchronize()
    print(f"TV march at {', '.join('x'.join(map(str, s)) for s in TV_SHAPES)}"
          f" and K5 on a 3x40x16x36 stack (one launch): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; tv_step equal; K5 two runs identical; K7 and K5 partials as "
          f"march.py [{card}]")


def tv_times(uni, card: str, tag: str) -> dict:
    """Device ms (torch.profiler, mean of 10) and batch ms (CUDA events over
    10 back-to-back calls) of K3 (bf16 duals) at 256^3 and at fusion's
    256^2 x 128, K9a (world size 1: zero P3 plane below, no right halo), K7,
    K9c (the volume's own last and first slices as halos), the TV step
    (where this tree has the kernel), the PyTorch step expression, K5, K11
    (bf16 duals) and two K3 launches at 256^3, and K5 on fusion's 3 x 128 x
    256^2 stack (one launch where this tree takes a 4D stack; the
    per-element loop), with the device-memory rate each reaches (the bytes
    it must move over its device time)."""
    from tomojax_torch.experiments.timing import batch_ms
    from tomojax_torch.tv import cuda_fgp, cuda_tv_value, cuda_tvgd, march
    from tomojax_torch.tv import cuda_fgp_sharded as fs
    from tomojax_torch.tv import cuda_tvgd_sharded as gs

    n = 256
    x = uni(n, n, n)
    xf = uni(n, n, n // 2)
    P = n * n
    p = tuple((uni(n, n, n) - 0.5).bfloat16() for _ in range(3))
    pf = tuple((uni(n, n, n // 2) - 0.5).bfloat16() for _ in range(3))
    zero = torch.zeros((n, n), dtype=torch.bfloat16, device=x.device)
    lo_x, hi_x = _last(x), _first(x)
    g, gsq = cuda_tvgd.tv_grad(x)
    dp = torch.tensor(0.02, device=x.device)
    calls = {
        "K3 bf16 256^3": (lambda: cuda_fgp.fgp_iter(x, *p, LAM),
                          16 * x.numel()),
        "K3 bf16 256^2x128": (lambda: cuda_fgp.fgp_iter(xf, *pf, LAM),
                              16 * xf.numel()),
        "K9a bf16 256^3": (lambda: fs.fgp_iter_halo(x, *p, LAM, zero),
                           16 * x.numel() + 2 * P),
        "K7 256^3": (lambda: cuda_tvgd.tv_grad(x), 8 * x.numel()),
        "K9c 256^3": (lambda: gs.tv_grad_halo(x, lo_x, hi_x),
                      8 * x.numel() + 8 * P),
        "step PyTorch 256^3": (lambda: torch.clamp_min(
            x - dp * g / torch.sqrt(gsq), 0.0), 12 * x.numel()),
    }
    if hasattr(cuda_tvgd, "tv_step"):
        calls["step kernel 256^3"] = (
            lambda: cuda_tvgd.tv_step(x, g, gsq, dp, True), 12 * x.numel())
    xs = uni(3, n, n, n // 2)
    calls["K5 256^3"] = (lambda: cuda_tv_value.tv_value(x), 4 * x.numel())
    if hasattr(march, "value_partials"):
        calls["K5 3x256^2x128 one launch"] = (
            lambda: cuda_tv_value.tv_value(xs), 4 * xs.numel())
    calls["K5 3x256^2x128 per element"] = (
        lambda: torch.stack([cuda_tv_value.tv_value(e) for e in xs]).sum(),
        4 * xs.numel())
    calls["K11 bf16 256^3"] = (lambda: cuda_fgp.fgp_iter2(x, *p, LAM),
                               16 * x.numel())
    calls["two K3 bf16 256^3"] = (
        lambda: cuda_fgp.fgp_iter(x, *cuda_fgp.fgp_iter(x, *p, LAM), LAM),
        32 * x.numel())
    out = {}
    for name, (fn, nbytes) in calls.items():
        dev, batch = device_ms(fn), batch_ms(fn, 10, x.device)
        out[name] = (dev, batch)
        print(f"{tag} {name}: {dev:.4f} ms device, {batch:.4f} ms batch, "
              f"{nbytes / dev / 1e9:.3f} TB/s at the device time [{card}]")
    # K5's two launches apart: the march and tj::sum_partials
    k5 = calls["K5 256^3"][0]
    split = (device_ms(k5, kernel="tv_value_kernel"),
             device_ms(k5, kernel="sum_kernel"))
    out["K5 256^3 march, partial sum"] = split
    print(f"{tag} K5 256^3 apart: march {split[0]:.4f} ms, partial sum "
          f"{split[1]:.4f} ms device [{card}]")
    return out


AB_SWEEP = (2, 3, 6, 8, 10, 16, 32)  # K10's stages held and timed


def _check_bp_ab(args, report, *, work, library_ms) -> None:
    """K10 at every ab of AB_SWEEP, fused and unfused, against K2's output
    (bound 1e-6 max|out|; 0.0 expected: the same taps added in K2's order,
    padded angles adding fmaf(0, 0, acc)), with each one's device time
    beside K2's; at ab = 6 fused (the row's time) against its plain version
    on the zero-padded angle set (K2's bound, 1e-5 max|out|); then at the
    ragged shapes, every ab against the plain version and K2."""
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector import cuda_joseph as cj

    resid, geom, y_vol, inv_col = args
    k2, k2u = cj.bp_sirt_sl(*args), cj.bp_sl(resid, geom)
    tol = 1e-6 * float(k2.abs().max())
    worst, out = 0.0, []
    for ab in AB_SWEEP:
        got = _launched(cj.bp_ab_sl, lambda: cj.bp_sirt_sl(*args, ab=ab))
        gu = cj.bp_sl(resid, geom, ab=ab)
        e = max(max_err(got, k2), max_err(gu, k2u))
        require(e <= tol, f"K10 ab={ab} vs K2: {e:.3e} above {tol:.3e}")
        worst = max(worst, e)
        fused = device_ms(lambda: cj.bp_sirt_sl(*args, ab=ab), 5)
        plain = device_ms(lambda: cj.bp_sl(resid, geom, ab=ab), 5)
        out.append(f"ab={ab} {fused:.4f}/{plain:.4f}")
    k2_dev = device_ms(lambda: cj.bp_sirt_sl(*args), 5)
    k2u_dev = device_ms(lambda: cj.bp_sl(resid, geom), 5)
    gen = torch.Generator(device=resid.device).manual_seed(3)
    ragged = 0.0
    for n, na, ns in RAGGED_SHAPES:
        g = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
        y, yv, ic = (torch.rand(shape, generator=gen, device=resid.device)
                     for shape in ((na, n, ns), (n, n, ns), (n, n)))
        ref2, ref2u = cj.bp_sirt_sl(y, g, yv, ic), cj.bp_sl(y, g)
        for ab in AB_SWEEP:
            got = cj.bp_sirt_sl(y, g, yv, ic, ab=ab)
            gu = cj.bp_sl(y, g, ab=ab)
            ref = cj.bp_sirt_sl_ref(y, g, yv, ic, ab)
            refu = cj.bp_sl_ref(y, g, ab)
            e_plain = max(max_err(got, ref) / float(ref.abs().max()),
                          max_err(gu, refu) / float(refu.abs().max()))
            e_k2 = max(max_err(got, ref2) / float(ref2.abs().max()),
                       max_err(gu, ref2u) / float(ref2u.abs().max()))
            require(e_plain <= 1e-5 and e_k2 <= 1e-6,
                    f"K10 ab={ab} at {(n, na, ns)}: vs plain {e_plain:.3e} "
                    f"(<= 1e-5), vs K2 {e_k2:.3e} (<= 1e-6)")
            ragged = max(ragged, e_plain)
    ref = cj.bp_sirt_sl_ref(*args, ab=6)
    got = cj.bp_sirt_sl(*args, ab=6)
    report("K10_bp_ab", max_err(got, ref), 1e-5 * float(ref.abs().max()),
           time_ms(lambda: cj.bp_sirt_sl(*args, ab=6), 5),
           time_ms(lambda: cj.bp_sirt_sl_ref(*args, ab=6), 3),
           f" (ab=6, fused; vs K2 at ab {'/'.join(map(str, AB_SWEEP))} "
           f"fused and unfused {worst:.1e} <= 1e-6 max|out|; at the ragged "
           f"shapes vs plain {ragged:.1e} <= 1e-5 max|out|; device ms "
           f"fused/unfused {', '.join(out)} vs K2 {k2_dev:.4f}/"
           f"{k2u_dev:.4f})", work=work, library_ms=library_ms)


RAGGED_SHAPES = ((33, 7, 5), (48, 13, 37))  # (N, Na, Ns)


def projector_traffic(geom, ns: int):
    """{row: (staged bytes, shared-memory read bytes)} of K1, K2, K10 (ab
    6), E1 (FULL on K1's plan) and E2 (FULL on K2's tiles) at this
    geometry: the bytes the windows
    copy from L2 into shared memory (rows inside the operand only;
    cuda_joseph.fp_plan, bp_window_lo), and the shared-memory reads of the
    gather, two 16-byte reads per tap pair and 4 slices of every ray step
    (K1, E1) or pixel and angle (K2, K10) a block computes, padding
    included."""
    from tomojax_torch.projector import cuda_joseph as cj

    n, nt, na = geom.n, geom.nray, geom.nproj
    quads = -(-ns // 32) * 8
    w = cj.fp_plan(geom, torch.device("cpu")).windows.astype(np.int64)
    inside = np.clip(w[..., 0] + w[..., 1], 0, n) - np.clip(w[..., 0], 0, n)
    steps = np.minimum(cj.FP_STEPS, n - np.arange(0, n, cj.FP_STEPS))
    fp = (int((inside * steps).sum()) * ns * 4,
          na * -(-nt // cj.FP_BINS) * cj.FP_BINS * n * quads * 32)
    lo = cj.bp_window_lo(geom)
    inside = np.clip(lo + cj.BP_WINDOW, 0, nt) - np.clip(lo, 0, nt)
    bp = (int(inside.sum()) * ns * 4,
          na * lo.shape[1] * lo.shape[2] * cj.BP_TILE ** 2 * quads * 32)
    return {"K1_fp_resid": fp, "K1_fp": fp, "K2_bp_sirt": bp, "K2_bp": bp,
            "K10_bp_ab6": bp, "E1_FULL": fp, "E2_FULL": bp}


def _projector_calls(geom, ns: int, uni) -> dict:
    """{row: call} of the four K1/K2 wrappers, K10 at ab = 6 (fused), E1
    FULL on K1's groups (8 angles at most), E2 FULL on random operands, and
    one K8 sweep over the angles in order from zero (random b, the
    geometry's SART weights)."""
    from tomojax_torch.experiments import cuda_projector_variants as cpv
    from tomojax_torch.projector import cuda_joseph as cj
    from tomojax_torch.solvers import (
        cuda_sart, make_sart_weights, make_system,
    )

    n, na, nt = geom.n, geom.nproj, geom.nray
    x, b, ax_old = uni(n, n, ns), uni(na, nt, ns), uni(na, nt, ns)
    inv_row = uni(na, nt, lo=0.1)
    beta = torch.tensor(0.3, device=x.device)
    y_vol, inv_col = uni(n, n, ns), uni(n, n, hi=0.05)
    sysd = make_system(geom, x.device)
    sart = (torch.zeros_like(x), b, geom, sysd.inv_row,
            make_sart_weights(sysd), torch.tensor(1.0, device=x.device),
            torch.arange(na, dtype=torch.int32, device=x.device))
    return {
        "K1_fp_resid": lambda: cj.fp_resid_sl(x, geom, b, ax_old, inv_row,
                                              beta),
        "K1_fp": lambda: cj.fp_sl(x, geom),
        "K2_bp_sirt": lambda: cj.bp_sirt_sl(b, geom, y_vol, inv_col),
        "K2_bp": lambda: cj.bp_sl(b, geom),
        "K10_bp_ab6": lambda: cj.bp_sirt_sl(b, geom, y_vol, inv_col, ab=6),
        "E1_FULL": lambda: cpv.fp_variant(x, geom, "FULL", ab=8),
        "E2_FULL": lambda: cpv.bp_variant(b, geom, "FULL"),
        "K8_sweep": lambda: cuda_sart.sart_sweep_sl(*sart),
    }


def projector_times(geom, ns: int, uni, card: str, tag: str) -> dict:
    """One-call event times (median of 5), device times (mean of 5, from
    torch.profiler) and batch times (CUDA events around 10 back-to-back
    calls) of K1, K2, K10 (ab 6), E1 FULL, E2 FULL and one K8 sweep at this
    shape, printed; with the staged bytes and the rates they reach at the
    device time where this tree has the tile plan (not for K8)."""
    from tomojax_torch.experiments.timing import batch_ms
    from tomojax_torch.projector import cuda_joseph as cj

    calls = _projector_calls(geom, ns, uni)
    traffic = (projector_traffic(geom, ns) if hasattr(cj, "fp_plan")
               else None)
    out = {}
    for name, fn in calls.items():
        ms, dev_ms = time_ms(fn, 5), device_ms(fn, 5)
        batch = batch_ms(fn, 10, torch.device("cuda"))
        out[name] = (ms, dev_ms, batch)
        extra = ""
        if traffic is not None and name in traffic:
            staged, smem = traffic[name]
            extra = (f"; staged {staged / 1e9:.3f} GB at "
                     f"{staged / dev_ms / 1e9:.3f} TB/s L2 to shared, "
                     f"shared reads {smem / 1e9:.2f} GB at "
                     f"{smem / dev_ms / 1e9:.2f} TB/s")
        print(f"{tag} {name} at {ns} x {geom.n}^2 x {geom.nproj}: "
              f"{ms:.4f} ms event, {dev_ms:.4f} ms device, {batch:.4f} ms "
              f"batch{extra}; SM clock "
              f"after it, max: {sm_clock()} [{card}]")
    return out


def _check_projector_tiles(uni, card: str) -> None:
    """K1 (both epilogues) and K2 (both) against their plain versions at
    ragged shapes (N not a multiple of the tiles, Ns % 4 != 0: the scalar
    copies and stores), with phase 3's bounds; then the four rows at
    128 x 512^2 x 90, held against torch.sparse.mm with the CSR form of A
    and A^T (rel 1e-5) and timed beside it."""
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector import cuda_joseph as cj

    for n, na, ns in RAGGED_SHAPES:
        geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
        x, b, ax_old = uni(n, n, ns), uni(na, n, ns), uni(na, n, ns)
        inv_row, beta = uni(na, n, lo=0.1), torch.tensor(0.3, device=x.device)
        got = cj.fp_resid_sl(x, geom, b, ax_old, inv_row, beta)
        ref = cj.fp_resid_sl_ref(x, geom, b, ax_old, inv_row, beta)
        errs = {"K1 resid": max(
            max_err(got[0], ref[0]) / float(ref[0].abs().max()),
            max_err(got[1], ref[1]) / float(ref[1].abs().max()))}
        dd = abs(float(got[2]) - float(ref[2])) / float(ref[2])
        ax = cj.fp_sl(x, geom)
        errs["K1"] = max_err(ax, ref[0]) / float(ref[0].abs().max())
        y_vol, inv_col = uni(n, n, ns), uni(n, n, hi=0.05)
        ref = cj.bp_sirt_sl_ref(b, geom, y_vol, inv_col)
        errs["K2 fused"] = max_err(cj.bp_sirt_sl(b, geom, y_vol, inv_col),
                                   ref) / float(ref.abs().max())
        ref = cj.bp_sl_ref(b, geom)
        got = cj.bp_sl(b, geom)
        errs["K2"] = max_err(got, ref) / float(ref.abs().max())
        lhs = float(torch.sum(ax.double() * b.double()))
        rhs = float(torch.sum(x.double() * got.double()))
        adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
        torch.cuda.synchronize()
        require(all(e <= 1e-5 for e in errs.values()) and dd <= 2e-5
                and adj <= 1e-5,
                f"K1/K2 at ragged shape {(n, na, ns)}: {errs}, ddsq rel "
                f"{dd:.3e}, adjointness {adj:.3e}")
        print(f"K1/K2 at N {n}, Na {na}, Ns {ns}: " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()) + " <= 1e-5 max|out|; "
            f"ddsq rel {dd:.2e} <= 2e-5; adjointness {adj:.2e} <= 1e-5")

    n, na, ns = 512, 90, 128
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    A, At, nnz = joseph_csr(geom, torch.device("cuda"))
    x, y = uni(n, n, ns), uni(na, n, ns, lo=-1.0)
    fp_rel = max_err(cj.fp_sl(x, geom).reshape(na * n, ns),
                     torch.sparse.mm(A, x.reshape(n * n, ns)))
    bp_rel = max_err(cj.bp_sl(y, geom).reshape(n * n, ns),
                     torch.sparse.mm(At, y.reshape(na * n, ns)))
    fp_rel /= float(torch.sparse.mm(A, x.reshape(n * n, ns)).abs().max())
    bp_rel /= float(torch.sparse.mm(At, y.reshape(na * n, ns)).abs().max())
    require(fp_rel <= 1e-5 and bp_rel <= 1e-5,
            f"K1/K2 at 512^2 vs CSR: {fp_rel:.3e}, {bp_rel:.3e}")
    fp_lib = time_ms(lambda: torch.sparse.mm(A, x.reshape(n * n, ns)), 5)
    bp_lib = time_ms(lambda: torch.sparse.mm(At, y.reshape(na * n, ns)), 5)
    print(f"K1/K2 at {ns} x {n}^2 x {na} vs CSR ({nnz} nonzeros): A x rel "
          f"{fp_rel:.1e}, A^T y rel {bp_rel:.1e} <= 1e-5; torch.sparse.mm "
          f"A x {fp_lib:.4f} ms, A^T y {bp_lib:.4f} ms [{card}]")
    del A, At
    projector_times(geom, ns, uni, card, "projectors")


def _check_fgp_variants(x, p, report) -> None:
    """K11 with f32 and bf16 duals and K12 with f32 duals against their
    plain versions (bound 0.0: the same arithmetic in the same order), with
    device times beside their twins: one K11 launch against two K3
    launches, K12 + K4 against one K3."""
    from tomojax_torch.tv import cuda_fgp

    V = x.numel()
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q = tuple(v.to(dt) for v in p)
        got = _launched(cuda_fgp.fgp_iter2,
                        lambda: cuda_fgp.fgp_iter2(x, *q, LAM))
        ref = cuda_fgp.fgp_iter2_ref(x, *q, LAM)
        errs[dt] = max(max_err(g.float(), r.float())
                       for g, r in zip(got, ref))
    qb = tuple(v.to(torch.bfloat16) for v in p)
    k11 = device_ms(lambda: cuda_fgp.fgp_iter2(x, *qb, LAM))
    k3 = device_ms(lambda: cuda_fgp.fgp_iter(x, *qb, LAM))
    report("K11_fgp_iter2", max(errs.values()), 0.0,
           time_ms(lambda: cuda_fgp.fgp_iter2(x, *qb, LAM), 10),
           time_ms(lambda: cuda_fgp.fgp_iter2_ref(x, *qb, LAM), 5),
           f" (f32 duals {errs[torch.float32]:.1e}, bf16 "
           f"{errs[torch.bfloat16]:.1e}; "
           f"device ms K11 {k11:.4f} vs two K3 {2 * k3:.4f}, bf16 duals)",
           work=fgp_iter_work(V, 2, iters=2))
    d, _ = cuda_fgp.fgp_obj_mom(x, *(v.float() for v in p), LAM)
    pf = tuple(v.float() for v in p)
    got = _launched(cuda_fgp.fgp_grad, lambda: cuda_fgp.fgp_grad(d, *pf, LAM))
    ref = cuda_fgp.fgp_grad_ref(d, *pf, LAM)
    err = max(max_err(g, r) for g, r in zip(got, ref))
    k12 = device_ms(lambda: cuda_fgp.fgp_grad(d, *pf, LAM))
    k4 = device_ms(lambda: cuda_fgp.fgp_obj_mom(x, *pf, LAM))
    k3f = device_ms(lambda: cuda_fgp.fgp_iter(x, *pf, LAM))
    report("K12_fgp_grad", err, 0.0,
           time_ms(lambda: cuda_fgp.fgp_grad(d, *pf, LAM), 10),
           time_ms(lambda: cuda_fgp.fgp_grad_ref(d, *pf, LAM), 5),
           f" (f32 duals; device ms K12 {k12:.4f} + K4 {k4:.4f} = "
           f"{k12 + k4:.4f} vs one K3 {k3f:.4f}, f32 duals)",
           work=(V * (4 + 12 + 12), 19 * V))


def sart_work(geom, ns: int, nnz: int):
    """(bytes, operations) of one K8 sweep: x in and out once; b, inv_row,
    inv_col_a, order read once; per angle its FP and BP taps (a
    multiply-add each, 2 per nonzero of A and slice, each way) and a
    4-operation update of every voxel."""
    n, na = geom.n, geom.nproj
    return (4 * (2 * n * n * ns + na * geom.nray * (ns + 1) + na * n * n
                 + na + 1),
            4 * nnz * ns + 4 * na * n * n * ns)


def _sart_levels(geom, ns: int, x) -> dict:
    """K8 against its plain version at three levels, each required: one
    angle step (a column- and a row-driven angle) from random x within
    1e-5 max|x|; one sweep from zero on consistent nanocube projections
    within 1e-4 max|x|; the rmse against the phantom after 5 sweeps
    within 1e-4 of the plain version's. Also: two sweeps agree bit for bit
    and an order of out-of-range entries returns x."""
    from tomojax_torch import ops
    from tomojax_torch.projector.cuda_joseph import fp_sl
    from tomojax_torch.sim import nanocube_phantom
    from tomojax_torch.solvers import (
        cuda_sart, make_sart_weights, make_system, to_sl,
    )

    dev = x.device
    n, na = geom.n, geom.nproj
    route = cuda_sart.sart_route(n, geom.nray)
    tag = f"K8 ({route}) at {ns} x {n}^2 x {na}"
    sysd = make_system(geom, dev)
    vol = to_sl(torch.from_numpy(nanocube_phantom(ns, n)).to(dev))
    args = (fp_sl(vol, geom), geom, sysd.inv_row, make_sart_weights(sysd))
    one = torch.tensor(1.0, device=dev)
    seq = torch.arange(na, dtype=torch.int32, device=dev)
    sweep, plain = cuda_sart.sart_sweep_sl, cuda_sart.sart_sweep_sl_ref

    step_err = step_tol = 0.0
    for a in (0, na // 2):
        order = torch.tensor([a], dtype=torch.int32, device=dev)
        got = _launched(sweep, lambda: sweep(x, *args, one, order))
        ref = plain(x, *args, one, order)
        err, tol = max_err(got, ref), 1e-5 * float(ref.abs().max())
        require(err <= tol, f"{tag}, one step at angle {a}: error "
                            f"{err:.3e} above {tol:.3e}")
        step_err, step_tol = max(step_err, err), max(step_tol, tol)
    skip = torch.tensor([na, -1], dtype=torch.int32, device=dev)
    require(torch.equal(sweep(x, *args, one, skip), x),
            f"{tag}: out-of-range order entries changed x")

    x0 = torch.zeros_like(vol)
    got, ref = sweep(x0, *args, one, seq), plain(x0, *args, one, seq)
    sweep_err, sweep_tol = max_err(got, ref), 1e-4 * float(ref.abs().max())
    require(sweep_err <= sweep_tol, f"{tag}, one sweep: error "
                                    f"{sweep_err:.3e} above {sweep_tol:.3e}")
    require(torch.equal(sweep(x0, *args, one, seq), got),
            f"{tag}: two sweeps differ")
    xk = xp = x0
    for _ in range(5):
        xk, xp = sweep(xk, *args, one, seq), plain(xp, *args, one, seq)
    rk, rp = float(ops.rmse(xk, vol)), float(ops.rmse(xp, vol))
    require(abs(rk - rp) <= 1e-4,
            f"{tag}: rmse after 5 sweeps kernel {rk:.6f}, plain "
            f"{rp:.6f}")
    return {"route": route, "tag": tag, "args": args, "x0": x0, "seq": seq,
            "one": one, "sweep_err": sweep_err, "sweep_tol": sweep_tol,
            "text": (f"one {na}-angle sweep from zero on nanocube "
                     f"projections {sweep_err:.2e} <= {sweep_tol:.2e} (1e-4 "
                     f"max|x|); one angle step {step_err:.2e} <= "
                     f"{step_tol:.2e} (1e-5 max|x|); rmse vs phantom after "
                     f"5 sweeps kernel {rk:.6f}, plain {rp:.6f}, |d| "
                     f"{abs(rk - rp):.2e} <= 1e-4; two sweeps identical; "
                     f"out-of-range entries leave x")}


def _sart_route_line(geom, ns: int, lv: dict, nnz: int, card: str) -> None:
    """Print a K8 route's launch (clusters, waves, shared memory a block)
    and its ms a sweep over a batch of sweeps (CUDA events: torch.profiler
    under-reported the cluster kernel in some windows) beside the bound
    (resident: also the phase cycles of the kernel's timed
    instantiation)."""
    from tomojax_torch.experiments.timing import batch_ms
    from tomojax_torch.solvers import cuda_sart

    sweep_ms = batch_ms(lambda: cuda_sart.sart_sweep_sl(
        lv["x0"], *lv["args"], lv["one"], lv["seq"]), 10, lv["x0"].device)
    launch = "two launches a step"
    if lv["route"] == "resident":
        c = cuda_sart.resident_clusters(geom.n, geom.nray, ns)
        launch = (f"{c['clusters']} clusters of {cuda_sart.BAND_BLOCKS} "
                  f"blocks, {c['active']} at once "
                  f"(cudaOccupancyMaxActiveClusters), {c['waves']} waves, "
                  f"{c['smem']} B shared memory a block")
    bound_ms, bound_by = bound(*sart_work(geom, ns, nnz))
    print(f"{lv['tag']}: {lv['text']}; {launch}; {sweep_ms:.4f} ms/sweep "
          f"over 10 back-to-back sweeps (CUDA events; SM clock after it, "
          f"max: {sm_clock()}), bound "
          f"{bound_ms:.4f} ms ({bound_by}) [{card}]")
    if lv["route"] == "resident":
        phases = cuda_sart.resident_phases(lv["x0"], *lv["args"], lv["one"],
                                           lv["seq"])
        print(f"  phases (the timed instantiation: clock64 cycles a step, "
              f"mean over blocks; SM clock after it, max: {sm_clock()}): "
              + "; ".join(
                  f"{kind} ({v['steps']} steps) " + ", ".join(
                      f"{name} {v[name]:.0f}" for name in cuda_sart.PHASES)
                  for kind, v in phases.items()))


def _check_sart(geom, ns: int, uni, report, nnz: int, card: str) -> None:
    """K8 on both routes at _sart_levels' three levels: resident at this
    shape (the row's numbers) and at N 33, Na 7, Ns 5 (a ragged slab, the
    last band empty), streaming at 128 x 512^2 x 90; each with its launch
    and ms a sweep beside its bound."""
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.solvers import cuda_sart

    n = geom.n
    lv = _sart_levels(geom, ns, uni(n, n, ns))
    require(lv["route"] == "resident", f"K8 at {n}^2: route {lv['route']}")
    _sart_route_line(geom, ns, lv, nnz, card)
    sweep, plain = cuda_sart.sart_sweep_sl, cuda_sart.sart_sweep_sl_ref
    args = (lv["x0"], *lv["args"], lv["one"], lv["seq"])
    report("K8_sart_sweep", lv["sweep_err"], lv["sweep_tol"],
           time_ms(lambda: sweep(*args), 5), time_ms(lambda: plain(*args), 2),
           f" (resident route; {lv['text']})", work=sart_work(geom, ns, nnz))
    for n2, na2, ns2, want in ((33, 7, 5, "resident"),
                               (512, 90, 128, "streaming")):
        g2 = Geometry.make(n2, np.deg2rad(np.linspace(-76, 76, na2)))
        lv2 = _sart_levels(g2, ns2, uni(n2, n2, ns2))
        require(lv2["route"] == want, f"K8 at {n2}^2: route {lv2['route']}")
        _sart_route_line(g2, ns2, lv2, joseph_nnz(g2), card)


SLABS = 4  # phase 3's emulated ranks: 256^3 as 4 slabs of 64 slices


def _slabs(x: torch.Tensor):
    n = x.shape[2] // SLABS
    return [x[:, :, i * n:(i + 1) * n].contiguous() for i in range(SLABS)]


def _first(t):
    return t[:, :, 0].contiguous()


def _last(t):
    return t[:, :, -1].contiguous()


def _check_halo_kernels(x: torch.Tensor, uni, report, card: str) -> None:
    """K9a/K9b/K9c and K5's right halo against their plain versions: on one
    64-slice slab with random halo planes, once per rank role: bottom (zero
    P3 plane below), interior, top (no right halo on the FGP chain), K9c's
    ring giving every role both planes; then on the whole 256^3 volume as
    the one rank of phase 4c's group, where they are timed."""
    from tomojax_torch.tv import cuda_fgp, cuda_tv_value, cuda_tvgd
    from tomojax_torch.tv import cuda_fgp_sharded as fs
    from tomojax_torch.tv import cuda_tvgd_sharded as gs

    dev = x.device
    slab = _slabs(x)[1]
    plane_shape = slab.shape[:2]
    p = tuple((uni(*slab.shape) - 0.5).to(torch.bfloat16) for _ in range(3))
    x_old, beta = uni(*slab.shape), torch.tensor(0.3, device=dev)
    roles = {}
    for role in ("bottom", "interior", "top"):
        lo = (torch.zeros(plane_shape, dtype=torch.bfloat16, device=dev)
              if role == "bottom" else (uni(*plane_shape) - 0.5).bfloat16())
        hi = None if role == "top" else (
            uni(*plane_shape), *((uni(*plane_shape) - 0.5).bfloat16()
                                 for _ in range(3)))
        got = _launched(fs.fgp_iter_halo,
                        lambda: fs.fgp_iter_halo(slab, *p, LAM, lo, hi))
        ref = fs.fgp_iter_halo_ref(slab, *p, LAM, lo, hi)
        e_a = max(max_err(g.float(), r.float()) for g, r in zip(got, ref))
        got = _launched(fs.fgp_obj_halo, lambda: fs.fgp_obj_halo(
            slab, *p, LAM, lo, x_old, beta))
        ref = fs.fgp_obj_halo_ref(slab, *p, LAM, lo, x_old, beta)
        e_b = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
        t_b = 1e-6 * float(ref[1].abs().max())
        lo_x, hi_x = uni(*plane_shape), uni(*plane_shape)
        g, gsq = _launched(gs.tv_grad_halo,
                           lambda: gs.tv_grad_halo(slab, lo_x, hi_x))
        g_r, gsq_r = gs.tv_grad_halo_ref(slab, lo_x, hi_x)
        e_c, t_c = max_err(g, g_r), 1e-5 * float(g_r.abs().max())
        gsq_rel = abs(float(gsq) - float(gsq_r)) / float(gsq_r)
        tv_rel = abs(float(cuda_tv_value.tv_value(slab, hi_x))
                     - float(cuda_tv_value.tv_value_ref(slab, hi_x))) \
            / float(cuda_tv_value.tv_value_ref(slab, hi_x))
        require(e_a <= 2 ** -7 and e_b <= t_b and e_c <= t_c
                and gsq_rel <= 2e-5 and tv_rel <= 2e-5,
                f"{role} slab: K9a {e_a:.3e} (<= 2^-7), K9b {e_b:.3e} "
                f"(<= {t_b:.3e}), K9c {e_c:.3e} (<= {t_c:.3e}), ||g||^2 rel "
                f"{gsq_rel:.3e} (<= 2e-5), K5 halo rel {tv_rel:.3e} (<= 2e-5)")
        roles[role] = (e_a, e_b, t_b, e_c, t_c, gsq_rel, tv_rel)
    print("K9 per role (bottom, interior, top) on a 256x256x64 slab: "
          + "; ".join(f"{r}: K9a {v[0]:.2e}, K9b {v[1]:.2e}, K9c {v[3]:.2e}, "
                      f"||g||^2 rel {v[5]:.2e}, K5 halo rel {v[6]:.2e}"
                      for r, v in roles.items()))
    # The world-size-1 role at 256^3, the shape and halos that the sharded
    # main path (phase 4c) gives the kernels: the top of a chain of one (a
    # zero P3 plane below, no right halo) and a ring whose halos are the
    # volume's own last and first slices. The rows report this error beside
    # the 256^3 times; device times of each K9 kernel and its unsharded
    # twin follow, on the whole volume and on the 64-slice slab.
    p_all = tuple((uni(*x.shape) - 0.5).to(torch.bfloat16) for _ in range(3))
    zero = torch.zeros(x.shape[:2], dtype=torch.bfloat16, device=dev)
    x_old_all = uni(*x.shape)
    lo_x, hi_x = _last(x), _first(x)
    got = _launched(fs.fgp_iter_halo,
                    lambda: fs.fgp_iter_halo(x, *p_all, LAM, zero))
    ref = fs.fgp_iter_halo_ref(x, *p_all, LAM, zero)
    s_a = max(max_err(g.float(), r.float()) for g, r in zip(got, ref))
    got = _launched(fs.fgp_obj_halo, lambda: fs.fgp_obj_halo(
        x, *p_all, LAM, zero, x_old_all, beta))
    ref = fs.fgp_obj_halo_ref(x, *p_all, LAM, zero, x_old_all, beta)
    s_b = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
    s_tb = 1e-6 * float(ref[1].abs().max())
    g, gsq = _launched(gs.tv_grad_halo, lambda: gs.tv_grad_halo(x, lo_x, hi_x))
    g_r, gsq_r = gs.tv_grad_halo_ref(x, lo_x, hi_x)
    s_c, s_tc = max_err(g, g_r), 1e-5 * float(g_r.abs().max())
    s_gsq = abs(float(gsq) - float(gsq_r)) / float(gsq_r)
    tv_r = float(cuda_tv_value.tv_value_ref(x, hi_x))
    s_tv = abs(float(cuda_tv_value.tv_value(x, hi_x)) - tv_r) / tv_r
    require(s_gsq <= 2e-5 and s_tv <= 2e-5,
            f"world size 1 at 256^3: ||g||^2 rel {s_gsq:.3e} (<= 2e-5), K5 "
            f"halo rel {s_tv:.3e} (<= 2e-5)")
    worst = [max(v[i] for v in roles.values()) for i in (0, 1, 3)]
    V, P = x.numel(), x.shape[0] * x.shape[1]
    report("K9a_fgp_iter_halo", s_a, 2 ** -7,
           time_ms(lambda: fs.fgp_iter_halo(x, *p_all, LAM, zero), 10),
           time_ms(lambda: fs.fgp_iter_halo_ref(x, *p_all, LAM, zero), 5),
           f" (256^3, world size 1, bf16 duals; worst of the 3 slab roles "
           f"{worst[0]:.2e})",
           work=(fgp_iter_work(V, 2)[0] + 2 * P, fgp_iter_work(V, 2)[1]))
    report("K9b_fgp_obj_halo", s_b, s_tb,
           time_ms(lambda: fs.fgp_obj_halo(x, *p_all, LAM, zero, x_old_all,
                                           beta), 10),
           time_ms(lambda: fs.fgp_obj_halo_ref(x, *p_all, LAM, zero,
                                               x_old_all, beta), 5),
           f" (256^3, world size 1, bf16 duals, Nesterov epilogue, bound "
           f"1e-6 max|y|; worst of the 3 slab roles {worst[1]:.2e})",
           work=(V * (4 + 3 * 2 + 4 + 4 + 4) + 2 * P + 4, 11 * V))
    report("K9c_tv_grad_halo", s_c, s_tc,
           time_ms(lambda: gs.tv_grad_halo(x, lo_x, hi_x), 10),
           time_ms(lambda: gs.tv_grad_halo_ref(x, lo_x, hi_x), 5),
           f" (256^3, world size 1, bound 1e-5 max|g|; ||g||^2 rel "
           f"{s_gsq:.2e} <= 2e-5; K5 with its own first slice as right "
           f"halo rel {s_tv:.2e} <= 2e-5; worst of the 3 slab roles "
           f"{worst[2]:.2e})", work=(8 * V + 8 * P + 4, 27 * V))
    lo = (uni(*plane_shape) - 0.5).bfloat16()
    hi = (uni(*plane_shape), *((uni(*plane_shape) - 0.5).bfloat16()
                               for _ in range(3)))
    pairs = {
        "K9a top/K3": (lambda v, q: fs.fgp_iter_halo(v, *q, LAM, zero),
                       lambda v, q: cuda_fgp.fgp_iter(v, *q, LAM)),
        "K9a interior/K3": (lambda v, q: fs.fgp_iter_halo(v, *q, LAM, lo,
                                                          hi),
                            lambda v, q: cuda_fgp.fgp_iter(v, *q, LAM)),
        "K9b/K4": (lambda v, q: fs.fgp_obj_halo(v, *q, LAM, lo),
                   lambda v, q: cuda_fgp.fgp_obj_mom(v, *q, LAM)),
        "K9c/K7": (lambda v, q: gs.tv_grad_halo(v, lo_x, hi_x),
                   lambda v, q: cuda_tvgd.tv_grad(v)),
    }
    out = []
    for shape, v, q in (("256^3", x, p_all), ("256x256x64", slab, p)):
        out.append(f"{shape}: " + ", ".join(
            f"{k} {device_ms(lambda: a(v, q)):.4f}/"
            f"{device_ms(lambda: b(v, q)):.4f}" for k, (a, b) in pairs.items()))
    print("K9 device ms (torch.profiler, kernel/twin) " + "; ".join(out)
          + f" [{card}]")


def _check_slab_chains(x: torch.Tensor, x_old: torch.Tensor, beta) -> None:
    """4 emulated slabs in one process, halo planes sliced from the
    neighbouring slabs: 10 FGP iterations (K9a x 9, K9b) with f32 and bf16
    duals against K3/K4 on the whole volume, bound 0.0 (shared bodies);
    10 TV-GD gradients (K9c) at the whole-volume descent's iterates against
    K7, bound 0.0, and the slab descent (the slabs' ||g||^2 summed) against
    the whole-volume one, bound 1e-6 max|x| (the norm is summed in another
    order)."""
    from tomojax_torch.tv import cuda_fgp_sharded as fs
    from tomojax_torch.tv import cuda_tvgd_sharded as gs
    from tomojax_torch.tv.cuda_fgp import tv_fgp_fused
    from tomojax_torch.tv.cuda_tvgd import tv_grad

    xs, olds = _slabs(x), _slabs(x_old)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        zero = torch.zeros(x.shape[:2], dtype=dt, device=x.device)
        p = [tuple(torch.zeros_like(s, dtype=dt) for _ in range(3))
             for s in xs]
        for _ in range(N_TV - 1):
            p = [fs.fgp_iter_halo(
                xs[i], *p[i], LAM, _last(p[i - 1][2]) if i else zero,
                None if i == SLABS - 1 else (
                    _first(xs[i + 1]), *(_first(q) for q in p[i + 1])))
                 for i in range(SLABS)]
        out = [fs.fgp_obj_halo(xs[i], *p[i], LAM,
                               _last(p[i - 1][2]) if i else zero, olds[i],
                               beta) for i in range(SLABS)]
        d, y = tv_fgp_fused(x, N_TV, LAM, dual_dtype=dt, mom=(x_old, beta))
        errs[dt] = max(max_err(torch.cat([o[0] for o in out], 2), d),
                       max_err(torch.cat([o[1] for o in out], 2), y))
    require(max(errs.values()) == 0.0,
            f"4-slab FGP chain vs K3/K4: f32 {errs[torch.float32]:.3e}, "
            f"bf16 {errs[torch.bfloat16]:.3e} (bound 0.0)")

    def halos(parts, i):
        return _last(parts[i - 1]), _first(parts[(i + 1) % SLABS])

    dpocs = 0.02 * float(x.abs().max())
    xw, xc = x, xs
    g_err = gsq_rel = 0.0
    for _ in range(N_TV):
        g, gsq = tv_grad(xw)
        parts = _slabs(xw)
        at_w = [gs.tv_grad_halo(parts[i], *halos(parts, i))
                for i in range(SLABS)]
        g_err = max(g_err, max_err(torch.cat([o[0] for o in at_w], 2), g))
        gsq_rel = max(gsq_rel, abs(float(sum(o[1] for o in at_w))
                                   - float(gsq)) / float(gsq))
        xw = xw - dpocs * g / torch.sqrt(gsq)
        own = [gs.tv_grad_halo(xc[i], *halos(xc, i)) for i in range(SLABS)]
        total = sum(o[1] for o in own)
        xc = [s - dpocs * o[0] / torch.sqrt(total) for s, o in zip(xc, own)]
    x_err = max_err(torch.cat(xc, 2), xw)
    x_tol = 1e-6 * float(x.abs().max())
    require(g_err == 0.0 and x_err <= x_tol,
            f"4-slab TV-GD vs K7: g {g_err:.3e} (bound 0.0), x after "
            f"{N_TV} steps {x_err:.3e} (bound {x_tol:.3e})")
    print(f"4-slab chains at 256^3: FGP ({N_TV} iterations, Nesterov "
          f"epilogue) vs K3/K4 f32 duals {errs[torch.float32]:.1e}, bf16 "
          f"{errs[torch.bfloat16]:.1e} (bound 0.0); TV-GD ({N_TV} gradients) "
          f"g vs K7 {g_err:.1e} (bound 0.0), ||g||^2 summed over slabs rel "
          f"{gsq_rel:.2e}, x after {N_TV} steps {x_err:.3e} <= {x_tol:.3e} "
          f"(1e-6 max|x|)")


# ------------------------------------------------------------------ phase 4


@contextlib.contextmanager
def plain_versions_forbidden():
    """Make every plain version raise while the main path runs: on CUDA
    tensors the wrappers must launch their kernels."""
    from tomojax_torch.experiments import (
        cuda_projector_variants, cuda_sart_variants,
    )
    from tomojax_torch.projector import cuda_joseph
    from tomojax_torch.solvers import cuda_sart
    from tomojax_torch.tv import (
        cuda_fgp, cuda_fgp_sharded, cuda_tv_value, cuda_tvgd,
        cuda_tvgd_sharded,
    )

    names = {cuda_projector_variants: ["fp_variant_ref", "bp_variant_ref"],
             cuda_sart_variants: ["sart_variant_ref"],
             cuda_joseph: ["fp_sl_ref", "fp_resid_sl_ref", "bp_sl_ref",
                           "bp_sirt_sl_ref"],
             cuda_fgp: ["fgp_iter_ref", "fgp_iter2_ref", "fgp_grad_ref",
                        "fgp_obj_mom_ref"],
             cuda_fgp_sharded: ["fgp_iter_halo_ref", "fgp_obj_halo_ref"],
             cuda_tv_value: ["tv_value_ref"],
             cuda_tvgd: ["tv_grad_ref", "tv_step_ref"],
             cuda_tvgd_sharded: ["tv_grad_halo_ref"],
             cuda_sart: ["sart_sweep_sl_ref"]}
    saved = {(m, k): getattr(m, k) for m, ks in names.items() for k in ks}

    def forbidden(name):
        def raise_(*_a, **_k):
            raise PhaseFailed(f"plain version {name} ran on the main path")
        return raise_

    for (m, k) in saved:
        setattr(m, k, forbidden(k))
    try:
        yield
    finally:
        for (m, k), fn in saved.items():
            setattr(m, k, fn)


FISTA_KERNELS = ("K1_fp_resid", "K1_fp", "K2_bp_sirt", "K2_bp", "K3_fgp_iter",
                 "K4_fgp_obj_mom", "K5_tv_value")
ASD_KERNELS = ("K1_fp_resid", "K1_fp", "K2_bp", "K5_tv_value", "K7_tv_grad",
               "K8_sart_sweep", "tv_step")
SHARDED_KERNELS = ("K1_fp_resid", "K1_fp", "K2_bp_sirt", "K2_bp",
                   "K5_tv_value", "K8_sart_sweep", "K9a_fgp_iter_halo",
                   "K9b_fgp_obj_halo", "K9c_tv_grad_halo", "tv_step")
FUSION_KERNELS = ("K1_fp", "K2_bp_sirt", "K2_bp", "K3_fgp_iter",
                  "K4_fgp_obj_mom", "K5_tv_value")
VARIANT_KERNELS = ("K10_bp_ab", "K11_fgp_iter2", "K12_fgp_grad")


def _reset(kernels: dict) -> None:
    for wrapper, _, _ in kernels.values():
        wrapper.launches = 0


def _read(kernels: dict, path: str, required) -> dict:
    counts = {name: w.launches for name, (w, _, _) in kernels.items()}
    print(f"{path} launches: {json.dumps(counts)}")
    for name in required:
        require(counts[name] > 0, f"{name} was not launched on the {path}")
    return counts


def phase_main_path(card: str, kernels: dict) -> dict:
    from tomojax_torch import TomoTorch, ops
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.sim import create_projections, nanocube_phantom
    from tomojax_torch.solvers import fista_init_sl, fista_run_sl, from_sl

    ns, n, na, iters = 256, 256, 90, 10
    angles = np.linspace(-76, 76, na)
    dev = torch.device("cuda")
    _reset(kernels)
    with plain_versions_forbidden():
        vol = torch.from_numpy(nanocube_phantom(ns, n)).to(dev)
        b = create_projections(vol, Geometry.make(n, np.deg2rad(angles)))
        tomo = TomoTorch(angles, b.permute(0, 2, 1).cpu().numpy(),
                         device="cuda")
        tomo.fista(Niter=1, lambda_param=LAM, nTViter=N_TV)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tomo.fista(Niter=iters, lambda_param=LAM, nTViter=N_TV)
        torch.cuda.synchronize()
        api_s = time.perf_counter() - t0
        recon = tomo.get_recon()
        st = fista_init_sl(torch.zeros((ns, n, n), device=dev), tomo.sys,
                           tomo.b_sl)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st, metrics = fista_run_sl(st, tomo.b_sl, tomo.sys, LAM, iters, N_TV)
        end.record()
        end.synchronize()
        run_ms = start.elapsed_time(end)
        rmse = float(ops.rmse(from_sl(st.x), vol))
        prof = _profiled(lambda: fista_run_sl(st, tomo.b_sl, tomo.sys, LAM, 2,
                                              N_TV))
    counts = _read(kernels, "FISTA-TV path", FISTA_KERNELS)
    cost = tomo.cost
    m = metrics.cpu().numpy()
    require(recon.shape == (ns, n, n) and bool(np.isfinite(recon).all()),
            "TomoTorch reconstruction is not finite (256^3)")
    require(bool(np.isfinite(cost).all()) and cost[-1] < cost[0],
            f"TomoTorch cost does not fall: {cost}")
    require(bool(np.isfinite(m).all()) and m[-1, 1] < m[0, 1],
            f"fista_run_sl dd does not fall: {m[:, 1]}")
    ms_iter = run_ms / iters
    rate = ns * n * n * iters / (run_ms / 1e3)
    print(f"main path {ns}x{n}^2x{na}, lam {LAM}, {N_TV} FGP iterations: "
          f"TomoTorch.fista({iters}) {api_s * 1e3:.1f} ms wall incl. setup "
          f"FP and metric readback; fista_run_sl {ms_iter:.3f} ms/iter = "
          f"{rate / 1e6:.1f}M voxel-iters/s [{card}]")
    print(f"  dd {m[0, 1]:.1f} -> {m[-1, 1]:.1f}, cost {cost[0]:.4g} -> "
          f"{cost[-1]:.4g}, rmse vs phantom {rmse:.6f}")
    print("  profile (2 iterations): " + _profile_summary(prof, 2))
    return counts


def phase_asd_path(card: str, kernels: dict) -> dict:
    from tomojax_torch import TomoTorch, ops
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.sim import create_projections, nanocube_phantom
    from tomojax_torch.solvers import (
        AsdPocsParams, asd_pocs_run, make_sart_weights, sart_sweep_sl,
    )
    from tomojax_torch.experiments.timing import batch_ms
    from tomojax_torch.solvers.cuda_sart import sart_route

    ns, n, na, iters = 256, 256, 90, 5
    angles = np.linspace(-76, 76, na)
    dev = torch.device("cuda")
    _reset(kernels)
    with plain_versions_forbidden():
        vol = torch.from_numpy(nanocube_phantom(ns, n)).to(dev)
        b = create_projections(vol, Geometry.make(n, np.deg2rad(angles)))
        tomo = TomoTorch(angles, b.permute(0, 2, 1).cpu().numpy(),
                         device="cuda")
        tomo.asd_pocs(Niter=1)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tomo.asd_pocs(Niter=iters)
        torch.cuda.synchronize()
        api_s = time.perf_counter() - t0
        dd_vec, tv_vec = tomo.dd_vec.copy(), tomo.tv_vec.copy()
        recon = tomo.get_recon()
        rmse = float(ops.rmse(tomo.x, vol))
        tomo.sart(Niter=2)
        sart_cost = tomo.cost.copy()
        w = make_sart_weights(tomo.sys)
        x0 = torch.zeros((n, n, ns), device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, run_dd, run_tv = asd_pocs_run(x0, tomo.b_sl, tomo.sys, w,
                                         AsdPocsParams(niter=iters))
        end.record()
        end.synchronize()
        run_ms = start.elapsed_time(end)
        prof = _profiled(lambda: asd_pocs_run(x0, tomo.b_sl, tomo.sys, w,
                                              AsdPocsParams(niter=2)))
        beta = torch.tensor(1.0, device=dev)
        seq = torch.arange(na, dtype=torch.int32, device=dev)

        def one_sweep():
            return sart_sweep_sl(x0, tomo.b_sl, tomo.geom, tomo.sys.inv_row,
                                 w, beta, seq)

        sweep_ms, sweep_batch = time_ms(one_sweep, 5), batch_ms(one_sweep,
                                                                10, dev)
    counts = _read(kernels, "ASD-POCS path", ASD_KERNELS)
    require(counts["tv_step"] == counts["K7_tv_grad"],
            f"ASD-POCS path: {counts['tv_step']} TV steps for "
            f"{counts['K7_tv_grad']} gradients")
    run_dd, run_tv = run_dd.cpu().numpy(), run_tv.cpu().numpy()
    require(recon.shape == (ns, n, n) and bool(np.isfinite(recon).all()),
            "TomoTorch.asd_pocs reconstruction is not finite (256^3)")
    require(bool(np.isfinite(dd_vec).all()) and dd_vec[-1] < dd_vec[0],
            f"TomoTorch.asd_pocs dd does not fall: {dd_vec}")
    require(bool((tv_vec > 0).all()), f"TomoTorch.asd_pocs tv: {tv_vec}")
    require(bool(np.isfinite(sart_cost).all()) and sart_cost[-1] < sart_cost[0],
            f"TomoTorch.sart dd does not fall: {sart_cost}")
    require(bool(np.isfinite(run_dd).all()) and run_dd[-1] < run_dd[0]
            and bool((run_tv > 0).all()),
            f"asd_pocs_run dd does not fall: {run_dd}")
    ms_iter = run_ms / iters
    print(f"ASD-POCS path {ns}x{n}^2x{na}, ng 10, defaults: "
          f"TomoTorch.asd_pocs({iters}) {api_s * 1e3:.1f} ms wall incl. "
          f"one host read per iteration; asd_pocs_run {ms_iter:.3f} "
          f"ms/iter = {ns * n * n / (ms_iter / 1e3) / 1e6:.1f}M "
          f"voxel-iters/s; sart_sweep_sl ({sart_route(n, n)} route) "
          f"{sweep_ms:.3f} ms/sweep = "
          f"{ns * n * n / (sweep_ms / 1e3) / 1e6:.1f}M voxel-iters/s, "
          f"{sweep_batch:.4f} ms/sweep over 10 back-to-back sweeps [{card}]")
    print(f"  dd {dd_vec[0]:.1f} -> {dd_vec[-1]:.1f}, tv {tv_vec[0]:.1f} -> "
          f"{tv_vec[-1]:.1f}, rmse vs phantom {rmse:.6f}; sart dd "
          f"{sart_cost[0]:.1f} -> {sart_cost[-1]:.1f}")
    print("  profile (2 iterations of asd_pocs_run): "
          + _profile_summary(prof, 2))
    return counts


def _events_ms(fn):
    """fn's result and its time on the card (CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_sharded_path(card: str, kernels: dict) -> dict:
    """The slab-sharded path through an NCCL group of world size 1: one
    slab holds the whole volume, the ring halos are local copies, the chain
    ends are zeros and every scalar goes through an NCCL all-reduce."""
    import torch.distributed as dist

    from tomojax_torch import TomoTorch
    from tomojax_torch.dist import init_distributed
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.sim import create_projections, nanocube_phantom
    from tomojax_torch.solvers import (
        AsdPocsParams, asd_pocs_run, fista_init_sl, fista_run_sl,
        make_sart_weights,
    )

    require(dist.is_available() and dist.is_nccl_available(),
            "torch.distributed has no NCCL backend")
    ns, n, na, iters, asd_iters = 256, 256, 90, 10, 5
    angles = np.linspace(-76, 76, na)
    dev = torch.device("cuda")
    store = ROOT / "build" / f"chip_smoke_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    group = init_distributed(f"file://{store}", 1, 0, device="cuda")
    try:
        vol = torch.from_numpy(nanocube_phantom(ns, n)).to(dev)
        b = create_projections(vol, Geometry.make(n, np.deg2rad(angles)))
        series = b.permute(0, 2, 1).cpu().numpy()
        zeros = torch.zeros((ns, n, n), device=dev)
        _reset(kernels)
        with plain_versions_forbidden():
            tomo = TomoTorch(angles, series, group=group)
            tomo.fista(Niter=1, lambda_param=LAM, nTViter=N_TV)  # warm-up
            tomo.fista(Niter=iters, lambda_param=LAM, nTViter=N_TV)
            sh_cost = tomo.cost.copy()
            recon = tomo.get_recon()
            st = fista_init_sl(zeros, tomo.sys, tomo.b_sl)
            (_, sh_m), sh_fista_ms = _events_ms(lambda: fista_run_sl(
                st, tomo.b_sl, tomo.sys, LAM, iters, N_TV, group=group))
            tomo.asd_pocs(Niter=1)  # warm-up
            tomo.asd_pocs(Niter=asd_iters)
            sh_dd, sh_tv = tomo.dd_vec.copy(), tomo.tv_vec.copy()
            w = make_sart_weights(tomo.sys)
            x0 = torch.zeros((n, n, ns), device=dev)
            params = AsdPocsParams(niter=asd_iters)
            (_, sh_run_dd, _), sh_asd_ms = _events_ms(lambda: asd_pocs_run(
                x0, tomo.b_sl, tomo.sys, w, params, group=group))
        counts = _read(kernels, "sharded path (NCCL, world size 1)",
                       SHARDED_KERNELS)
        require(counts["tv_step"] == counts["K9c_tv_grad_halo"],
                f"sharded path: {counts['tv_step']} TV steps for "
                f"{counts['K9c_tv_grad_halo']} gradients")
        # the unsharded path on the same problem, then both in turn
        # (unsharded, sharded, sharded, unsharded) for the times
        with plain_versions_forbidden():
            ref = TomoTorch(angles, series, device="cuda")
            ref.fista(Niter=iters, lambda_param=LAM, nTViter=N_TV)
            un_cost = ref.cost.copy()
            ref.asd_pocs(Niter=asd_iters)
            times = {"fista": {True: [sh_fista_ms], False: []},
                     "asd": {True: [sh_asd_ms], False: []}}
            for sharded in (False, True, False):
                g = group if sharded else None
                (_, m), ms = _events_ms(lambda: fista_run_sl(
                    st, ref.b_sl, ref.sys, LAM, iters, N_TV, group=g))
                times["fista"][sharded].append(ms)
                if not sharded:
                    un_m = m
                (_, dd, _), ms = _events_ms(lambda: asd_pocs_run(
                    x0, ref.b_sl, ref.sys, w, params, group=g))
                times["asd"][sharded].append(ms)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    sh_m, un_m = sh_m.cpu().numpy(), un_m.cpu().numpy()

    def rel(a, b_):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b_))
                            / np.abs(np.asarray(b_))))

    dev_dd, dev_tv = rel(sh_m[:, 1], un_m[:, 1]), rel(sh_m[:, 2], un_m[:, 2])
    dev_cost, dev_asd = rel(sh_cost, un_cost), rel(sh_dd, ref.dd_vec)
    require(recon.shape == (ns, n, n) and bool(np.isfinite(recon).all()),
            "sharded TomoTorch.fista reconstruction is not finite")
    require(bool(np.isfinite(sh_run_dd.cpu().numpy()).all())
            and bool((sh_tv > 0).all()), "sharded ASD-POCS is not finite")
    require(dev_dd <= 1e-5 and dev_tv <= 1e-5 and dev_cost <= 1e-5,
            f"sharded FISTA trace vs unsharded: dd {dev_dd:.3e}, tv "
            f"{dev_tv:.3e}, cost {dev_cost:.3e} (rtol 1e-5)")
    require(dev_asd <= 1e-3, f"sharded ASD-POCS dd vs unsharded: "
                             f"{dev_asd:.3e} (rtol 1e-3)")
    f_sh = statistics.median(times["fista"][True]) / iters
    f_un = statistics.median(times["fista"][False]) / iters
    a_sh = statistics.median(times["asd"][True]) / asd_iters
    a_un = statistics.median(times["asd"][False]) / asd_iters
    print(f"sharded path {ns}x{n}^2x{na}, NCCL group of world size 1: "
          f"FISTA trace vs unsharded max rel dd {dev_dd:.2e}, tv "
          f"{dev_tv:.2e}, cost {dev_cost:.2e} (rtol 1e-5); ASD-POCS dd "
          f"{dev_asd:.2e} (rtol 1e-3)")
    print(f"  fista_run_sl ms/iter: sharded {f_sh:.3f}, unsharded "
          f"{f_un:.3f} (+{100 * (f_sh / f_un - 1):.2f} %); asd_pocs_run "
          f"ms/iter: sharded {a_sh:.3f}, unsharded {a_un:.3f} "
          f"(+{100 * (a_sh / a_un - 1):.2f} %); median of 2 runs each, "
          f"in turn [{card}]")
    return counts


FUSION_ELEMENTS = ("c", "o", "zn")


def _fusion_problem(dev, nel=3, ns=128, n=256, nah=90, nac=45,
                    elements=FUSION_ELEMENTS, span=76.0):
    """Simulated problem: nanocube phantoms (element e from seed e + 1),
    the HAADF series of their sigma-weighted model (gamma 1.6, sigma
    method 3) at nah angles and the chemistry series at nac angles, both
    over +-span deg, projected on the card. Returns gt (Nel, Ns, N, N),
    the (Nslice, Nray, Nangles) series and the angles in degrees."""
    from tomojax_torch.fusion import (
        fp4d, make_fusion_system, model_haadf, weights_for_elements,
    )
    from tomojax_torch.projector.cuda_joseph import fp_sl
    from tomojax_torch.sim import nanocube_phantom
    from tomojax_torch.solvers import from_sl, to_sl

    ha, ca = np.linspace(-span, span, nah), np.linspace(-span, span, nac)
    gt = torch.stack([torch.from_numpy(nanocube_phantom(ns, n, seed=e + 1))
                      for e in range(nel)]).to(dev)
    fs = make_fusion_system(
        n, np.deg2rad(ha), np.deg2rad(ca),
        weights_for_elements(elements[:nel], 1.6, 3), 1.6, dev)
    x = to_sl(gt)
    haadf = from_sl(fp_sl(model_haadf(x, fs), fs.haadf.geom)).permute(0, 2, 1)
    chem = from_sl(fp4d(x, fs.chem)).permute(0, 1, 3, 2)
    return (gt, haadf.cpu().numpy(),
            {el: c.cpu().numpy() for el, c in zip(elements, chem)},
            ha, ca)


def _delta(kernels, before):
    return {k: w.launches - before[k] for k, (w, _, _) in kernels.items()}


def phase_fusion_path(card: str, kernels: dict) -> dict:
    """ChemicalTomo on the simulated 3 x 128 x 256^2 problem (HAADF 90,
    chemistry 45 angles): chemical_tomography, the data_fusion host loop,
    data_fusion(fused=True) and method='sart'; then the outer iteration as
    bench.py times it, with CUDA events and a torch.profiler breakdown."""
    from tomojax_torch import ChemicalTomo

    dev = torch.device("cuda")
    gt, haadf, chem, ha, ca = _fusion_problem(dev)
    nel, ns, n = gt.shape[0], gt.shape[1], gt.shape[2]
    _reset(kernels)
    runs = {}
    with plain_versions_forbidden():
        tomo = ChemicalTomo(haadf, ha, chem, ca)
        for name, kw in (("host loop", {}), ("fused", {"fused": True}),
                         ("sart", {"method": "sart"})):
            tomo.chemical_tomography(Niter=3)
            before = {k: w.launches for k, (w, _, _) in kernels.items()}
            tomo.data_fusion(Niter=3, **kw)
            torch.cuda.synchronize()
            runs[name] = (_delta(kernels, before),
                          np.stack([tomo.costHAADF, tomo.costCHEM,
                                    tomo.costTV]))
        recon = tomo.get_recon()
        rmse = tomo.rmse_per_element(gt.cpu().numpy())
    counts = _read(kernels, "fusion path (ChemicalTomo)", FUSION_KERNELS)
    for name in FUSION_KERNELS:
        require(runs["host loop"][0][name] > 0,
                f"{name} was not launched in the data_fusion host loop")
    require(runs["sart"][0]["K8_sart_sweep"] > 0,
            "K8 was not launched by data_fusion(method='sart')")
    for name, (_, m) in runs.items():
        require(bool(np.isfinite(m).all()) and bool((m[2] > 0).all()),
                f"data_fusion ({name}) costs are not finite: {m}")
    require(recon.shape == (nel, ns, n, n) and bool(np.isfinite(recon).all())
            and bool(np.isfinite(rmse).all()),
            "ChemicalTomo reconstruction is not finite")
    _check_fusion_kernels(tomo, card)
    print(f"fusion path {nel}x{ns}x{n}^2, HAADF {len(ha)} / chemistry "
          f"{len(ca)} angles: ChemicalTomo chemical_tomography(3) + "
          f"data_fusion(3) each way; costHAADF host loop "
          f"{np.array2string(runs['host loop'][1][0], precision=4)}, fused "
          f"{np.array2string(runs['fused'][1][0], precision=4)}, sart "
          f"{np.array2string(runs['sart'][1][0], precision=4)}; rmse per "
          f"element {np.array2string(rmse, precision=4)}")
    _time_fusion_outer(card)
    return counts


def _check_fusion_kernels(tomo, card: str) -> None:
    """The fusion path's kernels against their plain versions at the shapes
    that path gives them, with phase 3's bounds, after its launch counts
    were read: on element 0 of ChemicalTomo's state (N, N, 128) and its
    HAADF model h, K1 and K2 (plain and fused, as SIRT and Poisson-ML call
    it) under the chemistry geometry (45 angles) and the HAADF geometry
    (90), the FGP chain of 5 iterations (K3, then K4 with momentum off)
    with f32 and bf16 duals, K5 (element 0, and the whole state in one
    launch), and one HAADF SART sweep (K8) from h."""
    from tomojax_torch.fusion import model_haadf
    from tomojax_torch.projector import cuda_joseph as cj
    from tomojax_torch.solvers import cuda_sart, make_sart_weights
    from tomojax_torch.solvers.iterative import POISSON_EPS
    from tomojax_torch.tv import cuda_fgp, cuda_tv_value
    from tomojax_torch.tv.cuda_fgp import tv_fgp_fused

    fsys = tomo.fsys
    xe = tomo.x[0].contiguous()
    h = model_haadf(tomo.x, fsys).contiguous()
    dev = xe.device
    out = []

    def held(name, got, ref, tol):
        err = max_err(got, ref)
        require(err <= tol, f"fusion shapes, {name}: error {err:.3e} above "
                            f"{tol:.3e}")
        out.append(f"{name} {err:.2e} <= {tol:.2e}")

    def rel(ref):
        return 1e-5 * float(ref.abs().max())

    for tag, sysd, v, b in (("chem", fsys.chem, xe, tomo.b_chem[0]),
                            ("haadf", fsys.haadf, h, tomo.b_haadf)):
        geom = sysd.geom
        ax = cj.fp_sl(v, geom)
        ref = cj.fp_sl_ref(v, geom)
        held(f"K1 {tag} {geom.nproj}", ax, ref, rel(ref))
        if tag == "chem":  # Poisson-ML's ratio and constant C = -lam/L
            y = (ax - b) / (ax + POISSON_EPS)
            c = (-0.05 / fsys.l_aps).expand(geom.n, geom.n).contiguous()
        else:  # SIRT's weighted residual and C = inv_col
            y, c = (b - ax) * sysd.inv_row[:, :, None], sysd.inv_col
        ref = cj.bp_sl_ref(y, geom)
        held(f"K2 {tag}", cj.bp_sl(y, geom), ref, rel(ref))
        ref = cj.bp_sirt_sl_ref(y, geom, v, c)
        held(f"K2 fused {tag}", cj.bp_sirt_sl(y, geom, v, c), ref, rel(ref))

    for dt, tol in ((torch.float32, 1e-4 * float(xe.abs().max())),
                    (torch.bfloat16, LAM * 2e-2)):
        p = tuple(torch.zeros(xe.shape, dtype=dt, device=dev)
                  for _ in range(3))
        for _ in range(4):
            p = cuda_fgp.fgp_iter_ref(xe, *p, LAM)
        d_ref, _ = cuda_fgp.fgp_obj_mom_ref(xe, *p, LAM)
        d = tv_fgp_fused(xe, 5, LAM, dual_dtype=dt)
        held(f"K3+K4 chain of 5 {str(dt)[6:]}", d, d_ref, tol)
    got, ref = cuda_tv_value.tv_value(xe), cuda_tv_value.tv_value_ref(xe)
    err = abs(float(got) - float(ref))
    require(err <= 2e-5 * abs(float(ref)), f"fusion shapes, K5: {err:.3e}")
    out.append(f"K5 rel {err / abs(float(ref)):.2e} <= 2e-5")
    xs = tomo.x.contiguous()  # the whole state, as tv() takes it
    before = cuda_tv_value.tv_value.launches
    got, ref = cuda_tv_value.tv_value(xs), cuda_tv_value.tv_value_ref(xs)
    require(cuda_tv_value.tv_value.launches == before + 1,
            "fusion shapes: K5 took more than one launch for the 4D state")
    err = abs(float(got) - float(ref))
    require(err <= 2e-5 * abs(float(ref)), f"fusion shapes, K5 4D: {err:.3e}")
    out.append(f"K5 on the {tuple(xs.shape)} state (one launch) rel "
               f"{err / abs(float(ref)):.2e} <= 2e-5")

    sh = fsys.haadf
    args = (tomo.b_haadf, sh.geom, sh.inv_row, make_sart_weights(sh),
            torch.ones((), device=dev),
            torch.arange(sh.geom.nproj, dtype=torch.int32, device=dev))
    ref = cuda_sart.sart_sweep_sl_ref(h, *args)
    held("K8 haadf sweep", cuda_sart.sart_sweep_sl(h, *args), ref,
         1e-4 * float(ref.abs().max()))
    torch.cuda.synchronize()
    print(f"fusion path kernels at its shapes ({tuple(xe.shape)} per "
          f"element; bounds of phase 3): " + "; ".join(out) + f" [{card}]")


def _time_fusion_outer(card: str, nel=3, ns=128, n=256, na=90, nac=45,
                       iters=5) -> None:
    """bench.py's fusion row: random x, bh, bc from default_rng(0), weights
    ones, gamma 1.6, lam_HAADF 10, lam_chem 0.05, iterSIRT 5, tvIter 5,
    lam_TV 1e-4; ms per outer iteration over `iters` iterations (CUDA
    events), then a torch.profiler window of 2 iterations by kernel."""
    from tomojax_torch.fusion import data_fusion_step, make_fusion_system
    from tomojax_torch.solvers import to_sl
    from tomojax_torch.tv import tv_fgp_4d

    dev = torch.device("cuda")
    fsys = make_fusion_system(n, np.deg2rad(np.linspace(-76, 76, na)),
                              np.deg2rad(np.linspace(-76, 76, nac)),
                              np.ones(nel, np.float32), 1.6, dev)
    rng = np.random.default_rng(0)

    def draw(*shape):  # as bench.py draws them: float64, then float32
        return to_sl(torch.from_numpy(
            rng.random(shape).astype(np.float32)).to(dev))

    x, bh, bc = draw(nel, ns, n, n), draw(ns, na, n), draw(nel, ns, nac, n)

    def outer(v):
        v, _, _ = data_fusion_step(v, bh, bc, fsys, 10.0, 0.05, 5)
        return tv_fgp_4d(v, 5, 1e-4)[0]

    with plain_versions_forbidden():
        v = outer(x)  # warm-up
        v, run_ms = _events_ms(lambda: _chain(outer, v, iters))
        require(bool(torch.isfinite(v).all()), "fusion outer iteration "
                                               "is not finite")
        prof = _profiled(lambda: _chain(outer, v, 2))
    ms = run_ms / iters
    print(f"fusion outer iteration {nel}x{ns}x{n}^2, HAADF {na} / chemistry "
          f"{nac} angles, iterSIRT 5, tvIter 5: {ms:.3f} ms/iteration = "
          f"{nel * ns * n * n / (ms / 1e3) / 1e6:.1f}M voxel-iters/s over "
          f"{iters} iterations [{card}]")
    print("  profile (2 iterations): " + _profile_summary(prof, 2))


def _chain(fn, v, k):
    for _ in range(k):
        v = fn(v)
    return v


def _profiled(fn):
    """A torch.profiler trace (host and device) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _profile_summary(prof, iters: int) -> str:
    """Device ms per iteration by kernel name (the 12 largest), the total,
    and the idle share of the device window (1 - busy / first start to
    last end)."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda]
    if not evs:
        return "no device events"
    by = {}
    for e in evs:
        by[e.name] = by.get(e.name, 0.0) + (e.time_range.end
                                            - e.time_range.start)
    busy = sum(by.values())
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs))
    top = sorted(by.items(), key=lambda kv: -kv[1])[:12]
    return (f"device busy {busy / iters / 1e3:.4f} ms/iteration, idle share "
            f"{100 * (1 - busy / span):.2f} %; " + "; ".join(
                f"{name[:60]} {us / iters / 1e3:.4f}" for name, us in top))


def phase_variants(card: str, kernels: dict) -> dict:
    """The variant entry points at 256^3: tv_fgp_fused(fuse_pairs=True)
    (K11) with f32 and bf16 duals against the K3 chain, tv_fgp_two_pass
    (K12 + K4) against tv_fgp_fused with f32 duals, and ten ASTRA-SIRT
    iterations at 256^3 x 90 with bp_sirt_sl(ab=6) (K10) against K2."""
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector.cuda_joseph import bp_sirt_sl, fp_sl
    from tomojax_torch.sim import nanocube_phantom
    from tomojax_torch.solvers import make_system, sirt_sweep_sl, to_sl
    from tomojax_torch.tv.cuda_fgp import tv_fgp_fused, tv_fgp_two_pass

    dev = torch.device("cuda")
    n, na, ns, it = 256, 90, 256, 10
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((n, n, ns), generator=gen, device=dev)
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    sysd = make_system(geom, dev)
    b = fp_sl(to_sl(torch.from_numpy(nanocube_phantom(ns, n)).to(dev)), geom)
    x0 = torch.zeros((n, n, ns), device=dev)

    def sirt_ab6(v):  # sirt_sweep_sl's 'astra' loop with K10 for K2
        for _ in range(it):
            resid = (b - fp_sl(v, geom)) * sysd.inv_row[:, :, None]
            v = bp_sirt_sl(resid, geom, v, sysd.inv_col, ab=6)
        return v

    _reset(kernels)
    with plain_versions_forbidden():
        pairs = {dt: (tv_fgp_fused(x, N_TV, LAM, dual_dtype=dt,
                                   fuse_pairs=True),
                      tv_fgp_fused(x, N_TV, LAM, dual_dtype=dt))
                 for dt in (torch.float32, torch.bfloat16)}
        two, _ = tv_fgp_two_pass(x, N_TV, LAM)
        one = pairs[torch.float32][1]
        (xa, ms_ab) = _events_ms(lambda: sirt_ab6(x0))
        (xb, ms_k2) = _events_ms(lambda: sirt_sweep_sl(x0, b, sysd, it))
    counts = _read(kernels, "variant entry points", VARIANT_KERNELS)
    e32 = max_err(*pairs[torch.float32])
    e16 = max_err(*pairs[torch.bfloat16])
    e2p, esirt = max_err(two, one), max_err(xa, xb)
    t32, t16 = 1e-6 * float(x.abs().max()), LAM * 3e-2
    tsirt = 1e-5 * float(xb.abs().max())
    require(e32 <= t32 and e16 <= t16 and e2p <= 2e-6 and esirt <= tsirt,
            f"variants: pairs f32 {e32:.3e} (<= {t32:.3e}), bf16 {e16:.3e} "
            f"(<= {t16:.3e}), two-pass {e2p:.3e} (<= 2e-6), SIRT ab=6 "
            f"{esirt:.3e} (<= {tsirt:.3e})")
    print(f"variants at {n}^3, lam {LAM}, {N_TV} FGP iterations: "
          f"fuse_pairs vs K3 chain f32 duals {e32:.2e} <= {t32:.2e} (1e-6 "
          f"max|x|), bf16 {e16:.2e} <= {t16:.1e} (lam 3e-2: one bf16 "
          f"rounding of the duals per pair instead of per iteration); "
          f"two-pass vs fused f32 {e2p:.2e} <= 2e-6; {it} ASTRA-SIRT "
          f"iterations x {na} angles with K10 (ab=6) vs K2 {esirt:.2e} <= "
          f"{tsirt:.2e} (1e-5 max|x|), {ms_ab / it:.3f} vs {ms_k2 / it:.3f} "
          f"ms/iteration [{card}]")
    return counts


# The experiment kernels, one row per TPU kernel of scripts/exp_*.py: (row,
# wrapper, the driver whose run counts its launches, the TPU kernel, the
# instantiation whose check at 256^3 gives the row's numbers).
EXP_SRC = {"E1": "tomojax_torch/csrc/exp_projector.cu",
           "E2": "tomojax_torch/csrc/exp_projector.cu",
           "E3": "tomojax_torch/csrc/exp_sart.cu",
           "E4": "tomojax_torch/csrc/exp_sart.cu"}
EXP_ROWS = (
    ("E1_fp_hat", "fp_variant", "hat_model", "exp_hat_model.py:72",
     "E1 FULL ab8"),
    ("E2_bp_hat", "bp_variant", "hat_model", "exp_hat_model.py:172",
     "E2 FULL"),
    ("E2_bp_hat_banded", "bp_variant", "hat_model", "exp_hat_model.py:259",
     "E2 FULL"),
    ("E1_fp_pair", "fp_variant", "pair_fp", "exp_pair_fp.py:81",
     "E1 PAIR ab8"),
    ("E1_fp_w4", "fp_variant", "projector_variants",
     "exp_projector_variants.py:46", "E1 W4 ab16"),
    ("E2_bp_w4", "bp_variant", "projector_variants",
     "exp_projector_variants.py:101", "E2 W4"),
    ("E2_bp_aps2", "bp_variant", "projector_variants2",
     "exp_projector_variants2.py:38", "E2 APS2"),
    ("E3_sart_dbuf", "sart_variant", "sart_pipeline",
     "exp_sart_pipeline.py:85", "E3 TAPS_F32"),
    ("E3_sart_wvmem", "sart_variant", "sart_pipeline",
     "exp_sart_pipeline.py:169", "E3 TAPS_BF16"),
    ("E3_sart_whbm", "sart_variant", "sart_pipeline",
     "exp_sart_pipeline.py:248", "E3 TABLE_BF16"),
    ("E4_sart_resident", "sart_resident", "sart_pipeline",
     "exp_sart_pipeline.py:314", "E4 TAPS_BF16"),
    ("E3_sart_ablate", "sart_variant", "sart_ablate",
     "exp_sart_ablate.py:35", "E3 TAPS_F32"),
    ("E3_sart_phase", "sart_variant", "sart_ablate",
     "exp_sart_ablate.py:140", "E3 TAPS_F32"),
)
EXP_DRIVERS = ("hat_model", "projector_variants", "projector_variants2",
               "pair_fp", "sart_pipeline", "sart_ablate")


def _check_experiment_kernels(card: str) -> dict:
    """Every instantiation of E1 (six forms and PAIR, each at every angle
    cap 1-32; device times beside K1's; also at the ragged shapes), E2
    (five forms, APS 2), E3 (six modes) and E4 (three) against its plain
    version at 256^3 x 90 with phase 3's bounds (projectors 1e-5 max|out|;
    one SART sweep from zero on nanocube projections 1e-4 max|x|; 0.0
    expected: the plain versions repeat the kernels' arithmetic), each
    launched; its time, the plain version's, its bound and, for the forms
    that compute A x or A^T y, torch.sparse.mm's."""
    from tomojax_torch.experiments import (
        cuda_projector_variants as cpv, cuda_sart_variants as csv,
    )
    from tomojax_torch.experiments.timing import batch_ms
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector.cuda_joseph import bp_sl, fp_sl
    from tomojax_torch.sim import nanocube_phantom
    from tomojax_torch.solvers import make_sart_weights, make_system, to_sl

    dev = torch.device("cuda")
    n, na, ns = 256, 90, 256
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand((n, n, ns), generator=gen, device=dev)
    y = torch.rand((na, n, ns), generator=gen, device=dev)
    V, S, P = n * n * ns, na * n * ns, n * n
    A, At, nnz = joseph_csr(geom, dev)
    spmv = 2 * nnz * ns
    fp_lib = time_ms(lambda: torch.sparse.mm(A, x.reshape(P, ns)), 5)
    bp_lib = time_ms(lambda: torch.sparse.mm(At, y.reshape(na * n, ns)), 5)
    del A, At
    rows, e1_dev = {}, {}

    def held(key, wrapper, fn, plain, rel_tol, work, library_ms=None,
             plain_ms=None):
        got = _launched(wrapper, fn)
        ref = plain()
        err, tol = max_err(got, ref), rel_tol * float(ref.abs().max())
        require(err <= tol, f"{key}: error {err:.3e} above {tol:.3e}")
        ms = time_ms(fn, 5)
        plain_ms = time_ms(plain, 1) if plain_ms is None else plain_ms
        if key.startswith("E1"):
            form, ab = key.split()[1], int(key.split()[2][2:])
            e1_dev[(form, ab)] = device_ms(fn, 5)
        bound_ms, bound_by = bound(*work)
        rows[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms}
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        print(f"{key}: max|kernel - plain| {err:.3e} <= {tol:.3e}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound "
              f"{bound_ms:.4f} ms ({bound_by}) [{card}]")

    # projectors: K1/K2's work; NODOT reads nothing and adds 7 operations
    # (its weight and the sum) per nonzero and slice. E1: every form at
    # every angle cap, PAIR at every cap; the plain version once per form
    for form in (*cpv.FORMS, "PAIR"):
        pair = form == "PAIR"
        fm = "FULL" if pair else form
        nodot = form == "NODOT"
        ref = cpv.fp_variant_ref(x, geom, fm, pair)
        plain_ms = time_ms(lambda: cpv.fp_variant_ref(x, geom, fm, pair), 1)
        for ab in cpv.ANGLES_PER_BLOCK:
            held(f"E1 {form} ab{ab}", cpv.fp_variant,
                 lambda: cpv.fp_variant(x, geom, fm, ab=ab, pair=pair),
                 lambda: ref, 1e-5,
                 (4 * S, 7 * nnz * ns) if nodot else (4 * (V + S), spmv),
                 None if form in ("NOHAT", "NODOT") else fp_lib, plain_ms)
    caps = cpv.ANGLES_PER_BLOCK
    by_cap = "; ".join(
        f"{form} " + "/".join(f"{e1_dev[form, ab]:.4f}" for ab in caps)
        for form in (*cpv.FORMS, "PAIR"))
    print(f"E1 device ms at angle caps {'/'.join(map(str, caps))}: {by_cap}; "
          f"K1 {device_ms(lambda: fp_sl(x, geom), 5):.4f} [{card}]")
    _check_e1_ragged(gen)
    e2 = {form: (lambda f=form: cpv.bp_variant(y, geom, f))
          for form in cpv.BP_FORMS}
    e2["APS2"] = lambda: cpv.bp_variant(y, geom, aps=2)
    for form, fn in e2.items():
        fm = "FULL" if form == "APS2" else form
        held(f"E2 {form}", cpv.bp_variant, fn,
             lambda: cpv.bp_variant_ref(y, geom, fm), 1e-5,
             (4 * V, 7 * nnz * ns) if form == "NODOT" else (4 * (S + V), spmv),
             None if form in ("NOHAT", "NODOT") else bp_lib)
        require(rows[f"E2 {form}"]["max_abs_err"] == 0.0,
                f"E2 {form} is not bit-equal to its plain version")
    _check_e2_ragged(gen)
    # CUDA events around a batch: torch.profiler under-reported E2 here
    e2_ms = {form: batch_ms(fn, 10, dev) for form, fn in e2.items()}
    k2_ms = batch_ms(lambda: bp_sl(y, geom), 10, dev)
    print(f"E2 ms a call over 10 back-to-back calls (CUDA events; K2's "
          f"tiles): " + ", ".join(f"{k} {v:.4f}" for k, v in e2_ms.items())
          + f"; K2 {k2_ms:.4f}; split on K2's design: hat (FULL - NOHAT) "
          f"{e2_ms['FULL'] - e2_ms['NOHAT']:.4f}, loads (FULL - NODOT) "
          f"{e2_ms['FULL'] - e2_ms['NODOT']:.4f}, NOHAT - K2 "
          f"{e2_ms['NOHAT'] - k2_ms:.4f}; torch.sparse.mm A^T y "
          f"{bp_lib:.4f} (one call) [{card}]")

    # SART: K8's check (one sweep from zero on nanocube projections, real
    # weights) and K8's work; the tables' bytes for TABLE_BF16; NOFP does
    # no FP, NOUPD no update
    sysd = make_system(geom, dev)
    b = fp_sl(to_sl(torch.from_numpy(nanocube_phantom(ns, n)).to(dev)), geom)
    args = (torch.zeros_like(x), b, geom, sysd.inv_row,
            make_sart_weights(sysd), torch.tensor(1.0, device=dev),
            torch.arange(na, dtype=torch.int32, device=dev))
    tables = csv.sart_tables(geom, dev)
    sart_bytes = 4 * (2 * V + na * n * (ns + 1) + na * n * n + na + 1)
    sart_ops = {"NOFP": spmv + 4 * na * V, "NOUPD": spmv + 3 * S}
    for kind, wrapper, modes in (("E3", csv.sart_variant, csv.MODES),
                                 ("E4", csv.sart_resident,
                                  csv.RESIDENT_MODES)):
        for mode in modes:
            held(f"{kind} {mode}", wrapper,
                 lambda: wrapper(*args, mode, tables),
                 lambda: csv.sart_variant_ref(*args, mode, tables), 1e-4,
                 (sart_bytes + (tables.nbytes if mode == "TABLE_BF16"
                                else 0),
                  sart_ops.get(mode, 2 * spmv + 4 * na * V)))
    return rows


def _check_e1_ragged(gen) -> None:
    """E1 at the ragged shapes (N 33, Na 7, Ns 5 and N 48, Na 14, Ns 37):
    every form at every angle cap, and PAIR on a symmetric series of even
    Na (8 and 14 angles), against the plain version (1e-5 max|out|, 0.0
    expected)."""
    from tomojax_torch.experiments import cuda_projector_variants as cpv
    from tomojax_torch.geometry import Geometry

    worst = 0.0
    for n, na, ns in ((33, 7, 5), (48, 14, 37)):
        x = torch.rand((n, n, ns), generator=gen, device="cuda")
        for form in (*cpv.FORMS, "PAIR"):
            pair = form == "PAIR"
            m = na + na % 2 if pair else na
            geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, m)))
            fm = "FULL" if pair else form
            ref = cpv.fp_variant_ref(x, geom, fm, pair)
            for ab in cpv.ANGLES_PER_BLOCK:
                e = max_err(cpv.fp_variant(x, geom, fm, ab=ab, pair=pair),
                            ref) / float(ref.abs().max())
                require(e <= 1e-5, f"E1 {form} ab{ab} at {(n, m, ns)}: "
                                   f"{e:.3e} above 1e-5 max|out|")
                worst = max(worst, e)
    print(f"E1 at N 33, Na 7 (PAIR 8), Ns 5 and N 48, Na 14, Ns 37: every "
          f"form and PAIR at angle caps {cpv.ANGLES_PER_BLOCK} vs plain "
          f"{worst:.1e} <= 1e-5 max|out|")


def _check_e2_ragged(gen) -> None:
    """E2 at the ragged shapes (N 33, Na 7, Ns 5 and N 48, Na 13, Ns 37:
    tiles and slabs cut short, scalar copies and stores, a ragged last ring
    stage): every form and APS 2 equal to the plain version bit for bit."""
    from tomojax_torch.experiments import cuda_projector_variants as cpv
    from tomojax_torch.geometry import Geometry

    for n, na, ns in RAGGED_SHAPES:
        geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
        y = torch.rand((na, n, ns), generator=gen, device="cuda")
        for form, aps in [(f, 1) for f in cpv.BP_FORMS] + [("FULL", 2)]:
            require(torch.equal(cpv.bp_variant(y, geom, form, aps=aps),
                                cpv.bp_variant_ref(y, geom, form)),
                    f"E2 {form} aps {aps} at {(n, na, ns)} differs from "
                    f"its plain version")
    print(f"E2 at N 33, Na 7, Ns 5 and N 48, Na 13, Ns 37: every form and "
          f"APS 2 equal to the plain version bit for bit")


def _check_ablation_sass() -> None:
    """The ablations must keep what they claim to keep (cuobjdump -sass of
    the built library). E1 (each block size) and E2: NODOT its weights'
    adds with no ring copy (LDGSTS) and no shared load (LDS), NOHAT its
    ring copies and 16-byte shared loads."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME

    from tomojax_torch import _build

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.build().path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = {f.split("\n", 1)[0].strip(): f
             for f in re.split(r"\n\s*Function : ", sass)[1:]}

    def body(pattern: str) -> str:
        found = [b for name, b in funcs.items() if pattern in name]
        require(len(found) == 1, f"SASS: {len(found)} functions match "
                                 f"{pattern}")
        return found[0]

    def ablations(kernel: str, nodot_pattern: str, nohat_pattern: str):
        nodot, nohat = body(nodot_pattern), body(nohat_pattern)
        adds = re.findall(r"\bFADD", nodot)
        ring = re.findall(r"\bLDGSTS\S*|\bLDS\S*", nodot)
        copies = re.findall(r"\bLDGSTS\S*", nohat)
        reads = re.findall(r"\bLDS\.128", nohat)
        require(len(adds) >= 4 and not ring,
                f"{kernel} NODOT: {len(adds)} FADD, ring traffic "
                f"{sorted(set(ring))}")
        require(bool(copies) and bool(reads),
                f"{kernel} NOHAT lost its ring: {len(copies)} LDGSTS, "
                f"{len(reads)} LDS.128")
        print(f"SASS {kernel}: NODOT {len(adds)} FADD, no LDGSTS or LDS; "
              f"NOHAT {len(copies)} LDGSTS {sorted(set(copies))}, "
              f"{len(reads)} LDS.128")

    for maxt in (256, 512, 1024):
        ablations(f"fp_variant_kernel ({maxt} threads)",
                  f"fp_variant_kernelILi4ELb0ELi{maxt}E",
                  f"fp_variant_kernelILi3ELb0ELi{maxt}E")
    ablations("bp_variant_kernel", "bp_variant_kernelILi4E",
              "bp_variant_kernelILi3E")

    # registers and stack (spills) per thread of E1's and E2's
    # instantiations, of K2/K10's bp_kernel and of K8's resident kernel,
    # from cuobjdump -res-usage
    usage = subprocess.run([str(tool), "-res-usage", str(_build.build().path)],
                           capture_output=True, text=True, timeout=300).stdout
    found = re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+)", usage)
    if not found:
        print("registers/stack bytes: not read (cuobjdump -res-usage)")
    forms = ("FULL", "HAT5", "BF16", "NOHAT", "NODOT", "W4")
    e1, e2 = {}, []
    for name, reg, stack in found:
        m = re.search(r"fp_variant_kernelILi(\d)ELb(\d)ELi(\d+)E", name)
        if m:
            form = "PAIR" if m[2] == "1" else forms[int(m[1])]
            e1.setdefault(int(m[3]), []).append(f"{form} {reg}/{stack}")
        m = re.search(r"bp_variant_kernelILi(\d)ELi(\d)E", name)
        if m:
            form = "APS2" if m[2] == "2" else forms[int(m[1])]
            e2.append(f"{form} {reg}/{stack}")
        m = re.search(r"bp_kernelILb(\d)E", name)
        if m and "variant" not in name:
            print(f"registers/stack bytes bp_kernel<{m[1] == '1'}> (K2, "
                  f"K10): {reg}/{stack}")
        m = re.search(r"\d+sart_resident_kernelILb(\d)E", name)
        if m and "exp_sart" not in name:
            print(f"registers/stack bytes sart_resident_kernel<PROF="
                  f"{m[1] == '1'}> (K8): {reg}/{stack}")
    for maxt in sorted(e1):
        print(f"registers/stack bytes fp_variant_kernel ({maxt} threads): "
              f"{', '.join(sorted(e1[maxt]))}")
    print(f"registers/stack bytes bp_variant_kernel: {', '.join(sorted(e2))}")


def phase_experiments(card: str) -> dict:
    """Phase 4f: the E-kernel checks, then the six experiment drivers at
    256^3 x 90 with every plain version made to raise, each with the E
    launch counts set to 0 before it and read after; the kernels JSON rows
    of the 13 TPU kernels of scripts/exp_*.py."""
    import importlib

    from tomojax_torch.experiments import (
        cuda_projector_variants as cpv, cuda_sart_variants as csv,
        sart_pipeline,
    )

    checks = _check_experiment_kernels(card)
    _check_ablation_sass()
    wrappers = {"fp_variant": cpv.fp_variant, "bp_variant": cpv.bp_variant,
                "sart_variant": csv.sart_variant,
                "sart_resident": csv.sart_resident}
    dev = torch.device("cuda")
    launches, out = {}, {}
    for name in EXP_DRIVERS:
        mod = importlib.import_module(f"tomojax_torch.experiments.{name}")
        for w in wrappers.values():
            w.launches = 0
        with plain_versions_forbidden():
            out[name] = mod.run(256, 256, dev, card)
        torch.cuda.synchronize()
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        print(f"{name} launches: {json.dumps(launches[name])}")
    sp = out["sart_pipeline"]["rows"]
    for v, r in sp.items():  # the script's criterion: rmse after 10 sweeps
        r0 = sp["base"]["rmse10"]
        tol = 1e-4 if v == "base" or sart_pipeline.VARIANTS[v][1] == \
            "TAPS_F32" else 2e-2
        require(np.isfinite(r["ms"]) and abs(r["rmse10"] - r0) <= tol * r0,
                f"sart_pipeline {v}: rmse@10 {r['rmse10']:.6f} vs K8 "
                f"{r0:.6f} (rtol {tol})")
    # the -theta rays add the same products in the reverse order of steps
    pr = out["pair_fp"]["rel"]
    require(max(pr.values()) <= 1e-5, f"pair_fp: rel|d| {pr}")
    rows = {}
    for row, wrapper, driver, tpu, inst in EXP_ROWS:
        count = launches[driver][wrapper]
        require(count > 0, f"{row}: {wrapper} was not launched by {driver}")
        rows[row] = {"source": EXP_SRC[row[:2]],
                     "replaces": f"scripts/{tpu}", "launches": count,
                     **checks[inst]}
    return rows


# ------------------------------------------------------------------ phase 5


def phase_golden(card: str) -> None:
    from tomojax_torch import ops
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.sim import create_projections, nanocube_phantom
    from tomojax_torch.solvers import (
        fista_init_sl, fista_run_sl, from_sl, make_system, to_sl,
    )

    golden = json.loads((ROOT / "tests/golden/fista_tpu_256.json").read_text())
    cfg = golden["config"]
    ns, n, na = cfg["ns"], cfg["n"], cfg["na"]
    dev = torch.device("cuda")
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    sysd = make_system(geom, dev)
    vol = torch.from_numpy(nanocube_phantom(ns, n)).to(dev)
    b_sl = to_sl(create_projections(vol, geom))
    st = fista_init_sl(torch.zeros_like(vol), sysd, b_sl)
    st, metrics = fista_run_sl(st, b_sl, sysd, cfg["lam"], cfg["niter"],
                               cfg["ntviter"], True)
    m = metrics.cpu().numpy().astype(np.float64)
    rmse = float(ops.rmse(from_sl(st.x), vol))
    dd_g, tv_g = np.asarray(golden["dd"]), np.asarray(golden["tv"])
    dev_dd = float(np.max(np.abs(m[:, 1] - dd_g) / np.abs(dd_g)))
    dev_tv = float(np.max(np.abs(m[:, 2] - tv_g) / np.abs(tv_g)))
    dev_rmse = abs(rmse - golden["rmse_final"])
    print(f"golden {ns}x{n}^2x{na}, {cfg['niter']} iterations vs "
          f"{cfg['device']}: max rel dev dd {dev_dd:.3e}, tv {dev_tv:.3e}; "
          f"|rmse - rmse_final| {dev_rmse:.3e} (rmse {rmse:.6f}) [{card}]")
    require(np.allclose(m[:, 1], dd_g, rtol=5e-3)
            and np.allclose(m[:, 2], tv_g, rtol=5e-3) and dev_rmse < 1e-3,
            "golden trace outside rtol 5e-3 (dd, tv) or 1e-3 (rmse)")


def phase_golden_asd(card: str) -> None:
    from tomojax_torch import ops
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.sim import create_projections, nanocube_phantom
    from tomojax_torch.solvers import (
        AsdPocsParams, asd_pocs_host_loop, from_sl, make_sart_weights,
        make_system, to_sl,
    )

    golden = json.loads(
        (ROOT / "tests/golden/asd_pocs_jax_cpu.json").read_text())
    c, bd = golden["config"], golden["bounds"]
    p = AsdPocsParams(**golden["params"])
    ns, n, na = c["ns"], c["n"], c["na"]
    dev = torch.device("cuda")
    geom = Geometry.make(n, np.deg2rad(np.linspace(-c["span_deg"],
                                                   c["span_deg"], na)))
    sysd = make_system(geom, dev)
    vol = torch.from_numpy(nanocube_phantom(ns, n)).to(dev)
    b_sl = to_sl(create_projections(vol, geom))
    x, dd, tv, used = asd_pocs_host_loop(
        torch.zeros((n, n, ns), device=dev), b_sl, sysd,
        make_sart_weights(sysd), p)
    rmse = float(ops.rmse(from_sl(x), vol))

    def rel(got, want):
        want = np.asarray(want)
        return float(np.max(np.abs(np.asarray(got) - want) / np.abs(want)))

    dev_dd, dev_tv, dev_dp = rel(dd, golden["dd"]), rel(tv, golden["tv"]), \
        rel(used, golden["dpocs"])
    dev_rmse = abs(rmse - golden["rmse_final"])
    print(f"golden ASD-POCS {ns}x{n}^2x{na}, {p.niter} iterations vs "
          f"{c['device']}: max rel dev dd {dev_dd:.3e} (<= {bd['dd_rtol']}), "
          f"tv {dev_tv:.3e} (<= {bd['tv_rtol']}), dpocs {dev_dp:.3e} "
          f"(<= {bd['dpocs_rtol']}); |rmse - rmse_final| {dev_rmse:.3e} "
          f"(< {bd['rmse_atol']}; rmse {rmse:.6f}) [{card}]")
    require(dev_dd <= bd["dd_rtol"] and dev_tv <= bd["tv_rtol"]
            and dev_dp <= bd["dpocs_rtol"] and dev_rmse < bd["rmse_atol"],
            "ASD-POCS golden trace outside its bounds")


def phase_golden_fusion(card: str) -> None:
    """tests/golden/fusion_jax_cpu.json: the reference's ChemicalTomo host
    loop on the CPU, replayed by the port on the card (its own system,
    projections and kernels, float32 FGP duals) within the stored bounds.
    The lambda_chem decay iterations are checked first: a mismatch there is
    a flipped branch, not drift."""
    from tomojax_torch import ChemicalTomo, config

    golden = json.loads(
        (ROOT / "tests/golden/fusion_jax_cpu.json").read_text())
    c, bd = golden["config"], golden["bounds"]
    require(c["gamma"] == 1.6 and c["sigma_method"] == 3
            and c["method"] == "sirt", "golden config outside the replay")
    gt, haadf, chem, ha, ca = _fusion_problem(
        torch.device("cuda"), c["nel"], c["ns"], c["n"], c["na_haadf"],
        c["na_chem"], tuple(c["elements"]), c["span_deg"])
    saved = config.fgp_dual_dtype
    config.fgp_dual_dtype = torch.float32
    try:
        tomo = ChemicalTomo(haadf, ha, chem, ca, gamma=c["gamma"],
                            sigmaMethod=c["sigma_method"])
        tomo.chemical_tomography(Niter=c["chem_iters"],
                                 lambdaCHEM=c["lambda_chem"])
        trace = {"costCHEM_chem": tomo.costCHEM.copy()}
        tomo.data_fusion(Niter=c["fusion_iters"], lambdaCHEM=c["lambda_chem"],
                         lambdaHAADF=c["lambda_haadf"],
                         lambdaTV=c["lambda_tv"], iterSIRT=c["iter_sirt"],
                         tvIter=c["tv_iter"], method=c["method"])
    finally:
        config.fgp_dual_dtype = saved
    for name in ("costHAADF", "costCHEM", "costTV"):
        trace[name] = getattr(tomo, name)
    ch = trace["costHAADF"]
    decays = [i for i in range(1, len(ch)) if ch[i] > ch[i - 1]]
    require(decays == golden["decay_iterations"],
            f"fusion golden: branch flip, lambda_chem decayed at iterations "
            f"{decays}, the golden run at {golden['decay_iterations']}")
    dev = {name: float(np.max(np.abs(np.asarray(v, np.float64)
                                     - np.asarray(golden[name]))
                              / np.abs(np.asarray(golden[name]))))
           for name, v in trace.items()}
    rmse = tomo.rmse_per_element(gt.cpu().numpy())
    dev["rmse_final"] = float(np.max(np.abs(rmse - np.asarray(
        golden["rmse_final"]))))
    print(f"golden fusion {c['nel']}x{c['ns']}x{c['n']}^2, HAADF "
          f"{c['na_haadf']} / chemistry {c['na_chem']} angles vs "
          f"{c['device']}: lambda_chem decays at {decays} as recorded; max "
          f"rel dev " + ", ".join(f"{k} {v:.3e} (<= {bd[k]})"
                                  for k, v in dev.items()) + f" [{card}]")
    require(all(v <= bd[k] for k, v in dev.items()),
            "fusion golden trace outside its bounds")


# ------------------------------------------------------------------- main


def tv_times_main() -> int:
    """`--tv-times`: only the device and batch times of `tv_times`, with the
    tomojax_torch package beside this file; a copy of this file beside
    another tree times that tree's kernels."""
    card = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def uni(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    times = tv_times(uni, card, str(ROOT.name))
    print(json.dumps({"tv_ms": times, "tree": str(ROOT)}))
    return 0


def projector_times_main() -> int:
    """`--projector-times`: only the times of K1, K2, K10 (ab 6), E1 FULL,
    E2 FULL and one K8 sweep at 256^3 x 90 and 128 x 512^2 x 90
    (`projector_times`), with the
    tomojax_torch package beside this file; a copy of this file beside
    another tree times that tree's kernels."""
    from tomojax_torch.geometry import Geometry

    card = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def uni(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    times = {}
    for n, ns in ((256, 256), (512, 128)):
        geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, 90)))
        times[f"{ns}x{n}^2x90"] = projector_times(geom, ns, uni, card,
                                                  str(ROOT.name))
    print(json.dumps({"projector_ms": times, "tree": str(ROOT)}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--projector-times"]:
        return projector_times_main()
    if sys.argv[1:] == ["--tv-times"]:
        return tv_times_main()
    try:
        card = phase_device()
        phase_build()
        kernels = _kernel_table()
        rows = phase_kernels(card)
        paths = [phase_main_path(card, kernels),
                 phase_asd_path(card, kernels),
                 phase_sharded_path(card, kernels),
                 phase_fusion_path(card, kernels),
                 phase_variants(card, kernels)]
        exp_rows = phase_experiments(card)
        phase_golden(card)
        phase_golden_asd(card)
        phase_golden_fusion(card)
    except PhaseFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    # launches: the kernel's count over the main paths' runs (phase 4a-e),
    # an experiment kernel's over its driver's run (phase 4f)
    report = [{"name": name, "route": "cuda", "source": src,
               "replaces": rep,
               "launches": sum(c[name] for c in paths), **rows[name]}
              for name, (_, src, rep) in kernels.items()]
    report += [{"name": name, "route": "cuda", **row}
               for name, row in exp_rows.items()]
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
