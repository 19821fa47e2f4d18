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
   entries leaving x: the resident route on (8, 4) at 256^3 x 90 and at N
   33, Na 7, Ns 5, on (16, 2) at 128 x 512^2 x 90 and x 77, on (16, 1)
   spilling at 8 x 544^2 x 13 and 64 x 1024^2 x 77, the streaming route
   at 8 x 1056^2 x 13; each with its cluster shape, clusters, waves, shared
   memory and spilled rows a block (resident), its ms a sweep over 10
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
   the ART sweep (A1) in each of its slices-a-block instantiations against
   its plain version at 256^3 x 90 and at N 33, Na 7, Ns 5 (three single
   ray steps from random x, 1e-6 max|x|; one sweep from zero on nanocube
   projections in each of three orders, angle-major, random and two
   angles in turns, 1e-4 max|x|; two sweeps identical; out-of-range rays
   leave x), at 128 x 512^2 and 64 x 1024^2 x 90 over the rays of three
   angles (0.854, 45 and 76 degrees; 1e-4 max|x|) in every instantiation
   that takes N, and its ms a sweep at 256^3 x 90 angle-major and in a
   random order (CUDA events) beside its bound, with the split of a ray
   by the kernel's variants (no loads, no block partials, no stores, no
   L2 prefetch, the chain alone) and the clock64 cycles of its phases;
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
      one sharded and one unsharded ASD-POCS iteration under
      profiling.trace (traces under build/chip_smoke_traces/), each with
      its top device operations and the device's busy share; then,
      through the same group, the sharded fusion path: ChemicalTomo(...,
      group=g) on phase 4d's problem (chemical_tomography(3), then
      data_fusion(3) as the host loop, fused=True and method='sart') and
      tv_gd_4d(10) with the group, each against the unsharded call
      (reconstruction 1e-6 max|x|, costs rtol 1e-5), K9a, K9b, K5 and K9c
      launched and K3, K4 not; the fusion golden trace replayed through
      the group (phase 5's bounds); the fusion outer iteration sharded and
      unsharded in turn (CUDA events, median of 2 each);
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
      the forms that compute A x or A^T y); E3 (the SART modes TAPS_F32,
      TAPS_BF16, TABLE_BF16, NOHAT, NOFP, NOUPD on E3's route: resident
      at 256^3 x 90, one launch a sweep; TAPS_F32 and TAPS_BF16 streaming
      at 128 x 512^2 x 90, where K8 runs (16, 2)) and E4 (TAPS_F32,
      TAPS_BF16, TABLE_BF16 at every
      cluster shape of 8 or 16 blocks and 1, 2 or 4 slices that fits, at
      both shapes) over one sweep from zero on nanocube projections, each
      equal bit for bit to the plain version in its own band order and
      within K8's bounds of the driving order (TAPS_F32: one step 1e-5,
      one sweep 1e-4 max|x|; bf16: rmse after 10 sweeps within 2 % of
      K8's), with ms a sweep beside K8's, each launch's clusters, active
      clusters, waves and shared memory, the split of K8's step (hat, FP,
      update, bf16 operands, tables) and E3's phase cycles per mode;
      cuobjdump -sass of the ablations (E1's and E2's NODOT keep their adds
      with no ring copy or shared load, their NOHAT the ring copies and
      shared loads), with registers and stack bytes per kernel; then the
      six drivers
      (hat_model, projector_variants, projector_variants2, pair_fp,
      sart_pipeline, sart_ablate) at 256^3 x 90 and sart_pipeline at 128 x
      512^2 x 90, each with the E launch counts set to 0 before it and
      read after, their rows printed, the SART variants' rmse after 10
      sweeps held against K8's (rtol 1e-4 for float32, 2e-2 for bf16) and
      the paired FP against the unpaired (rel 1e-5);
   g. the simulation study (examples/demo.py's): Simulator at 256 x 256^2
      x 90 over +-76 deg, nanocube seed 0, snr 200 (its set-up split into
      K1's time and the host's Poisson draw), then wbp (ram-lak, hann),
      cgls(30), art(1) angle-major and random, sirt(10), each called
      twice and timed by CUDA events, with its rmse against the
      background-filled phantom
      (the iterative ones below x = 0's); then pytvlib.run over every
      alias at 64 slices;
   h. streaming acquisition: the projections of phase 4a's problem as
      files under build/, a TiltWatcher revealing 8 a poll and
      DynamicReconstructor.run (10 iterations a round) with masked SIRT
      and with the CS rounds (dd must fall over the last three rounds,
      the rmse end below x = 0's); ms a SIRT sweep, a CS iteration and a
      CS round (CUDA events), the set-up per new angle set and a poll of
      8 files (host clock), the sweep with the angles in arrival order
      against sorted, a profiler window of each round; both runs through an NCCL group of world size 1
      (the unsharded dd at rtol 1e-5, K9c launched) and save_sharded /
      load_sharded of its CUDA slab bit for bit; the schedule at 8 x
      64^2 x 30 angles in 4 arrivals on the card against the CPU's plain
      versions (SIRT: dd rtol 1e-5, the volume 1e-5 max|x|; CS, whose
      trajectory amplifies last digits: every iteration from the plain
      run's state, dd rtol 1e-3, dPOCS 1e-5); iterate after iterate_cs equal to a fresh reconstructor's
      on the same x; K1 and K2 (both epilogues) at 1, 2 and 3 angles (N
      64, Ns 8) against their plain versions with phase 3's bounds;
   i. the TV extras: tv_chambolle(20) and tv_split_bregman(10) once each
      on a noisy 128 x 256^2 nanocube against the same call on the CPU
      (1e-5 max|d|; the TV value, K5, rtol 2e-5), with both times; every
      viz figure from card tensors under build/chip_smoke_viz/ where
      matplotlib is installed;
   every kernel of a path must have launched in it;
5. golden: the 32 x 256^2 x 90, 20-iteration trace of
   tests/golden/fista_tpu_256.json replayed within rtol 5e-3 (dd, tv) and
   1e-3 (final rmse); the 16 x 64^2 x 30, 10-iteration ASD-POCS trace of
   tests/golden/asd_pocs_jax_cpu.json and the 2 x 8 x 64^2 ChemicalTomo
   trace of tests/golden/fusion_jax_cpu.json (float32 FGP duals; the
   lambda_chem decay iterations first, as a branch check) replayed within
   the bounds stored in them; the reference's CPU SIRT trace
   (GOLDEN_SIRT_DD of tests/test_golden_traces.py, 1 x 32^2 x 20, 10
   iterations) within its rtol 2e-3;
6. result: a JSON line of the kernels (K1-K12, A1, then E1-E4 as one row
   per TPU kernel of scripts/exp_*.py), then the device line last.

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

    python3 chip_smoke.py --sart-times

times only K8, ms a sweep over 10 back-to-back sweeps from zero on
nanocube projections, at 64 x 1024^2 x 77, 128 x 512^2 x 77 and x 90,
128 x 320^2 x 77 and 256^3 x 90, with each route and cluster shape, the
bound and a hash of one sweep's output (at 1024^2 also the resident
launch and the phase cycles with the row-driven rays walked together and
one after another), in the same way beside another tree (an older tree's streaming
sweep at 1024^2 is then timed in the same call, and equal 256^3 and
512^2 hashes show the (8, 4) and (16, 2) sweeps unchanged).

    python3 chip_smoke.py --art-times

times only A1 at 256^3 x 90 (`art_times`: every slices-a-block
instantiation angle-major and random, and the variants and phases where
the tree has them) and prints A1's registers and spills from the build,
in the same way beside another tree.

    python3 chip_smoke.py --d2h-times

times only `host.to_host` of a float32 CUDA volume of 2^26 and 2^27 B
(the job cells' results), host clock around each blocking call: the
pageable copy (`t.cpu().numpy()`), the pinned route with a fresh
`cudaHostAlloc` (each result kept) and with a block from torch's host
cache (each result dropped), with the tomojax_torch package beside the
file.

    python3 chip_smoke.py --gap-study

runs only phase 4c's gap study (`_sharded_gap_study`) on the 256^3 x 90
ASD-POCS problem through an NCCL group of world size 1, with 16 profiled
windows each way (and without the annotation) in place of 2.

It imports nothing of JAX. Without a CUDA device it exits with 1 before
printing any result.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
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


def _max_rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                        / np.abs(want)))


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
    from tomojax_torch.solvers import cuda_art, cuda_sart
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
        # the ART sweep, an XLA scan of one ray a step in the reference
        "A1_art_sweep": (cuda_art.art_sweep_sl, "tomojax_torch/csrc/art.cu",
                         "tomojax/solvers/iterative.py:296"),
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


def _launched(wrapper, fn):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    require(wrapper.launches > before, f"{wrapper.__name__} did not launch")
    return out


def phase_kernels(card: str) -> dict:
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector import cuda_joseph as cj
    from tomojax_torch.projector.oracle import joseph_csr
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
    _check_art(geom, uni, report, card)
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


def _check_projector_shape(n: int, ns: int, angles_deg, uni) -> None:
    """K1 (both epilogues) and K2 (both) at one shape and angle set
    against their plain versions: 1e-5 max|out|, ddsq rel 2e-5, and the
    adjointness of the pair within 1e-5."""
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector import cuda_joseph as cj

    na = len(angles_deg)
    geom = Geometry.make(n, np.deg2rad(angles_deg))
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
    where = f"N {n}, Na {na}, Ns {ns}" + (
        f" (angles {list(angles_deg)} deg)" if na <= 3 else "")
    require(all(e <= 1e-5 for e in errs.values()) and dd <= 2e-5
            and adj <= 1e-5,
            f"K1/K2 at {where}: {errs}, ddsq rel {dd:.3e}, adjointness "
            f"{adj:.3e}")
    print(f"K1/K2 at {where}: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()) + " <= 1e-5 max|out|; "
        f"ddsq rel {dd:.2e} <= 2e-5; adjointness {adj:.2e} <= 1e-5")


def _check_projector_tiles(uni, card: str) -> None:
    """K1 (both epilogues) and K2 (both) against their plain versions at
    ragged shapes (N not a multiple of the tiles, Ns % 4 != 0: the scalar
    copies and stores), with phase 3's bounds; then the four rows at
    128 x 512^2 x 90, held against torch.sparse.mm with the CSR form of A
    and A^T (rel 1e-5) and timed beside it."""
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector import cuda_joseph as cj
    from tomojax_torch.projector.oracle import joseph_csr

    for n, na, ns in RAGGED_SHAPES:
        _check_projector_shape(n, ns, np.linspace(-76, 76, na), uni)
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
    shape = cuda_sart.sart_shape(n, geom.nray)
    on = route if shape is None else f"{route} {shape}"
    tag = f"K8 ({on}) at {ns} x {n}^2 x {na}"
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
    return {"route": route, "shape": shape, "tag": tag, "args": args,
            "x0": x0, "seq": seq,
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
        require((c["blocks"], c["slices"]) == lv["shape"] and c["active"] > 0,
                f"{lv['tag']}: launch {c}")
        launch = _launch_text(c)
    bound_ms, bound_by = bound(*sart_work(geom, ns, nnz))
    print(f"{lv['tag']}: {lv['text']}; {launch}; {sweep_ms:.4f} ms/sweep "
          f"over 10 back-to-back sweeps (CUDA events; SM clock after it, "
          f"max: {sm_clock()}), bound "
          f"{bound_ms:.4f} ms ({bound_by}) [{card}]")
    if lv["route"] == "resident":
        _print_phases(lv["x0"], (*lv["args"], lv["one"], lv["seq"]),
                      cuda_sart.K8_SPILL[cuda_sart.K8_SHAPES.index(
                          lv["shape"])])


def _launch_text(c: dict) -> str:
    """A resident launch (`cuda_sart.resident_clusters`) in words."""
    return (f"{c['clusters']} clusters of {c['blocks']} blocks, "
            f"{c['slices']} slices a pixel, {c['active']} at once "
            f"(cudaOccupancyMaxActiveClusters), {c['waves']} waves, "
            f"{c['smem']} B shared memory a block, "
            f"{c.get('spill_rows', 0)} band rows a block in device memory")


def _print_phases(x0, args, both: bool) -> None:
    """Print the resident sweep's phase cycles (the timed instantiation);
    `both`: also with the spilling shape's row-driven rays walked one
    after another instead of together."""
    from tomojax_torch.solvers import cuda_sart

    for serial in ((False, True) if both else (False,)):
        kw = {"serial_fp": True} if serial else {}
        phases = cuda_sart.resident_phases(x0, *args, **kw)
        walk = "rays one after another" if serial else "the route's FP"
        print(f"  phases ({walk}; the timed instantiation: clock64 cycles "
              f"a step, mean over blocks; SM clock after it, max: "
              f"{sm_clock()}): " + "; ".join(
                  f"{kind} ({v['steps']} steps) " + ", ".join(
                      f"{name} {v[name]:.0f}" for name in cuda_sart.PHASES)
                  for kind, v in phases.items()))


def _check_sart(geom, ns: int, uni, report, nnz: int, card: str) -> None:
    """K8 on both routes at _sart_levels' three levels: resident on (8, 4)
    at this shape (the row's numbers) and at N 33, Na 7, Ns 5 (a ragged
    slab, the last band empty), on (16, 2) at 128 x 512^2 x 90 and x 77
    (`haadf512`'s tilts), on (16, 1) spilling at 8 x 544^2 x 13 (no row
    spilled) and 64 x 1024^2 x 77 (`haadf1024`'s), streaming at 8 x
    1056^2 x 13; each with its launch and ms a sweep beside its bound."""
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector.oracle import joseph_nnz
    from tomojax_torch.solvers import cuda_sart

    n = geom.n
    lv = _sart_levels(geom, ns, uni(n, n, ns))
    require(lv["shape"] == (8, 4), f"K8 at {n}^2: shape {lv['shape']}")
    _sart_route_line(geom, ns, lv, nnz, card)
    sweep, plain = cuda_sart.sart_sweep_sl, cuda_sart.sart_sweep_sl_ref
    args = (lv["x0"], *lv["args"], lv["one"], lv["seq"])
    report("K8_sart_sweep", lv["sweep_err"], lv["sweep_tol"],
           time_ms(lambda: sweep(*args), 5), time_ms(lambda: plain(*args), 2),
           f" (resident route; {lv['text']})", work=sart_work(geom, ns, nnz))
    for n2, na2, ns2, want in ((33, 7, 5, (8, 4)), (512, 90, 128, (16, 2)),
                               (512, 77, 128, (16, 2)), (544, 13, 8, (16, 1)),
                               (1024, 77, 64, (16, 1)), (1056, 13, 8, None)):
        g2 = Geometry.make(n2, np.deg2rad(np.linspace(-76, 76, na2)))
        lv2 = _sart_levels(g2, ns2, uni(n2, n2, ns2))
        require(lv2["shape"] == want, f"K8 at {n2}^2: shape {lv2['shape']}")
        _sart_route_line(g2, ns2, lv2, joseph_nnz(g2, "cuda"), card)


def art_work(geom, ns: int, rays: int):
    """(bytes, operations) of one A1 sweep over `rays` rays: x in and out
    once, b, the order and the angle table read once; per ray and step the
    position and the two weights with their squares (12 operations), per
    ray, step and slice the dot's and the update's 8, per ray and slice the
    coefficient's 3."""
    n, na = geom.n, geom.nproj
    return (4 * (2 * n * n * ns + na * geom.nray * ns + rays) + 16 * na,
            rays * (8 * n * ns + 12 * n + 3 * ns))


def _art_orders(geom, dev) -> dict:
    """The orders phase 3 holds A1 to: angle-major, a random permutation
    (randperm, seed 0) and cuda_art.mixed_order (two angles in turns, three
    bins at a time)."""
    from tomojax_torch.solvers import cuda_art

    rays = geom.nproj * geom.nray
    perm = torch.randperm(rays, generator=torch.Generator().manual_seed(0))
    return {"angle-major": torch.arange(rays, dtype=torch.int32, device=dev),
            "random": perm.to(device=dev, dtype=torch.int32),
            "mixed": torch.from_numpy(cuda_art.mixed_order(
                geom.nproj, geom.nray)).to(dev)}


def _art_levels(geom, ns: int, uni, orders=None, slices=None,
                steps=True) -> dict:
    """A1 against its plain version, for each slices-a-block instantiation
    (`slices`, by default cuda_art.SLICES), each required: three single ray
    steps (a row-driven ray, a column-driven one, the detector's last bin)
    from random x within 1e-6 max|x| (where `steps`); one sweep in each of
    `orders` ({name: int32 order on the card}, by default `_art_orders`)
    from zero on nanocube projections within 1e-4 max|x|. Also: two sweeps
    agree bit for bit and out-of-range rays leave x. Returns the
    angle-major (or first) sweep's error and bound, the plain sweep's ms
    (host clock) and a line of text."""
    from tomojax_torch.projector.cuda_joseph import fp_sl
    from tomojax_torch.sim import nanocube_phantom
    from tomojax_torch.solvers import cuda_art, to_sl

    dev = torch.device("cuda")
    n, na, nt = geom.n, geom.nproj, geom.nray
    tag = f"A1 at {ns} x {n}^2 x {na}"
    sweep, plain = cuda_art.art_sweep_sl, cuda_art.art_sweep_sl_ref
    vol = to_sl(torch.from_numpy(nanocube_phantom(ns, n)).to(dev))
    b = fp_sl(vol, geom)
    x, x0 = uni(n, n, ns), torch.zeros_like(vol)
    orders = _art_orders(geom, dev) if orders is None else orders
    seq = torch.arange(na * nt, dtype=torch.int32, device=dev)
    rays = (nt // 2, (na // 2) * nt + nt // 3, nt - 1) if steps else ()
    one_steps = [(seq[r:r + 1], plain(x, b, geom, 1.0, seq[r:r + 1]))
                 for r in rays]
    refs = {}
    for name, order in orders.items():
        t0 = time.perf_counter()
        refs[name] = plain(x0, b, geom, 1.0, order)
        torch.cuda.synchronize()
        refs[name] = (refs[name], 1e3 * (time.perf_counter() - t0),
                      1e-4 * float(refs[name].abs().max()))
    first = next(iter(orders))
    skip = torch.tensor([na * nt, -1], dtype=torch.int32, device=dev)
    out = {"plain_ms": refs[first][1], "tol": refs[first][2], "b": b,
           "x0": x0, "seq": seq}
    texts = []
    for sl in cuda_art.SLICES if slices is None else slices:
        step_err = step_tol = 0.0
        for one, want in one_steps:
            got = _launched(sweep, lambda: sweep(x, b, geom, 1.0, one, sl))
            err, tol = max_err(got, want), 1e-6 * float(want.abs().max())
            require(err <= tol, f"{tag} ({sl} slices a block), ray "
                                f"{int(one)}: error {err:.3e} above "
                                f"{tol:.3e}")
            step_err, step_tol = max(step_err, err), max(step_tol, tol)
        require(torch.equal(sweep(x, b, geom, 1.0, skip, sl), x),
                f"{tag} ({sl} slices a block): out-of-range rays changed x")
        errs = []
        for name, order in orders.items():
            ref, _, tol = refs[name]
            got = _launched(sweep, lambda: sweep(x0, b, geom, 1.0, order,
                                                 sl))
            err = max_err(got, ref)
            require(err <= tol, f"{tag} ({sl} slices a block), one {name} "
                                f"sweep: error {err:.3e} above {tol:.3e}")
            require(torch.equal(sweep(x0, b, geom, 1.0, order, sl), got),
                    f"{tag} ({sl} slices a block, {name}): two sweeps "
                    f"differ")
            if name == first and sl == cuda_art.art_slices(n):
                out["err"] = err
            errs.append(f"{name} {err:.2e} <= {tol:.2e}")
        texts.append(f"{sl} slices a block: "
                     + (f"one ray step {step_err:.2e} <= {step_tol:.2e} "
                        f"(1e-6 max|x|), " if one_steps else "")
                     + "one sweep from zero " + ", ".join(errs)
                     + " (1e-4 max|x|)")
    out["text"] = (f"{tag} against the plain version on nanocube "
                   f"projections: " + "; ".join(texts) + "; two sweeps "
                   f"identical; out-of-range rays leave x; plain sweep "
                   f"({first}) {out['plain_ms']:.0f} ms")
    return out


def _three_angle_order(geom, dev):
    """The rays of three angles of `geom`, angle-major: the one nearest 0
    degrees (row-driven), the one nearest 45 degrees and the last one."""
    deg = np.rad2deg(geom.angles)
    picks = (int(np.argmin(np.abs(deg))), int(np.argmin(np.abs(deg - 45))),
             geom.nproj - 1)
    nt = geom.nray
    return torch.cat([torch.arange(a * nt, (a + 1) * nt, dtype=torch.int32)
                      for a in picks]).to(dev), [float(deg[a]) for a in picks]


ART_WIDE = ((128, 512), (64, 1024))  # (Ns, N) at 90 angles


def _check_art(geom, uni, report, card: str) -> None:
    """A1 (the ART sweep) against its plain version (_art_levels) at 256^3
    x 90 (a plain sweep, 23,040 rays of about 15 PyTorch launches each,
    takes 4-5 s on the H100) and at N 33, Na 7, Ns 5, each in the three
    orders of `_art_orders`; at 128 x 512^2 and 64 x 1024^2 x 90 (+-76
    degrees with the angle nearest 45 set to 45) over the rays of three
    angles (`_three_angle_order`) in each instantiation that takes N; then
    A1's times at 256^3 x 90 (`art_times`: every slices-a-block
    instantiation angle-major and random, and the split of a ray by the
    kernel's variants) beside its bound and the traffic of re-reading each
    ray's pixels from device memory (16 N Ns bytes a ray)."""
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.solvers import cuda_art

    small = Geometry.make(33, np.deg2rad(np.linspace(-76, 76, 7)))
    print(_art_levels(small, 5, uni)["text"])
    n, na, ns = geom.n, geom.nproj, 256
    lv = _art_levels(geom, ns, uni)
    print(lv["text"])
    for ns_w, n_w in ART_WIDE:
        deg = np.linspace(-76, 76, na)
        deg[np.argmin(np.abs(deg - 45))] = 45.0
        wide = Geometry.make(n_w, np.deg2rad(deg))
        order, picks = _three_angle_order(wide, torch.device("cuda"))
        fits = tuple(sl for sl in cuda_art.SLICES
                     if cuda_art.art_max_n(sl) >= n_w)
        text = _art_levels(wide, ns_w, uni, {"three-angle": order}, fits,
                           steps=False)["text"]
        print(f"{text} (angles {', '.join(f'{a:.3f}' for a in picks)} "
              f"deg)")
    rays = na * geom.nray
    times = art_times(geom, ns, card, "this tree")
    bound_ms, bound_by = bound(*art_work(geom, ns, rays))
    traffic_ms = 1e3 * 16 * n * ns * rays / HBM_BYTES_PER_S
    sl = str(cuda_art.ART_SLICES)
    print(f"A1 at {ns} x {n}^2 x {na}: bound {bound_ms:.4f} ms ({bound_by})"
          f"; each ray's 2N pixels from device memory {traffic_ms:.2f} ms; "
          f"chain bound (the CHAIN variant: the rays' chain without x's "
          f"traffic, {sl} slices a block) {times[sl]['CHAIN']:.3f} ms = "
          f"{1e3 * times[sl]['CHAIN'] / rays:.4f} us a ray [{card}]")
    report("A1_art_sweep", lv["err"], lv["tol"],
           times[str(cuda_art.ART_SLICES)]["FULL"], lv["plain_ms"],
           f" ({cuda_art.ART_SLICES} slices a block, angle-major; plain ms "
           f"one sweep, host clock)", work=art_work(geom, ns, rays))


SLABS = 4  # phase 3's emulated ranks: 256^3 as 4 slabs of 64 slices


def _slabs(x: torch.Tensor):
    n = x.shape[2] // SLABS
    return [x[:, :, i * n:(i + 1) * n].contiguous() for i in range(SLABS)]


def _first(t):
    return t[:, :, 0].contiguous()


def _last(t):
    return t[:, :, -1].contiguous()


def _held_halo(what: str, slab, p, lo, hi, lo_x, hi_x, x_old, beta):
    """K9a, K9b, K9c and K5's right halo on one (n0, n1, n_loc) slab with
    the given halo planes against their plain versions, at phase 3's
    bounds: K9a 2^-7 (bf16 duals), K9b 1e-6 max|y|, K9c 1e-5 max|g|,
    ||g||^2 and the K5 value rtol 2e-5. Returns (K9a err, K9b err, its
    bound, K9c err, its bound, ||g||^2 rel, K5 rel)."""
    from tomojax_torch.tv import cuda_tv_value
    from tomojax_torch.tv import cuda_fgp_sharded as fs
    from tomojax_torch.tv import cuda_tvgd_sharded as gs

    got = _launched(fs.fgp_iter_halo,
                    lambda: fs.fgp_iter_halo(slab, *p, LAM, lo, hi))
    ref = fs.fgp_iter_halo_ref(slab, *p, LAM, lo, hi)
    e_a = max(max_err(g.float(), r.float()) for g, r in zip(got, ref))
    got = _launched(fs.fgp_obj_halo, lambda: fs.fgp_obj_halo(
        slab, *p, LAM, lo, x_old, beta))
    ref = fs.fgp_obj_halo_ref(slab, *p, LAM, lo, x_old, beta)
    e_b = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
    t_b = 1e-6 * float(ref[1].abs().max())
    g, gsq = _launched(gs.tv_grad_halo,
                       lambda: gs.tv_grad_halo(slab, lo_x, hi_x))
    g_r, gsq_r = gs.tv_grad_halo_ref(slab, lo_x, hi_x)
    e_c, t_c = max_err(g, g_r), 1e-5 * float(g_r.abs().max())
    gsq_rel = abs(float(gsq) - float(gsq_r)) / float(gsq_r)
    tv_r = float(cuda_tv_value.tv_value_ref(slab, hi_x))
    tv_rel = abs(float(_launched(cuda_tv_value.tv_value, lambda:
                                 cuda_tv_value.tv_value(slab, hi_x)))
                 - tv_r) / tv_r
    require(e_a <= 2 ** -7 and e_b <= t_b and e_c <= t_c
            and gsq_rel <= 2e-5 and tv_rel <= 2e-5,
            f"{what}: K9a {e_a:.3e} (<= 2^-7), K9b {e_b:.3e} "
            f"(<= {t_b:.3e}), K9c {e_c:.3e} (<= {t_c:.3e}), ||g||^2 rel "
            f"{gsq_rel:.3e} (<= 2e-5), K5 halo rel {tv_rel:.3e} (<= 2e-5)")
    return e_a, e_b, t_b, e_c, t_c, gsq_rel, tv_rel


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
        e_a, e_b, t_b, e_c, t_c, gsq_rel, tv_rel = _held_halo(
            f"{role} slab", slab, p, lo, hi, uni(*plane_shape),
            uni(*plane_shape), x_old, beta)
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
    from tomojax_torch.solvers import cuda_art, cuda_sart
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
             cuda_sart: ["sart_sweep_sl_ref"],
             cuda_art: ["art_sweep_sl_ref"]}
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
SIM_KERNELS = ("K1_fp", "K2_bp", "K2_bp_sirt", "A1_art_sweep",
               "K8_sart_sweep")
# the streaming runs: K1/K2 fused every sweep, unfused for each new angle
# set's System; the CS rounds also K7 and the step (K9c with a group)
STREAM_KERNELS = ("K1_fp_resid", "K1_fp", "K2_bp_sirt", "K2_bp")
STREAM_CS_KERNELS = STREAM_KERNELS + ("K7_tv_grad", "tv_step")


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


@contextlib.contextmanager
def _nccl_group(tag: str):
    """An NCCL group of world size 1 (a file store under build/), destroyed
    on leaving."""
    import torch.distributed as dist

    from tomojax_torch.dist import init_distributed

    require(dist.is_available() and dist.is_nccl_available(),
            "torch.distributed has no NCCL backend")
    store = ROOT / "build" / f"chip_smoke_{tag}_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    group = init_distributed(f"file://{store}", 1, 0, device="cuda")
    try:
        yield group
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def _traced(label: str, fn, annotated: bool = True):
    """One call of fn inside `profiling.trace` (the trace written under
    build/chip_smoke_traces/<label>/), inside `profiling.annotate(label)`
    where `annotated`, and the wall time of the call on the host clock
    after a synchronize."""
    from tomojax_torch import profiling

    with profiling.trace(str(ROOT / "build" / "chip_smoke_traces" / label)
                         ) as prof:
        t0 = time.perf_counter()
        with (profiling.annotate(label) if annotated
              else contextlib.nullcontext()):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return prof, wall_ms


def _gap_split(prof, annotations=()):
    """A profiler window's device span, busy time (the union of its device
    events) and idle time split by the host op that the main thread was
    inside while the device waited: each gap between device events is
    shared out over the outermost host ops it overlaps, by name, and the
    rest is "no op" (Python between ops). Annotation spans (`annotations`
    and user annotations) are neither work nor ops. All in ms."""
    cuda = torch.autograd.DeviceType.CUDA

    def annot(e):
        return (getattr(e, "is_user_annotation", False)
                or e.name in annotations)

    evs = [e for e in prof.events() if not annot(e)]
    busy = []
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in evs if e.device_type == cuda):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    host = [e for e in evs if e.device_type != cuda]
    if not busy or not host:
        return 0.0, 0.0, {}
    gaps = [(left[1], right[0]) for left, right in zip(busy, busy[1:])]
    main = collections.Counter(e.thread for e in host).most_common(1)[0][0]

    def outermost(e):
        q = e.cpu_parent
        while q is not None and annot(q):
            q = q.cpu_parent
        return q is None

    ends = [g[1] for g in gaps]
    split = collections.defaultdict(float)
    for e in host:
        if e.thread != main or not outermost(e):
            continue
        s, t = e.time_range.start, e.time_range.end
        i = bisect.bisect_right(ends, s)
        while i < len(gaps) and gaps[i][0] < t:
            split[e.name] += max(0.0, min(t, gaps[i][1]) - max(s, gaps[i][0]))
            i += 1
    idle = sum(b - a for a, b in gaps)
    split["no op"] = idle - sum(split.values())
    return ((busy[-1][1] - busy[0][0]) / 1e3,
            sum(b - a for a, b in busy) / 1e3,
            {k: v / 1e3 for k, v in split.items()})


def _sharded_gap_study(run, group, card: str, rounds: int = 6,
                       windows: int = 2, tries: int = 3) -> None:
    """Where the sharded ASD-POCS iteration's extra time goes, at world
    size 1; run(group or None, niter) is one asd_pocs_run call. (1) The
    spread between calls: `rounds` unprofiled calls of 5 iterations each
    way, in turn (CUDA events): min, median, max ms an iteration. (2)
    `windows` profiled one-iteration calls each way, with and without an
    `annotate` span, each after an unprofiled event time of the same call:
    the window's device span, busy and idle time, and the idle time split
    by host op (`_gap_split`); the span less the event time is what the
    profiler adds. The first annotated window each way also prints its top
    device operations, and each kind of window the split of its most idle
    one. A window whose profile holds no device event (the
    profiler can drop a window's CUDA activity) is profiled again, up to
    `tries` times, and is printed as not measured if it never holds one."""
    calls = {True: [], False: []}
    for _ in range(rounds):
        for sharded in (False, True):
            _, ms = _events_ms(lambda: run(group if sharded else None, 5))
            calls[sharded].append(ms / 5)
    rows = collections.defaultdict(list)
    tops = {}
    empty = 0
    for _ in range(windows):
        for annotated in (True, False):
            for sharded in (True, False):
                g = group if sharded else None
                _, ev_ms = _events_ms(lambda: run(g, 1))
                label = ("asd_" + ("sharded" if sharded else "unsharded")
                         + ("" if annotated else "_bare"))
                for _ in range(tries):
                    prof, wall_ms = _traced(label, lambda: run(g, 1),
                                            annotated)
                    span, busy, split = _gap_split(prof, (label,))
                    if span > 0:
                        break
                    empty += 1
                if span <= 0:
                    rows[sharded, annotated].append(None)
                    continue
                rows[sharded, annotated].append(
                    (ev_ms, wall_ms, span, busy, split))
                if annotated and sharded not in tops:
                    tops[sharded] = _profile_summary(prof, 1, (label,))
    for sharded in (True, False):
        t = sorted(calls[sharded])
        med = statistics.median(t)
        print(f"  {'sharded' if sharded else 'unsharded'} asd_pocs_run(5), "
              f"{rounds} unprofiled calls in turn: ms/iteration min "
              f"{t[0]:.3f}, median {med:.3f}, max {t[-1]:.3f}, spread "
              f"{100 * (t[-1] - t[0]) / med:.2f} % of the median [{card}]")
    for (sharded, annotated), reps in rows.items():
        got = [r for r in reps if r is not None]
        split = collections.defaultdict(float)
        for *_, sp in got:
            for k, v in sp.items():
                split[k] += v / len(got)
        top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
        print(f"  profiled one-iteration window, "
              f"{'sharded' if sharded else 'unsharded'}, "
              f"{'annotated' if annotated else 'no annotation'} "
              f"({len(reps)} windows): " + "; ".join(
                  f"not measured (no device event in {tries} profiles)"
                  if r is None else
                  f"event {r[0]:.3f} ms unprofiled, span {r[2]:.3f}, busy "
                  f"{r[3]:.3f}, idle {r[2] - r[3]:.3f} "
                  f"({100 * (1 - r[3] / r[2]):.2f} %), host wall "
                  f"{r[1]:.3f}" for r in reps)
              + "; idle ms a window by host op: " + (", ".join(
                  f"{k[:40]} {v:.3f}" for k, v in top) or "not measured"))
        if got:
            ev, _, span, busy, sp = max(got, key=lambda r: 1 - r[3] / r[2])
            print(f"    the most idle of them ({100 * (1 - busy / span):.2f}"
                  f" %, event {ev:.3f} ms unprofiled), idle ms by host op: "
                  + ", ".join(f"{k[:40]} {v:.3f}" for k, v in sorted(
                      sp.items(), key=lambda kv: -kv[1])[:6]))
    print(f"  profiles that held no device event: {empty} "
          f"(of {4 * windows} windows, each profiled up to {tries} times)")
    for sharded, summary in tops.items():
        print(f"  top device operations of one "
              f"{'sharded' if sharded else 'unsharded'} ASD-POCS iteration "
              f"(build/chip_smoke_traces/): {summary}")


def phase_sharded_path(card: str, kernels: dict, group) -> dict:
    """The slab-sharded path through an NCCL group of world size 1: one
    slab holds the whole volume, the ring halos are local copies, the chain
    ends are zeros and every scalar goes through an NCCL all-reduce. Then
    `_sharded_gap_study`: the spread between unprofiled ASD-POCS calls each
    way, and profiled one-iteration windows each way (`profiling.trace`)
    with their busy share, top device operations and idle time by host
    op."""
    from tomojax_torch import TomoTorch
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.sim import create_projections, nanocube_phantom
    from tomojax_torch.solvers import (
        AsdPocsParams, asd_pocs_run, fista_init_sl, fista_run_sl,
        make_sart_weights,
    )

    ns, n, na, iters, asd_iters = 256, 256, 90, 10, 5
    angles = np.linspace(-76, 76, na)
    dev = torch.device("cuda")
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
        _sharded_gap_study(lambda g, k: asd_pocs_run(
            x0, ref.b_sl, ref.sys, w, AsdPocsParams(niter=k), group=g),
            group, card)
    sh_m, un_m = sh_m.cpu().numpy(), un_m.cpu().numpy()

    dev_dd = _max_rel(sh_m[:, 1], un_m[:, 1])
    dev_tv = _max_rel(sh_m[:, 2], un_m[:, 2])
    dev_cost, dev_asd = _max_rel(sh_cost, un_cost), _max_rel(sh_dd,
                                                             ref.dd_vec)
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


SHARDED_FUSION_KERNELS = ("K1_fp", "K2_bp_sirt", "K2_bp", "K5_tv_value",
                          "K8_sart_sweep", "K9a_fgp_iter_halo",
                          "K9b_fgp_obj_halo", "K9c_tv_grad_halo")
FUSION_WAYS = (("host loop", {}), ("fused", {"fused": True}),
               ("sart", {"method": "sart"}))
GD_DPOCS = 0.05  # the sharded path's tv_gd_4d step


def _fusion_runs(tomo) -> dict:
    """chemical_tomography(3), then data_fusion(3) each way, each from a
    fresh chemical_tomography: {way: (costCHEM of the chemistry run,
    (costHAADF, costCHEM, costTV) of the fusion run, get_recon())}."""
    out = {}
    for name, kw in FUSION_WAYS:
        tomo.chemical_tomography(Niter=3)
        chem = tomo.costCHEM.copy()
        tomo.data_fusion(Niter=3, **kw)
        out[name] = (chem, np.stack([tomo.costHAADF, tomo.costCHEM,
                                     tomo.costTV]), tomo.get_recon())
    return out


def phase_sharded_fusion_path(card: str, kernels: dict, group) -> dict:
    """Phase 4c, second part: ChemicalTomo(group=) on phase 4d's problem
    through the same NCCL group of world size 1 (chemical_tomography(3) and
    data_fusion(3) as the host loop, fused=True and method='sart'), and
    tv_gd_4d with the group on its state, with every plain version raising;
    K9a, K9b, K5 and K9c must launch and K3, K4 must not. Each run is held
    against the unsharded ChemicalTomo on the same problem (reconstruction
    1e-6 max|x|, costs rtol 1e-5; 0.0 expected, K9a/K9b being K3/K4 at one
    rank). Then the fusion golden trace through the group, and the fusion
    outer iteration sharded and unsharded in turn (CUDA events, median of 2
    each)."""
    from tomojax_torch import ChemicalTomo
    from tomojax_torch.tv import tv_gd_4d

    dev = torch.device("cuda")
    gt, haadf, chem, ha, ca = _fusion_problem(dev)
    _reset(kernels)
    with plain_versions_forbidden():
        sh = ChemicalTomo(haadf, ha, chem, ca, group=group)
        sh_runs = _fusion_runs(sh)
        x = sh.x
        sh_gd, sh_gd_tv = tv_gd_4d(x, 10, GD_DPOCS, group=group)
        torch.cuda.synchronize()
    counts = _read(kernels, "sharded fusion path (NCCL, world size 1)",
                   SHARDED_FUSION_KERNELS)
    require(counts["K3_fgp_iter"] == 0 and counts["K4_fgp_obj_mom"] == 0,
            f"sharded fusion path launched K3 {counts['K3_fgp_iter']} and "
            f"K4 {counts['K4_fgp_obj_mom']} times (K9a/K9b expected)")
    with plain_versions_forbidden():
        un_runs = _fusion_runs(ChemicalTomo(haadf, ha, chem, ca))
        un_gd, un_gd_tv = tv_gd_4d(x, 10, GD_DPOCS)
    rmse = sh.rmse_per_element(gt.cpu().numpy())
    devs = []
    for name, _ in FUSION_WAYS:
        (sc, sm, sx), (uc, um, ux) = sh_runs[name], un_runs[name]
        require(sx.shape == ux.shape and bool(np.isfinite(sx).all()),
                f"sharded ChemicalTomo ({name}): recon not finite or of "
                f"shape {sx.shape}")
        err, tol = float(np.abs(sx - ux).max()), 1e-6 * float(
            np.abs(ux).max())
        rel = max(_max_rel(sc, uc), _max_rel(sm, um))
        require(err <= tol and rel <= 1e-5,
                f"sharded ChemicalTomo ({name}) vs unsharded: recon "
                f"{err:.3e} (bound {tol:.3e}), costs rel {rel:.3e} (1e-5)")
        devs.append(f"{name} recon {err:.2e} <= {tol:.2e}, costs rel "
                    f"{rel:.2e}")
    err = float((sh_gd - un_gd).abs().max())
    tol = 1e-6 * float(un_gd.abs().max())
    rel = abs(float(sh_gd_tv) - float(un_gd_tv)) / abs(float(un_gd_tv))
    require(err <= tol and rel <= 1e-5,
            f"sharded tv_gd_4d vs unsharded: {err:.3e} (bound {tol:.3e}), "
            f"tv rel {rel:.3e} (1e-5)")
    print(f"sharded fusion path {tuple(gt.shape)}, HAADF {len(ha)} / "
          f"chemistry {len(ca)} angles, NCCL group of world size 1: "
          f"ChemicalTomo(group=) vs unsharded: " + "; ".join(devs)
          + f"; tv_gd_4d(10) {err:.2e} <= {tol:.2e}, tv rel {rel:.2e}; "
          f"rmse per element {np.array2string(rmse, precision=4)} [{card}]")
    _check_fusion_halo_kernels(sh.x.contiguous(), card)
    phase_golden_fusion(card, group)
    _time_fusion_outer_sharded(card, group)
    return counts


def _check_fusion_halo_kernels(x: torch.Tensor, card: str) -> None:
    """The halo modes that the sharded fusion path gives its kernels, on its
    final state x (Nel, N, N, n_loc), with random halo planes (at world
    size 1 the path's own halos are copies of x's first slices, which the
    periodic wrap reads anyway): K5 on the whole stack with an (Nel, N, N)
    right halo, one launch, against tv_value_ref (rtol 2e-5); K9a, K9b, K9c
    on element 0's (N, N, n_loc) slab, bf16 duals, as an interior rank
    (both halos) and as the path's top of a chain (zero P3 plane below, no
    right halo), against their plain versions at phase 3's bounds."""
    from tomojax_torch.tv import cuda_tv_value

    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(14)

    def uni(*shape, lo=0.0):
        return torch.rand(shape, generator=gen, device=dev) + lo

    hi_all = uni(*x.shape[:-1])
    tv_r = float(cuda_tv_value.tv_value_ref(x, hi_all))
    tv_rel = abs(float(_launched(cuda_tv_value.tv_value, lambda:
                                 cuda_tv_value.tv_value(x, hi_all)))
                 - tv_r) / tv_r
    require(tv_rel <= 2e-5, f"K5 on the {tuple(x.shape)} fusion state with "
                            f"a random right halo: rel {tv_rel:.3e} (2e-5)")
    slab = x[0].contiguous()
    plane = slab.shape[:2]
    p = tuple(uni(*slab.shape, lo=-0.5).bfloat16() for _ in range(3))
    x_old, beta = uni(*slab.shape), torch.tensor(0.3, device=dev)
    lo = uni(*plane, lo=-0.5).bfloat16()
    hi = (uni(*plane), *(uni(*plane, lo=-0.5).bfloat16() for _ in range(3)))
    zero = torch.zeros(plane, dtype=torch.bfloat16, device=dev)
    rows = [(role, _held_halo(f"fusion slab {tuple(slab.shape)}, {role}",
                              slab, p, lo_, hi_, uni(*plane), uni(*plane),
                              x_old, beta))
            for role, lo_, hi_ in (("interior", lo, hi), ("top", zero, None))]
    print(f"  the fusion state's halo modes, random halo planes: K5 on "
          f"{tuple(x.shape)} with an {tuple(hi_all.shape)} right halo rel "
          f"{tv_rel:.2e} (<= 2e-5); on element 0's {tuple(slab.shape)} slab "
          + "; ".join(f"{role}: K9a {v[0]:.2e} (<= 2^-7), K9b {v[1]:.2e} "
                      f"(<= {v[2]:.2e}), K9c {v[3]:.2e} (<= {v[4]:.2e}), "
                      f"||g||^2 rel {v[5]:.2e}, K5 halo rel {v[6]:.2e}"
                      for role, v in rows) + f" [{card}]")


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
    x, outer = _fusion_outer(nel, ns, n, na, nac)
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


def _fusion_outer(nel=3, ns=128, n=256, na=90, nac=45, group=None):
    """bench.py's fusion problem on the card (random x, bh, bc from
    default_rng(0), drawn as bench.py draws them: float64, then float32;
    weights ones, gamma 1.6) and its outer iteration (lam_HAADF 10, lam_chem
    0.05, iterSIRT 5, then tvIter 5 FGP iterations at lam_TV 1e-4), with
    the group passed on: (x, outer)."""
    from tomojax_torch.fusion import data_fusion_step, make_fusion_system
    from tomojax_torch.solvers import to_sl
    from tomojax_torch.tv import tv_fgp_4d

    dev = torch.device("cuda")
    fsys = make_fusion_system(n, np.deg2rad(np.linspace(-76, 76, na)),
                              np.deg2rad(np.linspace(-76, 76, nac)),
                              np.ones(nel, np.float32), 1.6, dev)
    rng = np.random.default_rng(0)

    def draw(*shape):
        return to_sl(torch.from_numpy(
            rng.random(shape).astype(np.float32)).to(dev))

    x, bh, bc = draw(nel, ns, n, n), draw(ns, na, n), draw(nel, ns, nac, n)

    def outer(v, g=group):
        v, _, _ = data_fusion_step(v, bh, bc, fsys, 10.0, 0.05, 5, group=g)
        return tv_fgp_4d(v, 5, 1e-4, group=g)[0]

    return x, outer


def _time_fusion_outer_sharded(card: str, group, iters=5) -> None:
    """The fusion outer iteration with the group and without, in turn
    (unsharded, sharded, sharded, unsharded), each over `iters` chained
    iterations by CUDA events; median of 2 each."""
    x, outer = _fusion_outer()
    times = {True: [], False: []}
    with plain_versions_forbidden():
        outer(x, group)  # warm-up
        for sharded in (False, True, True, False):
            g = group if sharded else None
            v, ms = _events_ms(lambda: _chain(lambda u: outer(u, g), x,
                                              iters))
            require(bool(torch.isfinite(v).all()),
                    "sharded fusion outer iteration is not finite")
            times[sharded].append(ms / iters)
    sh, un = statistics.median(times[True]), statistics.median(times[False])
    print(f"  fusion outer iteration 3x128x256^2, HAADF 90 / chemistry 45: "
          f"sharded {sh:.3f} ms/iteration, unsharded {un:.3f} "
          f"(+{100 * (sh / un - 1):.2f} %); median of 2 runs of {iters} "
          f"iterations each, in turn [{card}]")


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


def _profile_summary(prof, iters: int, annotations=()) -> str:
    """Device ms per iteration by kernel name (the 12 largest), the total,
    and the idle share of the device window (1 - busy / first start to
    last end). The device-side spans of annotated regions (`annotations`,
    or marked as user annotations) are not work and are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)
           and e.name not in annotations]
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs)) if evs else 0
    if span <= 0:
        return "not measured (no device events)"
    by = {}
    for e in evs:
        by[e.name] = by.get(e.name, 0.0) + (e.time_range.end
                                            - e.time_range.start)
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:12]
    return (f"device busy {busy / iters / 1e3:.4f} ms/iteration of a "
            f"{span / iters / 1e3:.4f} ms window, idle share "
            f"{100 * (1 - busy / span):.2f} % (busy share "
            f"{100 * busy / span:.2f} %); " + "; ".join(
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


SIM_SHAPE = (256, 256, 90)  # (Ns, N, Na): bench.py's problem
SIM_SNR = 200  # the count level of examples/demo.py
PYTVLIB_SLICES = 64


def phase_sim_path(card: str, kernels: dict) -> dict:
    """Phase 4g: the simulation study of examples/demo.py and sim_tomo.py
    at bench.py's shape (nanocube seed 0, +-76 degrees, snr 200): the
    Simulator's set-up (K1, then the host's Poisson draw), then wbp
    (ram-lak, hann), cgls(30), art(1) angle-major and random, sirt(10),
    each called twice and timed by CUDA events, with its rmse against the
    background-filled phantom; then pytvlib.run over every alias at 64
    slices. The launch
    counts are set to 0 before and read after; every plain version
    raises."""
    from tomojax_torch import Simulator, ops, pytvlib
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector.cuda_joseph import fp_sl
    from tomojax_torch.sim import nanocube_phantom

    ns, n, na = SIM_SHAPE
    angles = np.linspace(-76, 76, na)
    dev = torch.device("cuda")
    vol = nanocube_phantom(ns, n)
    _reset(kernels)
    with plain_versions_forbidden():
        filled = torch.from_numpy(np.where(vol == 0, np.float32(1.0), vol))
        vol_sl = filled.to(dev).permute(1, 2, 0).contiguous()
        geom = Geometry.make(n, np.deg2rad(angles))
        b_sl, k1_ms = _events_ms(lambda: fp_sl(vol_sl, geom))
        t0 = time.perf_counter()
        ops.poisson_noise(b_sl, SIM_SNR, 0)
        poisson_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        sim = Simulator(vol, angles, snr=SIM_SNR)
        torch.cuda.synchronize()
        setup_ms = 1e3 * (time.perf_counter() - t0)
        zero_rmse = sim.rmse()
        runs = {}
        for name, call in (
                ("wbp ram-lak", lambda: sim.wbp()),
                ("wbp hann", lambda: sim.wbp("hann")),
                ("cgls(30)", lambda: sim.cgls(30)),
                ("art(1)", lambda: sim.art(1)),
                ("art(1, random_order)", lambda: sim.art(1,
                                                         random_order=True)),
                ("sirt(10)", lambda: sim.sirt(10))):
            _, cold = _events_ms(call)  # the first call (plans, tables)
            _, ms = _events_ms(call)
            x = sim.x
            require(tuple(x.shape) == (ns, n, n)
                    and bool(torch.isfinite(x).all()),
                    f"Simulator.{name}: not finite or of the wrong shape")
            runs[name] = (ms, cold, sim.rmse())
        small = Simulator(nanocube_phantom(PYTVLIB_SLICES, n), angles,
                          snr=SIM_SNR)
        aliases = {}
        for alias in sorted(pytvlib._ALG_ALIASES):
            pytvlib.initialize_algorithm(small, alias)
            _, ms = _events_ms(lambda: pytvlib.run(small, alias, niter=2))
            require(bool(torch.isfinite(small.x).all()),
                    f"pytvlib.run({alias!r}) is not finite")
            aliases[alias] = (ms, small.rmse())
    counts = _read(kernels, "simulation-study path", SIM_KERNELS)
    print(f"simulation-study path {ns}x{n}^2x{na} +-76 deg, nanocube seed "
          f"0, snr {SIM_SNR}: Simulator set-up {setup_ms:.1f} ms wall (K1 "
          f"{k1_ms:.3f} ms by events, host Poisson draw {poisson_ms:.1f} ms)"
          f"; rmse of x = 0 {zero_rmse:.6f} [{card}]")
    for name, (ms, cold, rmse) in runs.items():
        # the iterative solvers must come closer to the phantom than x = 0;
        # FBP of noisy, limited-angle data need not
        require(name.startswith("wbp") or rmse < zero_rmse,
                f"Simulator.{name}: rmse {rmse:.6f} not below x = 0's "
                f"{zero_rmse:.6f}")
        print(f"  {name}: {ms:.3f} ms (CUDA events, the second call; "
              f"first {cold:.3f}), rmse {rmse:.6f}")
    print(f"  pytvlib.run at {PYTVLIB_SLICES} slices, niter 2 (ms by CUDA "
          f"events, rmse): " + "; ".join(
              f"{a} {ms:.3f} / {r:.6f}" for a, (ms, r) in aliases.items()))
    return counts


STREAM_SHAPE = (256, 256, 90)  # (Ns, N, Na): phase 4a's problem
STREAM_PER_POLL, STREAM_ITERS, STREAM_BUCKET = 8, 10, 8
STREAM_SMALL = (8, 64, 30, 4)  # (Ns, N, Na, arrivals): kernels vs plain
FEW_ANGLES = ((0.0,), (0.0, 45.0), (0.0, 7.5, -7.5))  # N 64, Ns 8


class _Reveal:
    """A TiltWatcher list_fn revealing `per_poll` more of `paths` (in
    acquisition order) at each call."""

    def __init__(self, paths, per_poll: int):
        self.paths, self.per_poll, self.shown = paths, per_poll, 0

    def __call__(self):
        self.shown = min(self.shown + self.per_poll, len(self.paths))
        return self.paths[:self.shown]


def _stream_files(ns: int, n: int, angles):
    """The nanocube phantom (seed 0) on the card, projected with K1, and
    its projections written as proj_<angle>.npy (Ns, Nt) into a fresh
    directory under build/. Returns (phantom, paths in acquisition
    order, the projections (Ns, Na, Nt) on the host)."""
    import shutil

    from tomojax_torch.geometry import Geometry
    from tomojax_torch.sim import create_projections, nanocube_phantom

    vol = torch.from_numpy(nanocube_phantom(ns, n)).to("cuda")
    b = create_projections(vol, Geometry.make(n, np.deg2rad(angles)))
    b = b.cpu().numpy()  # (Ns, Na, Nt)
    d = ROOT / "build" / f"chip_smoke_stream_{os.getpid()}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    paths = []
    for i, a in enumerate(angles):
        paths.append(str(d / f"proj_{float(a)!r}.npy"))
        np.save(paths[-1], np.ascontiguousarray(b[:, i, :]))
    return vol, paths, b


def _stream_schedule(device, alg: str, b, angles, arrivals: int,
                     iters: int, group=None):
    """The streaming schedule without files: the angles in `arrivals`
    batches, `iters` iterations of `alg` after each."""
    from tomojax_torch.stream import DynamicReconstructor

    rec = DynamicReconstructor(b.shape[2], len(angles), STREAM_BUCKET,
                               alg=alg, device=device, group=group)
    edges = np.linspace(0, len(angles), arrivals + 1).round().astype(int)
    for lo, hi in zip(edges[:-1], edges[1:]):
        rec.add_projections([(float(angles[i]), b[:, i])
                             for i in range(lo, hi)])
        (rec.iterate_cs if alg == "cs" else rec.iterate)(iters)
    return rec


def _check_stream_small(card: str) -> None:
    """The streaming schedule at 8 x 64^2 x 30 angles (4 arrivals, 10
    iterations each) on the card and on the CPU (plain versions).

    SIRT: the dd histories at rtol 1e-5, the volume within 1e-5 max|x|.
    CS: the rounds' adaptive TV steps amplify last-digit differences (a
    one-ulp change of the data moves the plain run's dd history by up to
    12 % here and changes its decay iterations), so the card takes every
    iteration from the plain run's state (x and dPOCS): each dd at rtol
    1e-3 (the ASD-POCS bound), each dPOCS after the decision at rtol 1e-5
    (the same decay iterations); the free-running trajectories' distance
    is printed, not held. Then the defect guard: after iterate_cs,
    iterate equals a fresh reconstructor's given the same x (which must
    seed its residual), bit for bit."""
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.sim import create_projections, nanocube_phantom
    from tomojax_torch.stream import DynamicReconstructor

    ns, n, na, arrivals = STREAM_SMALL
    angles = np.linspace(-76, 76, na)
    vol = torch.from_numpy(nanocube_phantom(ns, n))
    b = create_projections(vol, Geometry.make(n, np.deg2rad(angles)))
    b = b.numpy()

    def rel(a, b_):
        a, b_ = np.asarray(a), np.asarray(b_)
        return float(np.max(np.abs(a - b_) / np.abs(b_)))

    out = []
    for alg in ("sirt", "cs"):
        card_rec, cpu_rec = (_stream_schedule(dev, alg, b, angles, arrivals,
                                              STREAM_ITERS)
                             for dev in ("cuda", "cpu"))
        dev_dd = rel(card_rec.dd_history, cpu_rec.dd_history)
        x_k, x_p = card_rec.get_recon(), cpu_rec.get_recon()
        dev_x = float(np.abs(x_k - x_p).max() / np.abs(x_p).max())
        if alg == "sirt":
            require(dev_dd <= 1e-5 and dev_x <= 1e-5,
                    f"streaming SIRT at {ns} x {n}^2 x {na}: dd rel "
                    f"{dev_dd:.3e}, x {dev_x:.3e} max|x| (bounds 1e-5)")
            out.append(f"SIRT dd rel {dev_dd:.2e}, x {dev_x:.2e} max|x| "
                       f"(<= 1e-5)")
        else:
            out.append(f"CS free-running dd rel {dev_dd:.2e}, x "
                       f"{dev_x:.2e} max|x| (not held)")
    card_rec, cpu_rec = (DynamicReconstructor(n, na, STREAM_BUCKET,
                                              alg="cs", device=dev)
                         for dev in ("cuda", "cpu"))
    edges = np.linspace(0, na, arrivals + 1).round().astype(int)
    dd_k, dd_p, dpocs_k, dpocs_p = [], [], [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        new = [(float(angles[i]), b[:, i]) for i in range(lo, hi)]
        card_rec.add_projections(new)
        cpu_rec.add_projections(new)
        for _ in range(STREAM_ITERS):
            card_rec.x = cpu_rec.x
            card_rec._dpocs = cpu_rec._dpocs
            dd_k.append(card_rec.iterate_cs(1))
            dd_p.append(cpu_rec.iterate_cs(1))
            dpocs_k.append(card_rec._dpocs)
            dpocs_p.append(cpu_rec._dpocs)
    dev_dd, dev_dpocs = rel(dd_k, dd_p), rel(dpocs_k, dpocs_p)
    require(dev_dd <= 1e-3 and dev_dpocs <= 1e-5,
            f"streaming CS iterations from the plain run's states: dd rel "
            f"{dev_dd:.3e} (bound 1e-3), dPOCS rel {dev_dpocs:.3e} (1e-5)")
    out.append(f"CS {len(dd_k)} iterations from the plain run's states: dd "
               f"rel {dev_dd:.2e} <= 1e-3, dPOCS rel {dev_dpocs:.2e} <= "
               f"1e-5")
    # the defect guard, on the card with the plain versions forbidden
    with plain_versions_forbidden():
        rec = _stream_schedule("cuda", "cs", b, angles, arrivals, 3)
        fresh = DynamicReconstructor(n, na, STREAM_BUCKET, device="cuda")
        fresh.add_projections(list(zip(rec.angles, rec.projections)))
        fresh.x = rec.x.clone()
        dd_rec, dd_fresh = rec.iterate(5), fresh.iterate(5)
    require(dd_rec == dd_fresh and torch.equal(rec.x, fresh.x),
            f"iterate after iterate_cs ({dd_rec}) differs from a fresh "
            f"reconstructor's on the same x ({dd_fresh})")
    print(f"streaming at {ns} x {n}^2 x {na} in {arrivals} arrivals, card "
          f"vs plain: " + "; ".join(out) + f"; iterate after iterate_cs "
          f"equals a fresh reconstructor's (dd {dd_rec:.6f}) [{card}]")


def _check_few_angles(card: str) -> None:
    """K1 (both epilogues) and K2 (both) at 1, 2 and 3 angles, N 64, Ns
    8, against their plain versions with phase 3's bounds."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def uni(*shape, lo=0.0, hi=1.0):
        return (torch.rand(shape, generator=gen, device="cuda") * (hi - lo)
                + lo)

    for angles in FEW_ANGLES:
        _check_projector_shape(64, 8, angles, uni)


def phase_stream_path(card: str, kernels: dict) -> dict:
    """Phase 4h: streaming acquisition at phase 4a's 256 x 256^2 x 90
    (nanocube seed 0, +-76 deg): the projections as files under build/, a
    TiltWatcher revealing 8 new files a poll (the acquisition order; each
    poll yields them sorted by name), DynamicReconstructor.run with
    iters_per_round 10, once masked SIRT and once the CS rounds, each with
    the launch counts set to 0 before and read after and every plain
    version raising; dd must fall over the last three rounds and the rmse
    against the phantom end below x = 0's. Then the times (CUDA events;
    set-up and polls by the host clock after a synchronize), the sorted
    against the arrival order, a profiler window of a SIRT and of a CS
    round, the same runs through an NCCL group of
    world size 1 (the unsharded dd at rtol 1e-5; K9c must launch; the
    slab saved and loaded bit for bit), and the checks at small size."""
    from tomojax_torch import TomoTorch, ops
    from tomojax_torch import io as tio
    from tomojax_torch.stream import DynamicReconstructor, TiltWatcher

    ns, n, na = STREAM_SHAPE
    acq = np.linspace(-76, 76, na)
    vol, paths, b = _stream_files(ns, n, acq)
    zero_rmse = float(ops.rmse(torch.zeros_like(vol), vol))

    def run(alg, group=None):
        watcher = TiltWatcher(str(Path(paths[0]).parent), preprocess=False,
                              list_fn=_Reveal(paths, STREAM_PER_POLL))
        rec = DynamicReconstructor(
            nray=n, max_angles=na, angle_bucket=STREAM_BUCKET, alg=alg,
            device=None if group is None else None, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.run(watcher, iters_per_round=STREAM_ITERS, expected_angles=na)
        torch.cuda.synchronize()
        return rec, time.perf_counter() - t0

    recs, walls, counts = {}, {}, {}
    for alg, required in (("sirt", STREAM_KERNELS),
                          ("cs", STREAM_CS_KERNELS)):
        _reset(kernels)
        with plain_versions_forbidden():
            recs[alg], walls[alg] = run(alg)
        counts[alg] = _read(kernels, f"streaming {alg} path", required)
        dd = recs[alg].dd_history
        rmse = float(ops.rmse(recs[alg].x, vol))
        require(len(recs[alg].angles) == na and bool(np.isfinite(dd).all())
                and dd[-3] > dd[-2] > dd[-1],
                f"streaming {alg}: dd does not fall over the last three "
                f"rounds: {dd}")
        require(rmse < zero_rmse, f"streaming {alg}: rmse {rmse:.6f} not "
                                  f"below x = 0's {zero_rmse:.6f}")
        print(f"streaming {alg} path {ns}x{n}^2x{na} +-76 deg, "
              f"{STREAM_PER_POLL} files a poll, {STREAM_ITERS} iterations "
              f"a round: run {walls[alg]:.3f} s wall, {len(dd)} rounds, dd "
              f"{dd[0]:.2f} -> {dd[-1]:.2f}, rmse {rmse:.6f} (x = 0: "
              f"{zero_rmse:.6f}) [{card}]")
    sirt, cs = recs["sirt"], recs["cs"]
    with plain_versions_forbidden():
        _, sirt_ms = _events_ms(lambda: sirt.iterate(STREAM_ITERS))
        _, cs_ms = _events_ms(lambda: cs.iterate_cs(STREAM_ITERS))
        prof_sirt = _profiled(lambda: sirt.iterate(STREAM_ITERS))
        prof_cs = _profiled(lambda: cs.iterate_cs(STREAM_ITERS))
        tomo = TomoTorch(acq, b.transpose(0, 2, 1))  # phase 4g's sirt
        tomo.sirt(1)
        _, tomo_ms = _events_ms(lambda: tomo.sirt(STREAM_ITERS))
        # the 90 angles in arrival order against sorted, in turns
        arrival = list(zip(sirt.angles, sirt.projections))
        order = {"arrival": arrival, "sorted": sorted(arrival,
                                                      key=lambda p: p[0])}
        times = {"arrival": [], "sorted": []}
        for key in ("arrival", "sorted", "sorted", "arrival"):
            rec = DynamicReconstructor(n, na, STREAM_BUCKET)
            rec.add_projections(order[key])
            rec.iterate(1)
            times[key].append(_events_ms(
                lambda: rec.iterate(STREAM_ITERS))[1] / STREAM_ITERS)
        # set-up per new angle set and the host's poll of 8 files
        rec = DynamicReconstructor(n, na, STREAM_BUCKET)
        watcher = TiltWatcher(str(Path(paths[0]).parent), preprocess=False,
                              list_fn=_Reveal(paths, STREAM_PER_POLL))
        setup_ms, poll_ms = [], []
        while len(rec.angles) < na:
            t0 = time.perf_counter()
            new = watcher.poll()
            poll_ms.append(1e3 * (time.perf_counter() - t0))
            rec.add_projections(new)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec._system()
            torch.cuda.synchronize()
            setup_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"  masked SIRT {sirt_ms / STREAM_ITERS:.4f} ms a sweep at {na} "
          f"angles over {STREAM_ITERS} sweeps (CUDA events, one dd read; "
          f"TomoTorch.sirt {tomo_ms / STREAM_ITERS:.4f} with a data "
          f"distance a sweep, as phase 4g runs it); CS {cs_ms / STREAM_ITERS:.4f} ms an "
          f"iteration, {cs_ms:.3f} ms a round of {STREAM_ITERS} (one host "
          f"read an iteration); arrival order "
          f"{statistics.mean(times['arrival']):.4f} ms a sweep, sorted "
          f"{statistics.mean(times['sorted']):.4f} (each the mean of 2, in "
          f"turns); set-up per new angle set {statistics.mean(setup_ms):.3f}"
          f" ms mean, {max(setup_ms):.3f} max over {len(setup_ms)} "
          f"(System and the copy of 8 projections); a poll of "
          f"{STREAM_PER_POLL} files {statistics.mean(poll_ms):.3f} ms host "
          f"[{card}]")
    print(f"  profile of a SIRT round ({STREAM_ITERS} sweeps): "
          + _profile_summary(prof_sirt, STREAM_ITERS))
    print(f"  profile of a CS round ({STREAM_ITERS} iterations): "
          + _profile_summary(prof_cs, STREAM_ITERS))
    # the same runs through an NCCL group of world size 1
    with _nccl_group("stream") as group:
        sh = {}
        for alg, required in (("sirt", STREAM_KERNELS),
                              ("cs", STREAM_CS_KERNELS[:-2]
                               + ("K9c_tv_grad_halo", "tv_step"))):
            _reset(kernels)
            with plain_versions_forbidden():
                sh[alg], _ = run(alg, group)
            counts["sharded " + alg] = _read(
                kernels, f"streaming {alg} path (NCCL, world size 1)",
                required)
            want = np.asarray(recs[alg].dd_history[:len(sh[alg].dd_history)])
            dev = float(np.max(np.abs(np.asarray(sh[alg].dd_history) - want)
                               / want))
            require(dev <= 1e-5, f"sharded streaming {alg}: dd rel "
                                 f"{dev:.3e} against unsharded (rtol 1e-5)")
            print(f"  sharded streaming {alg} (NCCL, world size 1): dd rel "
                  f"{dev:.2e} <= 1e-5 against the unsharded run")
        d = ROOT / "build" / f"chip_smoke_shards_{os.getpid()}"
        x = sh["sirt"].x
        tio.save_sharded(str(d), {"x": x}, group)
        back = tio.load_sharded(str(d), group)["x"]
        require(back.device == x.device and torch.equal(back, x),
                "save_sharded / load_sharded of a CUDA slab is not exact")
    print(f"  save_sharded / load_sharded of the {tuple(x.shape)} CUDA slab: "
          f"bit for bit")
    _check_stream_small(card)
    _check_few_angles(card)
    return {name: sum(c[name] for c in counts.values()) for name in kernels}


EXTRAS_SHAPE = (128, 256)  # (Ns, N): a fusion element's volume
EXTRAS_CHECK_SHAPE = (16, 64)  # the card against the CPU
EXTRAS_CALLS = (("tv_chambolle(20)", "tv_chambolle", {"n_iter": 20}),
                ("tv_split_bregman(10)", "tv_split_bregman", {"n_iter": 10}))


def _noisy(ns: int, n: int) -> torch.Tensor:
    """A nanocube (seed 0) with Gaussian noise 0.2 from default_rng(0),
    slice-last, on the host."""
    from tomojax_torch.sim import nanocube_phantom

    vol = nanocube_phantom(ns, n)
    noisy = vol + 0.2 * np.random.default_rng(0).standard_normal(
        vol.shape).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(noisy.transpose(1, 2, 0)))


def phase_extras(card: str, kernels: dict) -> dict:
    """Phase 4i: tv.extras on the card, once each on a noisy 128 x 256^2
    nanocube, timed by CUDA events: finite, and the TV value (K5) within
    rtol 2e-5 of its plain version on the card. Then the same calls on a
    16 x 64^2 nanocube on the card against the CPU (the volume within 1e-5
    max|d|, the TV value within rtol 2e-5): the extras are plain PyTorch,
    so the card and the CPU run the same expressions."""
    from tomojax_torch.tv import extras
    from tomojax_torch.tv.cuda_tv_value import tv_value_ref

    ns, n = EXTRAS_SHAPE
    x = _noisy(ns, n).cuda()
    _reset(kernels)
    runs = {}
    with plain_versions_forbidden():
        for label, name, kw in EXTRAS_CALLS:
            runs[label] = _events_ms(lambda: getattr(extras, name)(x, **kw))
    counts = _read(kernels, "extras path", ("K5_tv_value",))
    cs, cn = EXTRAS_CHECK_SHAPE
    small, tv_plain = _noisy(cs, cn), float(tv_value_ref(x))
    out = []
    for label, name, kw in EXTRAS_CALLS:
        (d, tv0), ms = runs[label]
        tv_rel = abs(float(tv0) - tv_plain) / tv_plain
        require(bool(torch.isfinite(d).all()) and tv_rel <= 2e-5,
                f"{label} at {ns}x{n}^2: not finite, or tv rel "
                f"{tv_rel:.3e} (2e-5)")
        d_card, tv_card = getattr(extras, name)(small.cuda(), **kw)
        d_ref, tv_ref = getattr(extras, name)(small, **kw)
        err = float((d_card.cpu() - d_ref).abs().max())
        tol = 1e-5 * float(d_ref.abs().max())
        rel = abs(float(tv_card) - float(tv_ref)) / abs(float(tv_ref))
        require(err <= tol and rel <= 2e-5,
                f"{label} at {cs}x{cn}^2 on the card vs the CPU: {err:.3e} "
                f"(bound {tol:.3e}), tv rel {rel:.3e} (2e-5)")
        out.append(f"{label} {ms:.3f} ms, tv rel {tv_rel:.2e}; at "
                   f"{cs}x{cn}^2 vs the CPU {err:.2e} <= {tol:.2e}, tv rel "
                   f"{rel:.2e}")
    print(f"extras on the card {ns}x{n}^2 (one call each, CUDA events): "
          + "; ".join(out) + f" [{card}]")
    return counts


# The experiment kernels, one row per TPU kernel of scripts/exp_*.py: (row,
# wrapper, the driver whose run counts its launches, the TPU kernel, the
# instantiation whose check at 256^3 gives the row's numbers).
EXP_SRC = {"E1": "tomojax_torch/csrc/exp_projector.cu",
           "E2": "tomojax_torch/csrc/exp_projector.cu",
           "E3": "tomojax_torch/csrc/exp_sart.cu",
           "E4": "tomojax_torch/csrc/exp_sart_shapes.cu"}
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
     "exp_sart_pipeline.py:314", "E4 TAPS_BF16 (8, 4)"),
    ("E3_sart_ablate", "sart_variant", "sart_ablate",
     "exp_sart_ablate.py:35", "E3 TAPS_F32"),
    ("E3_sart_phase", "sart_variant", "sart_ablate",
     "exp_sart_ablate.py:140", "E3 TAPS_F32"),
)
EXP_DRIVERS = ("hat_model", "projector_variants", "projector_variants2",
               "pair_fp", "sart_pipeline", "sart_ablate")


def _check_experiment_kernels(card: str) -> dict:
    """Every instantiation of E1 (six forms and PAIR, each at every angle
    cap 1-32; device times beside K1's; also at the ragged shapes) and E2
    (five forms, APS 2) against its plain version at 256^3 x 90 with phase
    3's bounds (1e-5 max|out|; 0.0 expected: the plain versions repeat the
    kernels' arithmetic), each launched; its time, the plain version's,
    its bound and, for the forms that compute A x or A^T y,
    torch.sparse.mm's."""
    from tomojax_torch.experiments import cuda_projector_variants as cpv
    from tomojax_torch.experiments.timing import batch_ms
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector.cuda_joseph import bp_sl, fp_sl
    from tomojax_torch.projector.oracle import joseph_csr

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

    return rows


def _sart_work(geom, ns: int, nnz: int, mode: str, table_bytes: int):
    """(bytes, operations) of one experiment SART sweep in `mode`: K8's
    (`sart_work`), the tables' bytes for TABLE_BF16; NOFP does no FP,
    NOUPD no update."""
    n, na = geom.n, geom.nproj
    v, s = n * n * ns, na * geom.nray * ns
    bytes_ = sart_work(geom, ns, nnz)[0] + (
        table_bytes if mode == "TABLE_BF16" else 0)
    spmv = 2 * nnz * ns
    ops = {"NOFP": spmv + 4 * na * v, "NOUPD": spmv + 3 * s}.get(
        mode, 2 * spmv + 4 * na * v)
    return bytes_, ops


def _check_sart_experiments(card: str) -> dict:
    """E3 in its six modes at 256^3 x 90 (the resident route) and in
    TAPS_F32 and TAPS_BF16 at 128 x 512^2 x 90 (the streaming route), and
    E4 in its three modes at every cluster shape that fits at both (E3
    keeps its own route, `csv.e3_route`: at 512^2 it streams where K8
    runs (16, 2)), over one sweep from zero on nanocube projections (real
    SART weights): each
    launched and equal to the plain version in its own order
    (sart_variant_ref with bands = its blocks, 1 on the streaming route)
    bit for bit, and within K8's bounds of the driving order (bands = 1):
    TAPS_F32 one angle step from random x (a column- and a row-driven
    angle) within 1e-5 max|x| and the sweep within 1e-4 max|x|; the bf16
    modes by the rmse after 10 sweeps within 2 % of K8's float32 sweep's.
    Prints each one's ms a sweep over 10 back-to-back sweeps (CUDA events)
    beside K8's at the same shape, its launch (clusters, active clusters,
    waves, shared memory a block), the split of E3's step and the phase
    cycles of E3's timed instantiation per mode. Returns the kernels-line
    rows of the 256^3 checks."""
    from tomojax_torch import ops
    from tomojax_torch.experiments import cuda_sart_variants as csv
    from tomojax_torch.experiments.timing import batch_ms
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector.cuda_joseph import fp_sl
    from tomojax_torch.projector.oracle import joseph_nnz
    from tomojax_torch.sim import nanocube_phantom
    from tomojax_torch.solvers import (
        cuda_sart, make_sart_weights, make_system, to_sl,
    )

    dev = torch.device("cuda")
    rows = {}
    for n, ns in ((256, 256), (512, 128)):
        na = 90
        geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
        nt, nnz = geom.nray, joseph_nnz(geom, "cuda")
        sysd = make_system(geom, dev)
        vol = to_sl(torch.from_numpy(nanocube_phantom(ns, n)).to(dev))
        base = (fp_sl(vol, geom), geom, sysd.inv_row,
                make_sart_weights(sysd), torch.tensor(1.0, device=dev))
        seq = torch.arange(na, dtype=torch.int32, device=dev)
        x0 = torch.zeros_like(vol)
        xr = torch.rand((n, n, ns), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        tables = csv.sart_tables(geom, dev)
        route = csv.e3_route(n, nt)
        k8_route = cuda_sart.sart_shape(n, nt) or "streaming"
        shape_tag = f"{ns} x {n}^2 x {na}"
        k8 = cuda_sart.sart_sweep_sl
        k8_ms = batch_ms(lambda: k8(x0, *base, seq), 10, dev)
        xk = x0
        for _ in range(10):
            xk = k8(xk, *base, seq)
        r32 = float(ops.rmse(xk, vol))
        print(f"K8 ({k8_route}) at {shape_tag}: {k8_ms:.4f} ms/sweep over 10 "
              f"back-to-back sweeps (CUDA events), rmse after 10 sweeps "
              f"{r32:.6f} [{card}]")
        refs = {}

        def plain(mode, bands):
            """The plain sweep from zero in `bands`' order, and its ms."""
            if (mode, bands) not in refs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = csv.sart_variant_ref(x0, *base, seq, mode, tables,
                                           bands)
                torch.cuda.synchronize()
                refs[mode, bands] = (out, 1e3 * (time.perf_counter() - t0))
            return refs[mode, bands]

        def held(key, wrapper, sweep, mode, bands, launch=""):
            """sweep(x, b, geom, inv_row, inv_col_a, beta, order) in
            `mode`, summed over `bands`; returns its batch ms."""
            got = _launched(wrapper, lambda: sweep(x0, *base, seq))
            ref, plain_ms = plain(mode, bands)
            err = max_err(got, ref)
            require(err == 0.0, f"{key} at {shape_tag}: max|kernel - plain "
                                f"(bands {bands})| {err:.3e}, 0.0 required")
            if mode == "TAPS_F32":
                step = 0.0
                for a in (0, na // 2):
                    order = torch.tensor([a], dtype=torch.int32, device=dev)
                    one = sweep(xr, *base, order)
                    drive = csv.sart_variant_ref(xr, *base, order, mode,
                                                 None, 1)
                    e, tol = max_err(one, drive), 1e-5 * float(
                        drive.abs().max())
                    require(e <= tol, f"{key} at {shape_tag}, one step at "
                                      f"angle {a} vs bands 1: {e:.3e} "
                                      f"above {tol:.3e}")
                    step = max(step, e / float(drive.abs().max()))
                drive = plain(mode, 1)[0]
                e = max_err(got, drive) / float(drive.abs().max())
                require(e <= 1e-4, f"{key} at {shape_tag}: one sweep vs "
                                   f"bands 1 {e:.3e} above 1e-4 max|x|")
                k8_text = (f"vs bands 1: one step {step:.2e} <= 1e-5, "
                           f"one sweep {e:.2e} <= 1e-4 (of max|x|)")
            elif mode in ("TAPS_BF16", "TABLE_BF16"):
                xb = x0
                for _ in range(10):
                    xb = sweep(xb, *base, seq)
                r = float(ops.rmse(xb, vol))
                require(abs(r - r32) <= 0.02 * r32,
                        f"{key} at {shape_tag}: rmse after 10 sweeps "
                        f"{r:.6f} vs K8's {r32:.6f} (rtol 2e-2)")
                k8_text = (f"rmse after 10 sweeps {r:.6f} vs K8's "
                           f"{r32:.6f}, |d| {abs(r - r32) / r32:.2e} <= 2e-2")
            else:
                k8_text = "an ablation: no bound against bands 1"
            fn = lambda: sweep(x0, *base, seq)  # noqa: E731
            ms = time_ms(fn, 5)
            sweep_ms = batch_ms(fn, 10, dev)
            bound_ms, bound_by = bound(*_sart_work(geom, ns, nnz, mode,
                                                   tables.nbytes))
            if n == 256:
                rows[key] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": None}
            print(f"{key} at {shape_tag}: max|kernel - plain (bands "
                  f"{bands})| {err:.1e} (0.0 required); {k8_text}; "
                  f"{sweep_ms:.4f} ms/sweep over 10 back-to-back sweeps "
                  f"(K8 {k8_route} {k8_ms:.4f}), one call {ms:.3f} ms, plain "
                  f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})"
                  f"{launch} [{card}]")
            return sweep_ms

        def launch_of(blocks, sb, mode):
            c = csv.resident_clusters(n, nt, ns, blocks, sb, mode)
            require(c["active"] > 0, f"({blocks}, {sb}) at {shape_tag}: "
                                     f"the card holds no cluster")
            return (f"; {c['clusters']} clusters of {blocks} blocks, "
                    f"{c['active']} at once, {c['waves']} waves, "
                    f"{c['smem']} B a block")

        e3 = {}
        for mode in (csv.MODES if route == "resident"
                     else ("TAPS_F32", "TAPS_BF16")):
            launch = launch_of(8, 4, mode) if route == "resident" else (
                "; two launches a step")
            e3[mode] = held(
                f"E3 {mode}", csv.sart_variant,
                lambda *a, m=mode: csv.sart_variant(*a, m, tables), mode,
                csv.e3_bands(n, nt), launch)
        if route == "resident":
            f32 = e3["TAPS_F32"]
            split = {"hat (TAPS_F32 - NOHAT)": f32 - e3["NOHAT"],
                     "FP (TAPS_F32 - NOFP)": f32 - e3["NOFP"],
                     "update (TAPS_F32 - NOUPD)": f32 - e3["NOUPD"],
                     "bf16 operands (TAPS_BF16 - TAPS_F32)":
                     e3["TAPS_BF16"] - f32,
                     "tables (TABLE_BF16 - TAPS_BF16)":
                     e3["TABLE_BF16"] - e3["TAPS_BF16"]}
            print(f"split of K8's step on its design (E3 at {shape_tag}, "
                  f"ms a sweep): " + ", ".join(
                      f"{k} {v:+.4f}" for k, v in split.items())
                  + f"; E3 TAPS_F32 {f32:.4f}, K8 {k8_ms:.4f} [{card}]")
            for mode in csv.MODES:
                ph = csv.resident_phases(x0, *base, seq, mode, tables)
                print(f"E3 {mode} phases (the timed instantiation: clock64 "
                      f"cycles a step, mean over blocks; SM clock after it, "
                      f"max: {sm_clock()}): " + "; ".join(
                          f"{kind} ({v['steps']} steps) " + ", ".join(
                              f"{name} {v[name]:.0f}"
                              for name in cuda_sart.PHASES)
                          for kind, v in ph.items()))
        for blocks, sb in csv.e4_shapes(n, nt):
            for mode in csv.RESIDENT_MODES:
                held(f"E4 {mode} ({blocks}, {sb})", csv.sart_resident,
                     lambda *a, m=mode, bl=blocks, s=sb: csv.sart_resident(
                         *a, m, tables, bl, s),
                     mode, blocks, launch_of(blocks, sb, mode))
        print(f"E4 at {shape_tag}: shapes {csv.e4_shapes(n, nt)} of "
              f"{list(csv.E4_SHAPES)} fit; the others raise [{card}]")
        del tables, refs
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
    # instantiations, of K2/K10's bp_kernel and of the resident sweep in
    # K8's and the experiment modes (E3, E4), from cuobjdump -res-usage
    usage = subprocess.run([str(tool), "-res-usage", str(_build.build().path)],
                           capture_output=True, text=True, timeout=300).stdout
    found = re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+)", usage)
    if not found:
        print("registers/stack bytes: not read (cuobjdump -res-usage)")
    forms = ("FULL", "HAT5", "BF16", "NOHAT", "NODOT", "W4")
    e1, e2, e34 = {}, [], []
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
        m = re.search(r"sart_resident_kernelI\S*?K8TapsELi(\d+)ELi(\d+)"
                      r"ELb(\d)E", name)
        if m:
            print(f"registers/stack bytes sart_resident_kernel<K8Taps, "
                  f"{m[1]}, {m[2]}, PROF={m[3] == '1'}> (K8): {reg}/{stack}")
        m = re.search(r"sart_resident_kernelI\S*?SartTapsILi(\d)EEELi(\d+)"
                      r"ELi(\d+)ELb(\d)E", name)
        if m:
            modes = ("TAPS_F32", "TAPS_BF16", "TABLE_BF16", "NOHAT", "NOFP",
                     "NOUPD")
            e34.append(f"{modes[int(m[1])]} ({m[2]}, {m[3]})"
                       f"{' PROF' if m[4] == '1' else ''} {reg}/{stack}")
    for maxt in sorted(e1):
        print(f"registers/stack bytes fp_variant_kernel ({maxt} threads): "
              f"{', '.join(sorted(e1[maxt]))}")
    print(f"registers/stack bytes bp_variant_kernel: {', '.join(sorted(e2))}")
    print(f"registers/stack bytes sart_resident_kernel<SartTaps> (E3, E4): "
          f"{', '.join(sorted(e34))}")


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

    checks = {**_check_experiment_kernels(card),
              **_check_sart_experiments(card)}
    _check_ablation_sass()
    wrappers = {"fp_variant": cpv.fp_variant, "bp_variant": cpv.bp_variant,
                "sart_variant": csv.sart_variant,
                "sart_resident": csv.sart_resident}
    dev = torch.device("cuda")
    launches, out = {}, {}
    # sart_pipeline also at 128 x 512^2 x 90 (E3 streams, E4 at the
    # shapes that fit there)
    for name, (n, ns) in [*((d, (256, 256)) for d in EXP_DRIVERS),
                          ("sart_pipeline_512", (512, 128))]:
        mod = importlib.import_module(
            f"tomojax_torch.experiments.{name.removesuffix('_512')}")
        for w in wrappers.values():
            w.launches = 0
        with plain_versions_forbidden():
            out[name] = mod.run(n, ns, dev, card)
        torch.cuda.synchronize()
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        print(f"{name} launches: {json.dumps(launches[name])}")
    for name in ("sart_pipeline", "sart_pipeline_512"):
        sp = out[name]["rows"]
        for v, r in sp.items():  # the script's criterion: rmse after 10
            r0 = sp["base"]["rmse10"]
            tol = 1e-4 if v == "base" or sart_pipeline.VARIANTS[v][1] == \
                "TAPS_F32" else 2e-2
            require(np.isfinite(r["ms"]) and abs(r["rmse10"] - r0)
                    <= tol * r0, f"{name} {v}: rmse@10 {r['rmse10']:.6f} "
                                 f"vs K8 {r0:.6f} (rtol {tol})")
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


def phase_golden_fusion(card: str, group=None) -> None:
    """tests/golden/fusion_jax_cpu.json: the reference's ChemicalTomo host
    loop on the CPU, replayed by the port on the card (its own system,
    projections and kernels, float32 FGP duals) within the stored bounds;
    with a group through it (K9a/K9b, the costs all-reduced). The
    lambda_chem decay iterations are checked first: a mismatch there is a
    flipped branch, not drift."""
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
                            sigmaMethod=c["sigma_method"], group=group)
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
    through = "" if group is None else " through the group"
    print(f"golden fusion {c['nel']}x{c['ns']}x{c['n']}^2{through}, HAADF "
          f"{c['na_haadf']} / chemistry {c['na_chem']} angles vs "
          f"{c['device']}: lambda_chem decays at {decays} as recorded; max "
          f"rel dev " + ", ".join(f"{k} {v:.3e} (<= {bd[k]})"
                                  for k, v in dev.items()) + f" [{card}]")
    require(all(v <= bd[k] for k, v in dev.items()),
            "fusion golden trace outside its bounds")


def _golden_sirt_dd() -> list:
    """GOLDEN_SIRT_DD of tests/test_golden_traces.py, read from the file's
    text (importing it would import JAX)."""
    import ast

    tree = ast.parse((ROOT / "tests/test_golden_traces.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "GOLDEN_SIRT_DD"):
            return ast.literal_eval(node.value)
    raise PhaseFailed("GOLDEN_SIRT_DD not found in "
                      "tests/test_golden_traces.py")


def phase_golden_sirt(card: str) -> None:
    """The reference's CPU golden SIRT trace (tests/test_golden_traces.py:
    32^2 Shepp-Logan, 20 angles over +-70 degrees, 5 points of 2
    ASTRA-SIRT iterations) replayed by the port on the card (K1, K2's
    fused update) within its rtol 2e-3."""
    from tomojax_torch import ops
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector.cuda_joseph import fp_sl
    from tomojax_torch.sim import create_projections, shepp_logan
    from tomojax_torch.solvers import make_system, sirt_sweep_sl, to_sl

    golden = _golden_sirt_dd()
    dev = torch.device("cuda")
    n = 32
    geom = Geometry.make(n, np.deg2rad(np.linspace(-70, 70, 20)))
    sysd = make_system(geom, dev)
    b_sl = to_sl(create_projections(
        torch.from_numpy(shepp_logan(n)[None]).to(dev), geom))
    x = torch.zeros((n, n, 1), device=dev)
    trace = []
    for _ in range(len(golden)):
        x = sirt_sweep_sl(x, b_sl, sysd, 2)
        trace.append(float(ops.data_distance(fp_sl(x, geom), b_sl)))
    dev_dd = float(np.max(np.abs(np.asarray(trace) - golden)
                          / np.abs(golden)))
    print(f"golden SIRT 1x{n}^2x20, {2 * len(golden)} iterations vs the "
          f"reference's CPU trace: max rel dev dd {dev_dd:.3e} (<= 2e-3) "
          f"[{card}]")
    require(dev_dd <= 2e-3, "SIRT golden trace outside rtol 2e-3")


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


def art_times(geom, ns: int, card: str, tree: str) -> dict:
    """A1's ms a sweep (CUDA events over 3 back-to-back sweeps from zero on
    nanocube projections) for every slices-a-block instantiation,
    angle-major and in a random order (randperm, seed 0), and, where the
    tree has them (`cuda_art.VARIANTS`, `cuda_art.art_phases`), each
    variant angle-major with the cycles a ray it saves against FULL at the
    card's SM clock, and the clock64 cycles a ray of each phase."""
    from tomojax_torch.experiments.timing import batch_ms
    from tomojax_torch.projector.cuda_joseph import fp_sl
    from tomojax_torch.sim import nanocube_phantom
    from tomojax_torch.solvers import cuda_art, to_sl

    dev = torch.device("cuda")
    n, na, nt = geom.n, geom.nproj, geom.nray
    rays = na * nt
    b = fp_sl(to_sl(torch.from_numpy(nanocube_phantom(ns, n)).to(dev)), geom)
    x0 = torch.zeros((n, n, ns), device=dev)
    seq = torch.arange(rays, dtype=torch.int32, device=dev)
    perm = torch.randperm(rays, generator=torch.Generator().manual_seed(0))
    perm = perm.to(device=dev, dtype=torch.int32)
    variants = getattr(cuda_art, "VARIANTS", ("FULL",))
    out = {}
    for sl in cuda_art.SLICES:
        row = {"random": batch_ms(lambda: cuda_art.art_sweep_sl(
            x0, b, geom, 1.0, perm, sl), 3, dev)}
        for v in variants:
            fn = (cuda_art.art_sweep_sl if v == "FULL" else functools.partial(
                cuda_art.art_variant, variant=v))
            row[v] = batch_ms(lambda: fn(x0, b, geom, 1.0, seq, slices=sl),
                              3, dev)
        if hasattr(cuda_art, "art_phases"):
            row["phases"] = cuda_art.art_phases(x0, b, geom, 1.0, seq, sl)
        out[sl] = row
    clock = sm_clock()
    mhz = float(clock.split(",")[0].split()[0])
    for sl, row in out.items():
        full = row["FULL"]
        print(f"A1 [{tree}] at {ns} x {n}^2 x {na} ({rays} rays), {sl} "
              f"slices a block: angle-major {full:.3f} ms ("
              f"{1e3 * full / rays:.4f} us a ray), random {row['random']:.3f}"
              + "".join(f"; {v} {row[v]:.3f} (saves "
                        f"{(full - row[v]) * 1e3 * mhz / rays:.0f} cycles a "
                        f"ray)" for v in variants if v != "FULL")
              + f" [{card}]")
        if "phases" in row:
            ph = dict(row["phases"])
            nrays = ph.pop("rays")
            print(f"A1 [{tree}] {sl} slices a block, clock64 cycles a ray "
                  f"by phase (thread 0 of each block, {nrays} rays): "
                  + ", ".join(f"{k} {v:.0f}" for k, v in ph.items())
                  + f"; sum {sum(ph.values()):.0f}")
    print(f"A1 [{tree}] SM clock after it, max: {clock}")
    return {str(sl): row for sl, row in out.items()}


def art_times_main() -> int:
    """`--art-times`: only A1's times (`art_times`) at 256^3 x 90, with the
    tomojax_torch package beside this file; a copy of this file beside
    another tree times that tree's kernel."""
    from tomojax_torch import _build
    from tomojax_torch.geometry import Geometry

    card = phase_device()
    info = _build.build()
    entry = ""
    for line in info.log.splitlines():
        if "Compiling entry" in line:
            entry = line
        elif "art_sweep" in entry and ("Used" in line or "spill" in line):
            print(f"  ptxas: {entry.split()[-3]} {line.strip()}")
    geom = Geometry.make(256, np.deg2rad(np.linspace(-76, 76, 90)))
    times = art_times(geom, 256, card, str(ROOT.name))
    print(json.dumps({"art_ms": times, "tree": str(ROOT)}))
    return 0


def sart_times_main() -> int:
    """`--sart-times`: only K8's ms a sweep (CUDA events over 10
    back-to-back sweeps from zero on nanocube projections) at 128 x 512^2
    x 77 and x 90, 128 x 320^2 x 77 and 256^3 x 90, each with its route,
    its cluster shape where the tree has `sart_shape`, and the first 16 hex
    digits of a SHA-256 of one sweep's output, with the tomojax_torch
    package beside this file; a copy of this file beside another tree
    times that tree's sweep."""
    import hashlib

    from tomojax_torch.experiments.timing import batch_ms
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.projector.cuda_joseph import fp_sl
    from tomojax_torch.sim import nanocube_phantom
    from tomojax_torch.solvers import (
        cuda_sart, make_sart_weights, make_system, to_sl,
    )

    from tomojax_torch.projector.oracle import joseph_nnz

    card = phase_device()
    phase_build()
    dev = torch.device("cuda")
    shape_of = getattr(cuda_sart, "sart_shape", lambda n, nt: None)
    times = {}
    for ns, n, na in ((64, 1024, 77), (128, 512, 77), (128, 512, 90),
                      (128, 320, 77), (256, 256, 90)):
        geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
        sysd = make_system(geom, dev)
        vol = to_sl(torch.from_numpy(nanocube_phantom(ns, n)).to(dev))
        x0 = torch.zeros_like(vol)
        args = (x0, fp_sl(vol, geom), geom, sysd.inv_row,
                make_sart_weights(sysd), torch.tensor(1.0, device=dev),
                torch.arange(na, dtype=torch.int32, device=dev))
        out = cuda_sart.sart_sweep_sl(*args)
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = batch_ms(lambda: cuda_sart.sart_sweep_sl(*args), 10, dev)
        route = cuda_sart.sart_route(n, geom.nray)
        shape = shape_of(n, geom.nray)
        bound_ms, bound_by = bound(*sart_work(geom, ns,
                                              joseph_nnz(geom, "cuda")))
        key = f"{ns}x{n}^2x{na}"
        times[key] = {"ms": ms, "route": route, "shape": shape,
                      "sha256": digest, "bound_ms": bound_ms}
        print(f"K8 [{ROOT.name}] at {ns} x {n}^2 x {na}: {route}"
              f"{'' if shape is None else f' {shape}'} {ms:.4f} ms/sweep "
              f"over 10 back-to-back sweeps (CUDA events), bound "
              f"{bound_ms:.4f} ms ({bound_by}), output sha256 {digest}; SM "
              f"clock after it, max: {sm_clock()} [{card}]")
        if n == 1024 and route == "resident":
            c = cuda_sart.resident_clusters(n, geom.nray, ns)
            times[key]["launch"] = c
            print(f"  launch: {_launch_text(c)}")
            _print_phases(x0, args[1:], "serial_fp" in inspect.signature(
                cuda_sart.resident_phases).parameters)
        del sysd, vol, x0, args, out
    print(json.dumps({"sart_ms": times, "tree": str(ROOT)}))
    return 0


def d2h_times_main(reps: int = 10) -> int:
    """`--d2h-times`: ms of one read of a result volume to the host at 2^26
    and 2^27 B, the median of `reps` blocking calls on the host clock:
    the pageable copy, then `host.to_host` keeping every result (each
    read a `cudaHostAlloc`: the cache has no free block of the size),
    then `host.to_host` dropping each result before the next (each read
    a block from the cache); every result equal to the pageable copy."""
    from tomojax_torch import host

    card = phase_device()
    dev = torch.device("cuda")
    times = {}
    for shape in ((256, 256, 256), (128, 512, 512)):
        t = torch.rand(shape, device=dev)
        want = t.cpu().numpy()

        def timed(read, kept: list | None = None):
            ms = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a = read()
                ms.append(1e3 * (time.perf_counter() - t0))
                require(np.array_equal(a, want), "to_host changed a value")
                if kept is not None:
                    kept.append(a)
                del a
            return statistics.median(ms), ms

        kept = []
        row = {"pageable": timed(lambda: t.cpu().numpy()),
               "pinned_alloc": timed(lambda: host.to_host(t), kept)}
        pinned = torch.from_numpy(kept[0]).is_pinned()
        kept.clear()
        row["pinned_cached"] = timed(lambda: host.to_host(t))
        nbytes = t.numel() * t.element_size()
        for name, (med, ms) in row.items():
            print(f"to_host {nbytes} B {name}: {med:.4f} ms median of "
                  f"{reps} ({nbytes / med / 1e6:.2f} GB/s); each "
                  f"{[round(m, 4) for m in ms]} [{card}]")
        times[str(nbytes)] = {k: v[0] for k, v in row.items()}
        times[str(nbytes)]["result_pinned"] = pinned
        del t, want
    print(json.dumps({"d2h_ms": times, "tree": str(ROOT)}))
    return 0


def gap_study_main() -> int:
    """`--gap-study`: only `_sharded_gap_study` on phase 4c's ASD-POCS
    problem (256^3 x 90, defaults), with 16 profiled windows each way."""
    from tomojax_torch import TomoTorch
    from tomojax_torch.geometry import Geometry
    from tomojax_torch.sim import create_projections, nanocube_phantom
    from tomojax_torch.solvers import (
        AsdPocsParams, asd_pocs_run, make_sart_weights,
    )

    card = phase_device()
    phase_build()
    ns, n, na = 256, 256, 90
    angles = np.linspace(-76, 76, na)
    vol = torch.from_numpy(nanocube_phantom(ns, n)).cuda()
    b = create_projections(vol, Geometry.make(n, np.deg2rad(angles)))
    ref = TomoTorch(angles, b.permute(0, 2, 1).cpu().numpy(), device="cuda")
    w = make_sart_weights(ref.sys)
    x0 = torch.zeros((n, n, ns), device="cuda")

    def run(g, k):
        return asd_pocs_run(x0, ref.b_sl, ref.sys, w,
                            AsdPocsParams(niter=k), group=g)

    with _nccl_group("gap") as group, plain_versions_forbidden():
        run(None, 1), run(group, 1)  # warm-up
        _sharded_gap_study(run, group, card, windows=16)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--projector-times"]:
        return projector_times_main()
    if sys.argv[1:] == ["--tv-times"]:
        return tv_times_main()
    if sys.argv[1:] == ["--gap-study"]:
        return gap_study_main()
    if sys.argv[1:] == ["--art-times"]:
        return art_times_main()
    if sys.argv[1:] == ["--sart-times"]:
        return sart_times_main()
    if sys.argv[1:] == ["--d2h-times"]:
        return d2h_times_main()
    try:
        card = phase_device()
        phase_build()
        kernels = _kernel_table()
        rows = phase_kernels(card)
        paths = [phase_main_path(card, kernels),
                 phase_asd_path(card, kernels)]
        with _nccl_group("sharded") as group:
            paths += [phase_sharded_path(card, kernels, group),
                      phase_sharded_fusion_path(card, kernels, group)]
        paths += [phase_fusion_path(card, kernels),
                  phase_variants(card, kernels),
                  phase_sim_path(card, kernels),
                  phase_stream_path(card, kernels),
                  phase_extras(card, kernels)]
        exp_rows = phase_experiments(card)
        phase_golden(card)
        phase_golden_asd(card)
        phase_golden_fusion(card)
        phase_golden_sirt(card)
    except PhaseFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    # launches: the kernel's count over the main paths' runs (phase 4a-e,
    # g-i),
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
