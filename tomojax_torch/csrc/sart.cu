// K8 -- replaces tomojax/solvers/pallas_sart.py:_sart_resident_kernel and
// _sart_kernel: ordered SART (block-Kaczmarz over angles), the semantics of
// the XLA branch of tomojax/solvers/iterative.py:sart_sweep. For each step
// k with angle a = order[k]:
//   resid = (b_a - A_a x) * inv_row[a]                  (Nt, Ns)
//   x     = max(x + beta * inv_col_a[a] * A_a^T resid, 0)
// with A_a the Joseph operator of one angle (at most two taps per pixel and
// per ray), slice-last layouts: x (N, N, Ns), b (Na, Nt, Ns). order and beta
// are read on the device, so a solver loop queues sweeps without waiting
// for the host; an order entry outside [0, Na) leaves x unchanged (no read
// out of bounds); the input is left as it was. One host call is one sweep.
//
// Two routes, chosen by the shape alone (resident_smem below;
// cuda_sart.sart_route mirrors it):
//
// Resident (the block's share fits the card's 227 KB): the TPU kernel kept
// the volume in VMEM for the whole sweep; here a thread-block cluster of
// R_BLOCKS = 8 blocks (one an SM) keeps R_SLICES = 4 slices of it in their
// shared memory. Slices are independent 2D problems, so clusters need no
// grid barrier and the volume never goes back to device memory during the
// sweep. Block `rank` holds rows [rank R, (rank + 1) R), R = ceil(N / 8), of
// all N columns, a float4 (4 slices) a pixel: 130 KB at N = 256. Per step:
//   FP      every block walks, for each bin and its 4 slices, only the taps
//           in its own rows, with tj::fp_ray's positions and fmaf chain:
//           row-driven angles step over its R rows; column-driven angles
//           have taps along rows, and the block walks the steps whose pos
//           reaches [r0 - 1, r1) (pos is monotone in the step; column_steps
//           gives the range in closed form, widened by a margin), reading 0
//           for a tap row outside the band. Each in-volume tap lies in
//           exactly one band. Two threads walk a ray, on alternate steps,
//           and the second chain is added to the first: a column-driven
//           ray crosses a band in up to R / |shear| steps (139 at 76
//           degrees and N = 256), a chain of dependent loads and FMAs that
//           one thread would walk alone. Partials (bin, 4 slices) go to a
//           double-buffered plane in the block's shared memory.
//   sync    one cluster barrier.
//   resid   every block adds the 8 blocks' partials of every bin in rank
//           order through distributed shared memory (the same sums in every
//           block, no float atomics: repeatable bit for bit), scales by 1/D
//           and forms (b - ax) inv_row into its own residual plane.
//   update  each pixel of the band runs K8's update chain (tj::bp_angle's
//           taps and fmaf pair, then max(x + beta inv_col_a upd, 0) with
//           the same rounding) on the local plane, in place.
// b[a], inv_row[a] and the band's rows of inv_col_a[a] (32 KB at N = 256;
// 23.6 MB in all, shared by every cluster in L2) are copied with cp.async
// while the FP runs. Only the FP's sum order differs from the streaming
// route and the plain version (the ray summed as band partials added in
// rank order), so the resident result is not bit-equal to them; the update
// is the streaming route's to the bit. The PROF instantiation times the
// phases (tj_sart_resident_phases).
//
// Streaming (larger N, 512^2 for one): each step is two launches on the
// caller's stream,
//   sart_fp_kernel      one thread per (bin, slice): the driving-axis walk
//                       of K1 (tj::fp_ray) and the residual into a
//                       (Nt, Ns) scratch plane;
//   sart_update_kernel  one thread per voxel: K2's one-angle gather
//                       (tj::bp_angle) from that plane and the clamped
//                       update, in place (each voxel only by its thread).
// Both routes' updates round each weight's operations alone, as the plain
// version does (tj::bp_taps<true>): a pixel whose one in-range tap nearly
// vanishes gets a large inv_col_a, which magnified the contracted FMA's
// difference past the one-step bound at 512^2.
//
// Bound on the H100: the streaming route moves the volume three times a
// step (3 x 64 MiB at 256^3, x 90 angles ~ 17 GB a sweep: 5.2 ms at the
// 3.35 TB/s of device memory). The resident route reads the volume and
// writes it once a sweep; its time is the FP's and the update's
// shared-memory reads (~12 + 12 GB a sweep at 256^3 x 90) and a cluster
// barrier a step.
#include <cooperative_groups.h>

#include "joseph.cuh"
#include "staging.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------ streaming

constexpr int S_BS = 32;  // slices per block (threadIdx.x)
constexpr int S_BY = 8;   // bins (FP) or columns (update) per block
constexpr int S_NT = S_BS * S_BY;

__global__ void __launch_bounds__(S_NT)
sart_fp_kernel(const float* __restrict__ x, const float4* __restrict__ tab,
               const float* __restrict__ b, const float* __restrict__ inv_row,
               const int* __restrict__ order, int k,
               float* __restrict__ resid, int n, int nt, int na, int ns) {
  const int s = blockIdx.x * S_BS + threadIdx.x;
  const int j = blockIdx.y * S_BY + threadIdx.y;
  if (s >= ns || j >= nt) return;
  const int a = order[k];
  const size_t o = static_cast<size_t>(j) * ns + s;
  if (a < 0 || a >= na) {
    resid[o] = 0.f;
    return;
  }
  const float4 t = tab[a];  // {inv_d, shear, scale, row_driven}
  const float ax = tj::fp_ray(x, t, n, nt, ns, j, s) * t.z;
  const size_t ab = static_cast<size_t>(a) * nt + j;
  resid[o] = __fmul_rn(__fsub_rn(b[ab * ns + s], ax), inv_row[ab]);
}

__global__ void __launch_bounds__(S_NT)
sart_update_kernel(const float* src, float* dst,  // alias after step 0
                   const float* __restrict__ resid,
                   const float4* __restrict__ tab,
                   const float* __restrict__ inv_col_a,
                   const float* __restrict__ beta,
                   const int* __restrict__ order, int k, int n, int nt,
                   int na, int ns) {
  const int s = blockIdx.x * S_BS + threadIdx.x;
  const int c = blockIdx.y * S_BY + threadIdx.y;
  const int r = blockIdx.z;
  if (s >= ns || c >= n) return;
  const size_t o = (static_cast<size_t>(r) * n + c) * ns + s;
  const int a = order[k];
  if (a < 0 || a >= na) {
    dst[o] = src[o];
    return;
  }
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float xc = static_cast<float>(c) - ctr;
  const float yr = ctr - static_cast<float>(r);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const float upd = tj::bp_angle(resid + s, tab[a], xc, yr, off, nt, ns, 0.f);
  const float scale =
      __fmul_rn(beta[0], inv_col_a[(static_cast<size_t>(a) * n + r) * n + c]);
  dst[o] = fmaxf(__fadd_rn(src[o], __fmul_rn(scale, upd)), 0.f);
}

int streaming_sweep(const float* x, const float4* ft, const float4* bt,
                    const float* b, const float* inv_row,
                    const float* inv_col_a, const float* beta,
                    const int* order, int steps, float* resid, float* out,
                    int n, int nt, int na, int ns, cudaStream_t st) {
  if (resid == nullptr || n > 65535 || (nt + S_BY - 1) / S_BY > 65535 ||
      (n + S_BY - 1) / S_BY > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 block(S_BS, S_BY);
  const dim3 fp_grid((ns + S_BS - 1) / S_BS, (nt + S_BY - 1) / S_BY);
  const dim3 up_grid((ns + S_BS - 1) / S_BS, (n + S_BY - 1) / S_BY, n);
  for (int k = 0; k < steps; ++k) {
    const float* src = k == 0 ? x : out;
    sart_fp_kernel<<<fp_grid, block, 0, st>>>(src, ft, b, inv_row, order, k,
                                              resid, n, nt, na, ns);
    int err = tj::launch_error();
    if (err != 0) return err;
    sart_update_kernel<<<up_grid, block, 0, st>>>(
        src, out, resid, bt, inv_col_a, beta, order, k, n, nt, na, ns);
    err = tj::launch_error();
    if (err != 0) return err;
  }
  return 0;
}

// ------------------------------------------------------------- resident

constexpr int R_BLOCKS = 8;   // blocks (bands of rows) of a cluster
constexpr int R_SLICES = 4;   // slices of a cluster: one float4 a pixel
constexpr int R_NT = 512;     // threads per block
// the shared memory one block may have on an H100 (227 KB, opt-in); the
// route is chosen against this constant, so it depends on the shape alone
constexpr size_t RESIDENT_SMEM_MAX = 232448;
// 2^-20: the column-driven step range's margin, in positions per unit of
// (2N + Nt + 8), eight times the rounding of pos (below 2^-24 (2N + Nt))
constexpr float STEP_SLACK = 9.5367431640625e-07f;

// The band's row stride is N + R_PAD float4: the two FP threads of a ray
// read neighbouring rows (row-driven), which then fall in other banks.
constexpr int R_PAD = 4;

__host__ __device__ __forceinline__ int band_rows(int n) {
  return (n + R_BLOCKS - 1) / R_BLOCKS;
}

// One block's shared memory, in this order: band (R rows of N + R_PAD
// float4, x of its rows), partials (2 Nt float4), the residual plane (Nt
// float4), b[a] at the cluster's slices (Nt float4), the band's
// inv_col_a[a] (R N floats), inv_row[a] (Nt floats).
// cuda_sart.resident_smem_bytes mirrors it.
size_t resident_smem(int n, int nt) {
  const size_t rows = band_rows(n);
  return rows * (n + R_PAD) * sizeof(float4) + rows * n * sizeof(float) +
         static_cast<size_t>(nt) * (4 * sizeof(float4) + sizeof(float));
}

bool resident_route(int n, int nt) {
  return resident_smem(n, nt) <= RESIDENT_SMEM_MAX;
}

// 4 slices [s0, s0 + 4) of a pixel or bin at src (its slice s0) into shared
// dst: one 16-byte copy (vec: ns % 4 == 0, 16-byte aligned) or four 4-byte
// ones, zeros for the `valid` <= 4 slices past ns.
__device__ __forceinline__ void copy_px(float4* dst, const float* src,
                                        const float* safe, int valid,
                                        bool vec) {
  float* d = reinterpret_cast<float*>(dst);
  if (vec) {
    tj::copy16(d, src, safe, true);
  } else {
#pragma unroll
    for (int i = 0; i < R_SLICES; ++i) {
      tj::copy4(d + i, src + i, safe, i < valid);
    }
  }
}

// The steps [k0, k1) in which a column-driven ray (u = ctr - base, shear
// sh) can reach rows [r0, r1): pos(k) = u + (k - ctr) sh, rounded, is
// monotone in k, and a tap row lies in the band when pos lies in [r0 - 1,
// r1). The closed form's ends are widened by 2 steps plus the rounding of
// pos over |sh|; a step of the range whose taps miss the band adds
// fmaf(0, w, acc) = acc. cuda_sart.column_steps mirrors it.
__device__ __forceinline__ void column_steps(float u, float sh, int n, int nt,
                                             int r0, int r1, int& k0,
                                             int& k1) {
  k0 = 0;
  k1 = 0;
  if (r0 >= r1) return;
  if (sh == 0.f) {
    const bool in =
        u >= static_cast<float>(r0 - 1) && u < static_cast<float>(r1);
    k1 = in ? n : 0;
    return;
  }
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float ta = __fdiv_rn(__fsub_rn(static_cast<float>(r0 - 1), u), sh);
  const float tb = __fdiv_rn(__fsub_rn(static_cast<float>(r1), u), sh);
  const float slack = __fmul_rn(STEP_SLACK,
                                static_cast<float>(2 * n + nt + 8));
  const float m = __fadd_rn(2.f, __fdiv_rn(slack, fabsf(sh)));
  const float lo = __fsub_rn(__fadd_rn(ctr, fminf(ta, tb)), m);
  const float hi = __fadd_rn(__fadd_rn(ctr, fmaxf(ta, tb)), m);
  const float fn = static_cast<float>(n);
  k0 = static_cast<int>(fminf(fmaxf(floorf(lo), 0.f), fn));
  k1 = static_cast<int>(fminf(fmaxf(__fadd_rn(ceilf(hi), 1.f), 0.f), fn));
}

// acc + v0 (1 - frac) + v1 frac per slice, tj::fp_ray's fmaf pair.
__device__ __forceinline__ float4 fp_tap_pair(float4 acc, float4 v0,
                                              float4 v1, float frac) {
  const float w0 = 1.f - frac;
  acc.x = fmaf(v1.x, frac, fmaf(v0.x, w0, acc.x));
  acc.y = fmaf(v1.y, frac, fmaf(v0.y, w0, acc.y));
  acc.z = fmaf(v1.z, frac, fmaf(v0.z, w0, acc.z));
  acc.w = fmaf(v1.w, frac, fmaf(v0.w, w0, acc.w));
  return acc;
}

// Phase `ph` (0 or 1) of one block's partial of ray j (4 slices) through
// its band rows [r0, r1), row stride rs: tj::fp_ray's positions and fmaf
// chain over every other step (ph, ph + 2, ...) of the steps whose taps can
// lie in the band, taps outside the band or the volume reading 0. The two
// phases are two threads, so a ray's longest chain is half its range.
__device__ __forceinline__ float4 fp_band(const float4* band, int rs,
                                          float4 t, int n, int nt, int j,
                                          int ph, int r0, int r1) {
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float tdet =
      static_cast<float>(j) - 0.5f * static_cast<float>(nt - 1);
  const float base = __fmul_rn(tdet, t.x);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = zero;
  if (t.w != 0.f) {  // row-driven: the steps are the band's rows
    for (int k = r0 + ph; k < r1; k += 2) {
      const float coord = ctr - static_cast<float>(k);
      const float pos = __fadd_rn(__fadd_rn(base, __fmul_rn(coord, t.y)),
                                  ctr);
      const float f = floorf(pos);
      const int i0 = static_cast<int>(f);
      const float4* row = band + (k - r0) * rs;
      const float4 v0 = (i0 >= 0 && i0 < n) ? row[i0] : zero;
      const float4 v1 = (i0 + 1 >= 0 && i0 + 1 < n) ? row[i0 + 1] : zero;
      acc = fp_tap_pair(acc, v0, v1, pos - f);
    }
  } else {  // column-driven: taps along rows, only those in the band
    const float u = __fsub_rn(ctr, base);
    int k0, k1;
    column_steps(u, t.y, n, nt, r0, r1, k0, k1);
    for (int k = k0 + ph; k < k1; k += 2) {
      const float coord = static_cast<float>(k) - ctr;
      const float pos = __fadd_rn(u, __fmul_rn(coord, t.y));
      const float f = floorf(pos);
      const int i0 = static_cast<int>(f);
      const float4 v0 =
          (i0 >= r0 && i0 < r1) ? band[(i0 - r0) * rs + k] : zero;
      const float4 v1 =
          (i0 + 1 >= r0 && i0 + 1 < r1) ? band[(i0 + 1 - r0) * rs + k]
                                        : zero;
      acc = fp_tap_pair(acc, v0, v1, pos - f);
    }
  }
  return acc;
}

// Phases of a resident step that PROF times: the copies' issue, the FP,
// the wait for the copies and the cluster barrier, the residual, the update.
constexpr int R_PHASES = 5;

// x, b: vec (16-byte slices); inv_col_a: icvec (16-byte band rows). PROF:
// thread 0 of every block adds the clock64 cycles of each phase, per
// driving type, and the steps into prof[block][row, column][R_PHASES + 1]
// (a block barrier after the FP separates it from the cluster barrier).
template <bool PROF>
__global__ void __launch_bounds__(R_NT, 1)
sart_resident_kernel(const float* __restrict__ x,
                     const float4* __restrict__ ftab,
                     const float4* __restrict__ btab,
                     const float* __restrict__ b,
                     const float* __restrict__ inv_row,
                     const float* __restrict__ inv_col_a,
                     const float* __restrict__ beta,
                     const int* __restrict__ order, int steps,
                     float* __restrict__ out, int n, int nt, int na, int ns,
                     bool vec, bool icvec, long long* __restrict__ prof) {
  extern __shared__ float4 rs_smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = band_rows(n);
  const int r0 = rank * rows;
  const int r1 = min(r0 + rows, n);
  const int px = max(r1 - r0, 0) * n;  // pixels this block holds
  const int rs = n + R_PAD;             // the band's row stride (float4)
  float4* band = rs_smem4;
  float4* part = band + static_cast<size_t>(rows) * rs;  // [2][nt]
  float4* res = part + 2 * nt;
  float4* bsl = res + nt;
  float* icol = reinterpret_cast<float*>(bsl + nt);
  float* irow = icol + static_cast<size_t>(rows) * n;
  const int tid = threadIdx.x;
  const int s0 = static_cast<int>(blockIdx.x / R_BLOCKS) * R_SLICES;
  const int valid = ns - s0;
  const float* xs = x + static_cast<size_t>(r0) * n * ns + s0;
  for (int p = tid; p < px; p += R_NT) {
    copy_px(band + p / n * rs + p % n, xs + static_cast<size_t>(p) * ns, x,
            valid, vec);
  }
  tj::copy_commit();
  tj::copy_wait();
  __syncthreads();  // the band is in place

  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const float bt = beta[0];
  // the update's walk over the band: pixel tid, then R_NT on, as (row,
  // column) advanced without a division
  const int c_first = tid % n, rr_first = tid / n;
  const int c_step = R_NT % n, rr_step = R_NT / n;
  // PROF: thread 0's cycles, then steps, per driving type, in shared
  // memory (a register array indexed by the type would spill)
  __shared__ long long clk[2 * (R_PHASES + 1)];
  if (PROF && tid == 0) {
    for (int i = 0; i < 2 * (R_PHASES + 1); ++i) clk[i] = 0;
  }
  long long t0 = 0;
  int kind = 0;  // PROF: 0 row-driven, 1 column-driven
  auto phase = [&](int i) {
    if (PROF && tid == 0) {
      const long long t1 = clock64();
      clk[kind * (R_PHASES + 1) + i] += t1 - t0;
      t0 = t1;
    }
  };
  int par = 0;  // the partials' buffer, flipped at every step taken
  int a_next = order[0];  // read a step ahead
  for (int k = 0; k < steps; ++k) {
    const int a = a_next;
    if (k + 1 < steps) a_next = order[k + 1];
    if (a < 0 || a >= na) continue;  // the same for every block: no barrier
    if (PROF && tid == 0) {
      t0 = clock64();
      kind = ftab[a].w != 0.f ? 0 : 1;
      clk[kind * (R_PHASES + 1) + R_PHASES] += 1;
    }
    // b[a], inv_row[a] and the band's inv_col_a[a], while the FP runs (the
    // last step's readers are past its closing barrier)
    const size_t ab = static_cast<size_t>(a) * nt;
    for (int j = tid; j < nt; j += R_NT) {
      copy_px(bsl + j, b + (ab + j) * ns + s0, b, valid, vec);
      tj::copy4(irow + j, inv_row + ab + j, inv_row, true);
    }
    if (px > 0) {
      const float* ic = inv_col_a + (static_cast<size_t>(a) * n + r0) * n;
      if (icvec) {
        for (int i = 4 * tid; i < px; i += 4 * R_NT) {
          tj::copy16(icol + i, ic + i, ic, true);
        }
      } else {
        for (int i = tid; i < px; i += R_NT) {
          tj::copy4(icol + i, ic + i, ic, true);
        }
      }
    }
    tj::copy_commit();
    phase(0);

    // FP partials of this block's band: (bin, phase) items on neighbouring
    // lanes, 4 slices each; phase 1's chain is added to phase 0's. The
    // buffer was last read remotely in the step before the last one taken,
    // before every block passed the last step's cluster barrier. Every
    // thread runs the same number of rounds (the shuffle needs the warp).
    const float4 ft = ftab[a];
    float4* pw = part + par * nt;
    for (int item0 = 0; item0 < 2 * nt; item0 += R_NT) {
      const int item = item0 + tid;
      const int j = item >> 1, ph = item & 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < nt) v = fp_band(band, rs, ft, n, nt, j, ph, r0, r1);
      const float4 w = make_float4(__shfl_xor_sync(0xffffffffu, v.x, 1),
                                   __shfl_xor_sync(0xffffffffu, v.y, 1),
                                   __shfl_xor_sync(0xffffffffu, v.z, 1),
                                   __shfl_xor_sync(0xffffffffu, v.w, 1));
      if (j < nt && ph == 0) {
        pw[j] = make_float4(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y),
                            __fadd_rn(v.z, w.z), __fadd_rn(v.w, w.w));
      }
    }
    if (PROF) __syncthreads();
    phase(1);
    tj::copy_wait();
    cluster.sync();  // every block's partials (and copies) are in place
    phase(2);

    // the residual plane, the same in every block: partials in rank order
    const float4* pr[R_BLOCKS];
#pragma unroll
    for (int r = 0; r < R_BLOCKS; ++r) {
      pr[r] = cluster.map_shared_rank(pw, r);
    }
    for (int j = tid; j < nt; j += R_NT) {
      float4 s = pr[0][j];
#pragma unroll
      for (int r = 1; r < R_BLOCKS; ++r) {
        const float4 v = pr[r][j];
        s.x = __fadd_rn(s.x, v.x);
        s.y = __fadd_rn(s.y, v.y);
        s.z = __fadd_rn(s.z, v.z);
        s.w = __fadd_rn(s.w, v.w);
      }
      const float4 bv = bsl[j];
      const float ir = irow[j];
      res[j] = make_float4(
          __fmul_rn(__fsub_rn(bv.x, __fmul_rn(s.x, ft.z)), ir),
          __fmul_rn(__fsub_rn(bv.y, __fmul_rn(s.y, ft.z)), ir),
          __fmul_rn(__fsub_rn(bv.z, __fmul_rn(s.z, ft.z)), ir),
          __fmul_rn(__fsub_rn(bv.w, __fmul_rn(s.w, ft.z)), ir));
    }
    __syncthreads();  // the residual plane is complete
    phase(3);

    // K8's update of every pixel of the band, in place
    const float4 t = btab[a];
    int c = c_first, rr = rr_first;
    for (int p = tid; p < px; p += R_NT) {
      const tj::BpTaps tp =
          tj::bp_taps<true>(t, static_cast<float>(c) - ctr,
                            ctr - static_cast<float>(r0 + rr), off);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 v0 = (tp.j0 >= 0 && tp.j0 < nt) ? res[tp.j0] : zero;
      const float4 v1 =
          (tp.j0 + 1 >= 0 && tp.j0 + 1 < nt) ? res[tp.j0 + 1] : zero;
      const float scale = __fmul_rn(bt, icol[p]);
      float4& xr = band[rr * rs + c];
      float4 xv = xr;
      xv.x = fmaxf(__fadd_rn(xv.x, __fmul_rn(scale, fmaf(v1.x, tp.w1, fmaf(
                                                   v0.x, tp.w0, 0.f)))),
                   0.f);
      xv.y = fmaxf(__fadd_rn(xv.y, __fmul_rn(scale, fmaf(v1.y, tp.w1, fmaf(
                                                   v0.y, tp.w0, 0.f)))),
                   0.f);
      xv.z = fmaxf(__fadd_rn(xv.z, __fmul_rn(scale, fmaf(v1.z, tp.w1, fmaf(
                                                   v0.z, tp.w0, 0.f)))),
                   0.f);
      xv.w = fmaxf(__fadd_rn(xv.w, __fmul_rn(scale, fmaf(v1.w, tp.w1, fmaf(
                                                   v0.w, tp.w0, 0.f)))),
                   0.f);
      xr = xv;
      c += c_step;
      rr += rr_step;
      if (c >= n) {
        c -= n;
        ++rr;
      }
    }
    __syncthreads();  // the band is updated; the copy buffers are free
    phase(4);
    par ^= 1;
  }
  // no block exits while another may still read its partials
  cluster.sync();
  float* os = out + static_cast<size_t>(r0) * n * ns + s0;
  for (int p = tid; p < px; p += R_NT) {
    tj::store4(os + static_cast<size_t>(p) * ns, band[p / n * rs + p % n],
               min(valid, R_SLICES), vec);
  }
  if (PROF && tid == 0) {
    long long* o = prof + static_cast<size_t>(blockIdx.x) * 2 *
                              (R_PHASES + 1);
    for (int i = 0; i < 2 * (R_PHASES + 1); ++i) o[i] = clk[i];
  }
}

template <bool PROF>
int resident_config(int n, int nt, int ns, cudaStream_t st,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  // once per instantiation, to the card's limit less the kernel's static
  // shared memory (PROF's counters)
  static bool opted = false;
  cudaFuncAttributes fa;
  int err = static_cast<int>(
      cudaFuncGetAttributes(&fa, sart_resident_kernel<PROF>));
  if (err != 0) return err;
  const int limit = tj::smem_limit() - static_cast<int>(fa.sharedSizeBytes);
  if (limit < 0 || resident_smem(n, nt) > static_cast<size_t>(limit)) {
    return cudaErrorInvalidValue;
  }
  err = tj::allow_smem(sart_resident_kernel<PROF>, limit, &opted);
  if (err != 0) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(R_BLOCKS * ((ns + R_SLICES - 1) / R_SLICES));
  cfg->blockDim = dim3(R_NT);
  cfg->dynamicSmemBytes = resident_smem(n, nt);
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R_BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <bool PROF>
int resident_sweep(const float* x, const float4* ft, const float4* bt,
                   const float* b, const float* inv_row,
                   const float* inv_col_a, const float* beta,
                   const int* order, int steps, float* out, int n, int nt,
                   int na, int ns, long long* prof, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int err = resident_config<PROF>(n, nt, ns, st, &cfg, attr);
  if (err != 0) return err;
  const bool vec = ns % 4 == 0 && tj::aligned16(x) && tj::aligned16(b) &&
                   tj::aligned16(out);
  const bool icvec = n % 4 == 0 && tj::aligned16(inv_col_a);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, sart_resident_kernel<PROF>, x, ft, bt, b, inv_row, inv_col_a,
      beta, order, steps, out, n, nt, na, ns, vec, icvec, prof);
  if (e != cudaSuccess) return static_cast<int>(e);
  return tj::launch_error();
}

}  // namespace

// x (N, N, Ns) input, out (N, N, Ns) result (may not alias x); fp_tab and
// bp_tab the (Na, 4) angle tables of cuda_joseph.angle_tables; b
// (Na, Nt, Ns); inv_row (Na, Nt); inv_col_a (Na, N, N); beta 1 float and
// order `steps` ints on the device; resid (Nt, Ns) floats of scratch for
// the streaming route (unused, may be null, on the resident one). The route
// is tj_sart_route(n, nt); a launch that fails returns its error and never
// takes the other route.
TJ_API int tj_sart_sweep(const float* x, const float* fp_tab,
                         const float* bp_tab, const float* b,
                         const float* inv_row, const float* inv_col_a,
                         const float* beta, const int* order, int steps,
                         float* resid, float* out, int n, int nt, int na,
                         int ns, void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || steps <= 0) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* ft = reinterpret_cast<const float4*>(fp_tab);
  const auto* bt = reinterpret_cast<const float4*>(bp_tab);
  if (!resident_route(n, nt)) {
    return streaming_sweep(x, ft, bt, b, inv_row, inv_col_a, beta, order,
                           steps, resid, out, n, nt, na, ns, st);
  }
  return resident_sweep<false>(x, ft, bt, b, inv_row, inv_col_a, beta, order,
                               steps, out, n, nt, na, ns, nullptr, st);
}

// tj_sart_sweep's resident route with its phases timed: prof holds, per
// block (8 a cluster, a cluster per 4 slices), {row-driven, column-driven}
// x {copy issue, FP, copy wait + cluster barrier, residual, update, steps}
// int64s (clock64 cycles of thread 0; the FP ends at a block barrier of its
// own).
TJ_API int tj_sart_resident_phases(const float* x, const float* fp_tab,
                                   const float* bp_tab, const float* b,
                                   const float* inv_row,
                                   const float* inv_col_a, const float* beta,
                                   const int* order, int steps, float* out,
                                   int n, int nt, int na, int ns,
                                   long long* prof, void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || steps <= 0 ||
      !resident_route(n, nt)) {
    return cudaErrorInvalidValue;
  }
  return resident_sweep<true>(
      x, reinterpret_cast<const float4*>(fp_tab),
      reinterpret_cast<const float4*>(bp_tab), b, inv_row, inv_col_a, beta,
      order, steps, out, n, nt, na, ns, prof,
      static_cast<cudaStream_t>(stream));
}

// 1 where tj_sart_sweep takes the resident route at this shape, else 0.
TJ_API int tj_sart_route(int n, int nt) {
  return n > 0 && nt > 0 && resident_route(n, nt) ? 1 : 0;
}

// *clusters: how many clusters of the resident route the card holds at
// once (cudaOccupancyMaxActiveClusters) for a launch at this shape.
TJ_API int tj_sart_active_clusters(int n, int nt, int ns, int* clusters) {
  if (n <= 0 || nt <= 0 || ns <= 0 || !resident_route(n, nt)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int err = resident_config<false>(n, nt, ns, nullptr, &cfg, attr);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, sart_resident_kernel<false>, &cfg));
}
