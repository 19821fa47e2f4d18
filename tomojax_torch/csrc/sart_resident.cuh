// The cluster-resident ordered SART sweep, one launch a sweep, shared by K8
// (sart.cu, the production sweep) and the experiment sweeps E3/E4
// (exp_sart.cu, exp_sart_shapes.cu). The TPU kernels kept the volume in
// VMEM for the whole sweep; here a thread-block cluster of BLOCKS blocks
// (one an SM) keeps SB slices of it in their shared memory, one Vec<SB>
// (float, float2 or float4) a pixel. Slices are independent 2D problems, so
// clusters need no grid barrier and the volume never goes back to device
// memory during the sweep. Block `rank` holds rows [rank R, (rank + 1) R),
// R = ceil(N / BLOCKS), of all N columns. Per step k, angle a = order[k]:
//   FP      every block walks, for each bin and its SB slices, only the
//           taps in its own rows: row-driven angles step over its R rows;
//           column-driven angles have taps along rows, and the block walks
//           the steps whose pos reaches [r0 - 1, r1) (pos is monotone in the
//           step; column_steps gives the range in closed form, widened by a
//           margin), reading 0 for a tap row outside the band. Each
//           in-volume tap lies in exactly one band. Two threads walk a ray,
//           on alternate steps of the band's range (phase 0 and 1), and the
//           second chain is added to the first: a column-driven ray crosses
//           a band of 32 rows in up to 139 steps at 76 degrees, a chain of
//           dependent loads and adds that one thread would walk alone.
//           Partials (bin, SB slices) go to a double-buffered plane in the
//           block's shared memory.
//   sync    one cluster barrier.
//   resid   every block adds the BLOCKS partials of every bin in rank order
//           through distributed shared memory (the same sums in every
//           block, no float atomics: repeatable bit for bit) and forms the
//           residual into its own plane.
//   update  each pixel of the band takes its update from the residual
//           plane, in place.
// b[a], inv_row[a] and the band's rows of inv_col_a[a] are copied with
// cp.async while the FP runs.
//
// The tap policy `Pol` holds the arithmetic: the weights of a ray's taps
// and how a tap pair adds to its sum (Pol::Ray), the residual, the update's
// taps and its scale; Pol::FP and Pol::UPDATE drop the FP walk (the
// residual from a zero sum) or the update. K8Taps (sart.cu) is K8's
// arithmetic, xp::SartTaps<MODE> (exp_sart.cuh) the experiment modes'.
//
// Shared memory of a block (resident_smem): band R (N + R_PAD) Vec<SB>,
// inv_col_a rows R N floats, partials, residual and b[a] 4 Nt Vec<SB>,
// inv_row[a] Nt floats; 183,296 B at N = Nt = 256 for K8's (8, 4), 216,064
// B at N = Nt = 512 for its (16, 2). The time
// of a step is its FP's and update's shared-memory reads and the cluster
// barrier; the volume is read and written once a sweep.
//
// The spilling layout (SPILL, one slice a pixel), for planes whose band no
// cluster's shared memory holds: inv_col_a[a] is not staged (the update
// reads it from device memory, coalesced; every cluster reads the same
// plane in the same step, so L2 serves it), and a block keeps only the
// first held_rows rows of its band in shared memory; the other spill_rows
// rows live in device memory (a scratch of (clusters, BLOCKS, spill_rows,
// N) pixels, each block's rows its own, small enough to stay in L2), where
// the FP reads and the update reads and writes them. 230,192 B a block at
// N = Nt = 1024 on 16 blocks: 51 rows held, 13 spilled. One slice a pixel
// shares no tap arithmetic between slices, so the layout saves work where
// it can:
//   FP      a row-driven angle's rays all walk the band's rows: a thread
//           walks its CHAINS rays together (fp_rows), so their loads
//           overlap; a column-driven angle's rays have ranges of their own
//           in the band, and only a window of bins reaches it, so they
//           are walked a ray a lane pair, round by round (fp_column);
//   resid   reduce-scatter: block r sums the partials of its sixteenth of
//           the bins, and after a second cluster barrier every block copies
//           the plane (2 Nt remote reads a block instead of BLOCKS Nt);
//   update  R_UNROLL pixels a thread at a time, their loads from L2 first.
// Every ray's taps, the partials' rank order and the update's rounding are
// the staged layout's, so each sum is the same to the bit.
#pragma once

#include <cooperative_groups.h>

#include "joseph.cuh"
#include "staging.cuh"

namespace tj {
namespace sr {

namespace cg = cooperative_groups;

constexpr int R_NT = 512;  // threads per block
// the shared memory one block may have on an H100 (227 KB, opt-in); routes
// and shapes are chosen against this constant, so they depend on the shape
// alone
constexpr size_t RESIDENT_SMEM_MAX = 232448;
// 2^-20: the column-driven step range's margin, in positions per unit of
// (2N + Nt + 8), eight times the rounding of pos (below 2^-24 (2N + Nt))
constexpr float STEP_SLACK = 9.5367431640625e-07f;
// The band's row stride is N + R_PAD pixels: the two FP threads of a ray
// read neighbouring rows (row-driven), which then fall in other banks.
constexpr int R_PAD = 4;
// The spilling layout's update: pixels a thread takes at a time, their loads
// issued before any of their arithmetic.
constexpr int R_UNROLL = 8;
// Phases of a step that a PROF instantiation times: the copies' issue, the
// FP, the wait for the copies and the cluster barrier, the residual, the
// update.
constexpr int R_PHASES = 5;

template <int SB>
struct VecOf;
template <>
struct VecOf<1> {
  using T = float;
};
template <>
struct VecOf<2> {
  using T = float2;
};
template <>
struct VecOf<4> {
  using T = float4;
};
template <int SB>
using Vec = typename VecOf<SB>::T;

template <int SB>
__device__ __forceinline__ float* lanes(Vec<SB>& v) {
  return reinterpret_cast<float*>(&v);
}

template <int SB>
__device__ __forceinline__ const float* lanes(const Vec<SB>& v) {
  return reinterpret_cast<const float*>(&v);
}

template <int SB>
__device__ __forceinline__ Vec<SB> vzero() {
  Vec<SB> v;
#pragma unroll
  for (int i = 0; i < SB; ++i) lanes<SB>(v)[i] = 0.f;
  return v;
}

// The first tap of a ray's step and the two taps' weights.
struct Tap {
  int i0;
  float w0, w1;
};

__host__ __device__ __forceinline__ int band_rows(int n, int blocks) {
  return (n + blocks - 1) / blocks;
}

// The rows of its band that a block of the spilling layout keeps in shared
// memory: as many as fit beside its partials, residual, b[a] and
// inv_row[a], at most the band. cuda_sart.held_rows mirrors it.
__host__ __device__ __forceinline__ int held_rows(int n, int nt, int blocks,
                                                  int sb) {
  const long long px = static_cast<long long>(sizeof(float)) * sb;
  const long long room =
      static_cast<long long>(RESIDENT_SMEM_MAX) -
      static_cast<long long>(nt) * (4 * px + static_cast<long long>(sizeof(float)));
  const long long fit = room > 0 ? room / ((n + R_PAD) * px) : 0;
  const int rows = band_rows(n, blocks);
  return fit < rows ? static_cast<int>(fit) : rows;
}

// The rows of its band that a block of the spilling layout keeps in device
// memory.
__host__ __device__ __forceinline__ int spill_rows(int n, int nt, int blocks,
                                                   int sb) {
  return band_rows(n, blocks) - held_rows(n, nt, blocks, sb);
}

// One block's shared memory, in this order: band (R rows of N + R_PAD
// Vec<SB>, x of its rows), partials (2 Nt Vec<SB>), the residual plane (Nt
// Vec<SB>), b[a] at the cluster's slices (Nt Vec<SB>), the band's
// inv_col_a[a] (R N floats), inv_row[a] (Nt floats). The spilling layout
// holds held_rows band rows and no inv_col_a.
// cuda_sart.resident_smem_bytes mirrors it.
inline size_t resident_smem(int n, int nt, int blocks, int sb,
                            bool spill = false) {
  const size_t px = sizeof(float) * sb;
  if (spill) {
    return static_cast<size_t>(held_rows(n, nt, blocks, sb)) * (n + R_PAD) *
               px +
           static_cast<size_t>(nt) * (4 * px + sizeof(float));
  }
  const size_t rows = band_rows(n, blocks);
  return rows * (n + R_PAD) * px + rows * n * sizeof(float) +
         static_cast<size_t>(nt) * (4 * px + sizeof(float));
}

// Whether a block fits: the staged layout's shared memory within the
// card's; the spilling layout's held rows at least 1 and its spilled rows
// at most a quarter of the band (a cut by design, not by measurement: on
// 16 blocks at Nt = N it spills from N = 919 and streams above N = 1052).
inline bool resident_fits(int n, int nt, int blocks, int sb,
                          bool spill = false) {
  if (spill) {
    const int rows = band_rows(n, blocks);
    const int held = held_rows(n, nt, blocks, sb);
    return held > 0 && 4 * (rows - held) <= rows;
  }
  return resident_smem(n, nt, blocks, sb) <= RESIDENT_SMEM_MAX;
}

// SB slices [s0, s0 + SB) of a pixel or bin at src (its slice s0) into
// shared dst: one 16- or 8-byte copy (vec: ns % SB == 0, rows aligned to
// 4 SB bytes) or 4-byte ones, zeros for the slices from `valid` on.
template <int SB>
__device__ __forceinline__ void copy_px(Vec<SB>* dst, const float* src,
                                        const float* safe, int valid,
                                        bool vec) {
  float* d = reinterpret_cast<float*>(dst);
  if constexpr (SB == 4) {
    if (vec) {
      tj::copy16(d, src, safe, true);
      return;
    }
  } else if constexpr (SB == 2) {
    if (vec) {
      tj::copy8(d, src, safe, true);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < SB; ++i) tj::copy4(d + i, src + i, safe, i < valid);
}

// The `valid` (>= 1) slices of a pixel below ns back to device memory.
template <int SB>
__device__ __forceinline__ void store_px(float* p, Vec<SB> v, int valid,
                                         bool vec) {
  if constexpr (SB == 4) {
    tj::store4(p, v, min(valid, 4), vec);
  } else if constexpr (SB == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = v;
    } else {
      p[0] = v.x;
      if (valid > 1) p[1] = v.y;
    }
  } else {
    p[0] = v;
  }
}

// The steps [k0, k1) in which a column-driven ray (u = ctr - base, shear
// sh) can reach rows [r0, r1): pos(k) = u + (k - ctr) sh, rounded, is
// monotone in k, and a tap row lies in the band when pos lies in [r0 - 1,
// r1). The closed form's ends are widened by 2 steps plus the rounding of
// pos over |sh|; a step of the range whose taps miss the band adds products
// of 0. cuda_sart.column_steps mirrors it.
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

// Phase `ph` (0 or 1) of one block's partial of ray j (SB slices) through
// its band rows [r0, r1), row stride rs: K1's positions (tj::fp_ray's) over
// every other step (ph, ph + 2, ...) of the steps whose taps can lie in the
// band, taps outside the band or the volume reading 0; `ray` gives each
// step's taps and weights and adds the pair to the sum.
template <int SB, class Ray>
__device__ __forceinline__ Vec<SB> fp_band(const Vec<SB>* band, int rs,
                                           const Ray& ray, float4 t, int n,
                                           int nt, int j, int ph, int r0,
                                           int r1) {
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float tdet =
      static_cast<float>(j) - 0.5f * static_cast<float>(nt - 1);
  const float base = __fmul_rn(tdet, t.x);
  const Vec<SB> zero = vzero<SB>();
  Vec<SB> acc = zero;
  if (t.w != 0.f) {  // row-driven: the steps are the band's rows
    for (int k = r0 + ph; k < r1; k += 2) {
      const float coord = ctr - static_cast<float>(k);
      const float pos = __fadd_rn(__fadd_rn(base, __fmul_rn(coord, t.y)),
                                  ctr);
      const Tap tp = ray.template tap<true>(k, pos);
      const Vec<SB>* row = band + (k - r0) * rs;
      const Vec<SB> v0 = (tp.i0 >= 0 && tp.i0 < n) ? row[tp.i0] : zero;
      const Vec<SB> v1 =
          (tp.i0 + 1 >= 0 && tp.i0 + 1 < n) ? row[tp.i0 + 1] : zero;
      ray.template add<SB>(acc, v0, v1, tp);
    }
  } else {  // column-driven: taps along rows, only those in the band
    const float u = __fsub_rn(ctr, base);
    int k0, k1;
    column_steps(u, t.y, n, nt, r0, r1, k0, k1);
    for (int k = k0 + ph; k < k1; k += 2) {
      const float coord = static_cast<float>(k) - ctr;
      const float pos = __fadd_rn(u, __fmul_rn(coord, t.y));
      const Tap tp = ray.template tap<false>(k, pos);
      const Vec<SB> v0 =
          (tp.i0 >= r0 && tp.i0 < r1) ? band[(tp.i0 - r0) * rs + k] : zero;
      const Vec<SB> v1 = (tp.i0 + 1 >= r0 && tp.i0 + 1 < r1)
                             ? band[(tp.i0 + 1 - r0) * rs + k]
                             : zero;
      ray.template add<SB>(acc, v0, v1, tp);
    }
  }
  return acc;
}

// A tap of the spilling layout's band: row r of the volume at column c,
// from shared memory for the band's first `held` rows, from the block's
// spilled rows sp (row stride n) after them, 0 outside the band [r0, r1):
// a predicated shared load and a predicated global one, with no branch and
// no generic address (which costs a 64-bit address and a branch a tap).
template <int SB>
__device__ __forceinline__ Vec<SB> band_tap(const Vec<SB>* band, int rs,
                                            const Vec<SB>* sp, int held,
                                            int n, int r0, int r1, int r,
                                            int c) {
  const int i = r - r0;
  const bool in = r >= r0 && r < r1;
  Vec<SB> v = vzero<SB>();
  if (in && i < held) v = band[i * rs + c];
  if (in && i >= held) v = sp[(i - held) * n + c];
  return v;
}

// The spilling layout's FP of a row-driven angle: fp_band for C rays of one
// phase walked together (bins j[q]; the caller drops the rays of bins from
// nt on): each step of the band's rows takes every ray's taps, so their
// loads and adds overlap instead of one dependent chain waiting on the
// next. Each ray takes its taps in fp_band's order, so acc[q] is fp_band's
// to the bit. Rows from `held` on are read from the spilled rows sp.
// ray_of(q) gives ray q's Pol::Ray.
template <int SB, int C, class RayOf>
__device__ __forceinline__ void fp_rows(const Vec<SB>* band, int rs,
                                        const Vec<SB>* sp, int held,
                                        const RayOf& ray_of, float4 t, int n,
                                        int nt, const int (&j)[C], int ph,
                                        int r0, int r1, Vec<SB> (&acc)[C]) {
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const Vec<SB> zero = vzero<SB>();
  float base[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const float tdet =
        static_cast<float>(j[q]) - 0.5f * static_cast<float>(nt - 1);
    base[q] = __fmul_rn(tdet, t.x);
    acc[q] = zero;
  }
  const auto step = [&](const Vec<SB>* row, int k) {
    const float coord = ctr - static_cast<float>(k);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const float pos =
          __fadd_rn(__fadd_rn(base[q], __fmul_rn(coord, t.y)), ctr);
      const auto ray = ray_of(q);
      const Tap tp = ray.template tap<true>(k, pos);
      const Vec<SB> v0 = (tp.i0 >= 0 && tp.i0 < n) ? row[tp.i0] : zero;
      const Vec<SB> v1 =
          (tp.i0 + 1 >= 0 && tp.i0 + 1 < n) ? row[tp.i0 + 1] : zero;
      ray.template add<SB>(acc[q], v0, v1, tp);
    }
  };
  const int split = min(r0 + held, r1);  // the first spilled row
  int k = r0 + ph;
  for (; k < split; k += 2) step(band + (k - r0) * rs, k);
  for (; k < r1; k += 2) step(sp + (k - r0 - held) * n, k);
}

// The spilling layout's FP of a column-driven angle: fp_band's column walk
// of ray j, phase ph, with its taps by band_tap (to the bit fp_band's).
template <int SB, class Ray>
__device__ __forceinline__ Vec<SB> fp_column(const Vec<SB>* band, int rs,
                                             const Vec<SB>* sp, int held,
                                             const Ray& ray, float4 t, int n,
                                             int nt, int j, int ph, int r0,
                                             int r1) {
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float tdet =
      static_cast<float>(j) - 0.5f * static_cast<float>(nt - 1);
  const float u = __fsub_rn(ctr, __fmul_rn(tdet, t.x));
  int k0, k1;
  column_steps(u, t.y, n, nt, r0, r1, k0, k1);
  Vec<SB> acc = vzero<SB>();
  for (int k = k0 + ph; k < k1; k += 2) {
    const float coord = static_cast<float>(k) - ctr;
    const float pos = __fadd_rn(u, __fmul_rn(coord, t.y));
    const Tap tp = ray.template tap<false>(k, pos);
    const Vec<SB> v0 = band_tap<SB>(band, rs, sp, held, n, r0, r1, tp.i0, k);
    const Vec<SB> v1 =
        band_tap<SB>(band, rs, sp, held, n, r0, r1, tp.i0 + 1, k);
    ray.template add<SB>(acc, v0, v1, tp);
  }
  return acc;
}

// x, b: vec (SB-slice pixels as one copy); inv_col_a: icvec (16-byte band
// rows). PROF: thread 0 of every block adds the clock64 cycles of each
// phase, per driving type, and the steps into prof[block][row, column]
// [R_PHASES + 1] (a block barrier after the FP separates it from the
// cluster barrier). SPILL: the spilling layout, block b's spilled rows at
// spill + b spill_rows N; CHAINS: the rays a thread walks together at a
// row-driven angle (fp_rows); SPILL false (and CHAINS 1) is the staged
// layout.
template <class Pol, int BLOCKS, int SB, bool PROF, bool SPILL = false,
          int CHAINS = 1>
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
                     bool vec, bool icvec, long long* __restrict__ prof,
                     const typename Pol::Params pp,
                     float* __restrict__ spill) {
  static_assert(!SPILL || SB == 1, "the spilling layout: a slice a pixel");
  static_assert(SPILL || CHAINS == 1, "chains are the spilling layout's");
  using V = Vec<SB>;
  extern __shared__ float4 rs_smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = band_rows(n, BLOCKS);
  const int r0 = rank * rows;
  const int r1 = min(r0 + rows, n);
  const int px = max(r1 - r0, 0) * n;  // pixels this block holds
  const int rs = n + R_PAD;             // the band's row stride (pixels)
  // band rows in shared memory; SPILL: pixels from p_held on are spilled
  const int held = SPILL ? held_rows(n, nt, BLOCKS, SB) : rows;
  const int p_held = held * n;
  V* band = reinterpret_cast<V*>(rs_smem4);
  V* part = band + static_cast<size_t>(held) * rs;  // [2][nt]
  V* res = part + 2 * nt;
  V* bsl = res + nt;
  float* icol = reinterpret_cast<float*>(bsl + nt);
  float* irow = SPILL ? icol : icol + static_cast<size_t>(rows) * n;
  V* sp = reinterpret_cast<V*>(spill) +
          static_cast<size_t>(blockIdx.x) * (rows - held) * n;
  const int tid = threadIdx.x;
  const int s0 = static_cast<int>(blockIdx.x / BLOCKS) * SB;
  const int valid = ns - s0;
  const float* xs = x + static_cast<size_t>(r0) * n * ns + s0;
  for (int p = tid; p < px; p += R_NT) {
    if constexpr (SPILL) {
      if (p >= p_held) {
        sp[p - p_held] = xs[static_cast<size_t>(p) * ns];
        continue;
      }
    }
    copy_px<SB>(band + p / n * rs + p % n, xs + static_cast<size_t>(p) * ns,
                x, valid, vec);
  }
  tj::copy_commit();
  tj::copy_wait();
  __syncthreads();  // the band is in place

  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const float bb = beta[0];
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
      copy_px<SB>(bsl + j, b + (ab + j) * ns + s0, b, valid, vec);
      tj::copy4(irow + j, inv_row + ab + j, inv_row, true);
    }
    if (!SPILL && px > 0) {
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
    // lanes, SB slices each; phase 1's chain is added to phase 0's. The
    // buffer was last read remotely in the step before the last one taken,
    // before every block passed the last step's cluster barrier. Every
    // thread runs the same number of rounds (the shuffle needs the warp).
    const float4 ft = ftab[a];
    V* pw = part + par * nt;
    if constexpr (Pol::FP && SPILL) {
      const int ph = tid & 1;
      // a partial of two phases, as below: lane ph 0 adds lane ph 1's
      const auto put = [&](int j, V v, bool own) {
        V w;
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          lanes<SB>(w)[i] = __shfl_xor_sync(0xffffffffu, lanes<SB>(v)[i], 1);
        }
        if (own && ph == 0) {
          V s;
#pragma unroll
          for (int i = 0; i < SB; ++i) {
            lanes<SB>(s)[i] = __fadd_rn(lanes<SB>(v)[i], lanes<SB>(w)[i]);
          }
          pw[j] = s;
        }
      };
      if (ft.w != 0.f) {
        // row-driven: every ray walks the band's rows, a thread's CHAINS
        // rays together. A warp's rays are CHAINS 16 neighbouring bins,
        // chain q of lane pair l bin 16 q + l, so that at each step the
        // lanes read neighbouring bins' taps
        const int g = CHAINS * 16 * (tid >> 5) + ((tid >> 1) & 15);
        for (int j0 = 0; j0 < nt; j0 += CHAINS * R_NT / 2) {
          int jq[CHAINS];
#pragma unroll
          for (int q = 0; q < CHAINS; ++q) jq[q] = j0 + g + 16 * q;
          const auto ray_of = [&](int q) {
            return typename Pol::Ray(pp, btab, a, min(jq[q], nt - 1), n, nt);
          };
          V v[CHAINS];
          fp_rows<SB, CHAINS>(band, rs, sp, held, ray_of, ft, n, nt, jq, ph,
                              r0, r1, v);
#pragma unroll
          for (int q = 0; q < CHAINS; ++q) put(jq[q], v[q], jq[q] < nt);
        }
      } else {
        // column-driven: only a window of bins reaches the band, so a
        // round takes R_NT / 2 neighbouring bins, one a lane pair, and the
        // rounds spread the window over every warp (a thread's bins
        // together would leave the warps outside the window idle)
        for (int j0 = 0; j0 < nt; j0 += R_NT / 2) {
          const int j = j0 + (tid >> 1);
          V v = vzero<SB>();
          if (j < nt) {
            const typename Pol::Ray ray(pp, btab, a, j, n, nt);
            v = fp_column<SB>(band, rs, sp, held, ray, ft, n, nt, j, ph, r0,
                              r1);
          }
          put(j, v, j < nt);
        }
      }
    } else if constexpr (Pol::FP) {
      for (int item0 = 0; item0 < 2 * nt; item0 += R_NT) {
        const int item = item0 + tid;
        const int j = item >> 1, ph = item & 1;
        V v = vzero<SB>();
        if (j < nt) {
          const typename Pol::Ray ray(pp, btab, a, j, n, nt);
          v = fp_band<SB>(band, rs, ray, ft, n, nt, j, ph, r0, r1);
        }
        V w;
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          lanes<SB>(w)[i] = __shfl_xor_sync(0xffffffffu, lanes<SB>(v)[i], 1);
        }
        if (j < nt && ph == 0) {
          V s;
#pragma unroll
          for (int i = 0; i < SB; ++i) {
            lanes<SB>(s)[i] = __fadd_rn(lanes<SB>(v)[i], lanes<SB>(w)[i]);
          }
          pw[j] = s;
        }
      }
    }
    if (PROF) __syncthreads();
    phase(1);
    tj::copy_wait();
    if constexpr (Pol::FP) {
      cluster.sync();  // every block's partials (and copies) are in place
    } else {
      __syncthreads();  // the copies are in place
    }
    phase(2);

    // the residual plane, the same in every block: partials in rank order
    // (no FP: a zero sum)
    const float4 bt = btab[a];
    const V* pr[BLOCKS];
    if constexpr (Pol::FP) {
#pragma unroll
      for (int r = 0; r < BLOCKS; ++r) {
        pr[r] = cluster.map_shared_rank(pw, r);
      }
    }
    // SPILL: block rank forms the residual of its chunk of cb bins alone,
    // then, past a cluster barrier, every block copies the other chunks
    // (2 Nt remote reads a block instead of BLOCKS Nt)
    const int cb = SPILL ? (nt + BLOCKS - 1) / BLOCKS : nt;
    const int j_lo = SPILL ? rank * cb : 0;
    const int j_hi = SPILL ? min(j_lo + cb, nt) : nt;
    for (int j = j_lo + tid; j < j_hi; j += R_NT) {
      V s = vzero<SB>();
      if constexpr (Pol::FP) {
        s = pr[0][j];
#pragma unroll
        for (int r = 1; r < BLOCKS; ++r) {
          const V v = pr[r][j];
#pragma unroll
          for (int i = 0; i < SB; ++i) {
            lanes<SB>(s)[i] = __fadd_rn(lanes<SB>(s)[i], lanes<SB>(v)[i]);
          }
        }
      }
      const V bv = bsl[j];
      const float ir = irow[j];
      V rv;
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        lanes<SB>(rv)[i] =
            Pol::resid(lanes<SB>(s)[i], lanes<SB>(bv)[i], ir, ft, bt);
      }
      res[j] = rv;
    }
    if constexpr (SPILL && Pol::FP) {  // the residual by reduce-scatter
      cluster.sync();  // every chunk is in place
      for (int j = tid; j < nt; j += R_NT) {
        const int o = j / cb;
        if (o != rank) res[j] = cluster.map_shared_rank(res, o)[j];
      }
    }
    __syncthreads();  // the residual plane is complete
    phase(3);

    // the update of every pixel of the band, in place
    if constexpr (Pol::UPDATE && SPILL) {
      // R_UNROLL pixels a thread at a time, their loads first: inv_col_a[a]'s
      // band rows and the spilled rows come from L2, so R_UNROLL loads are
      // in flight (a batch wholly inside the band, as every batch is where
      // px is a multiple of R_UNROLL R_NT, checks no bound a pixel; each
      // pixel's arithmetic stays behind its own check all the same, which
      // keeps the compiler from sinking the loads to their uses)
      const float* ic = inv_col_a + (static_cast<size_t>(a) * n + r0) * n;
      int c = c_first, rr = rr_first;
      const auto advance = [&](int& cc, int& rw) {
        cc += c_step;
        rw += rr_step;
        if (cc >= n) {
          cc -= n;
          ++rw;
        }
      };
      for (int p0 = tid; p0 < px; p0 += R_UNROLL * R_NT) {
        const bool whole = p0 - tid + R_UNROLL * R_NT <= px;
        float icv[R_UNROLL];
        V xv[R_UNROLL];
        int cl = c, rl = rr;  // the loads' walk; the arithmetic walks again
#pragma unroll
        for (int u = 0; u < R_UNROLL; ++u) {
          const int p = p0 + u * R_NT;
          if (whole || p < px) {
            icv[u] = ic[p];
            xv[u] = p < p_held ? band[rl * rs + cl] : sp[p - p_held];
          }
          advance(cl, rl);
        }
#pragma unroll
        for (int u = 0; u < R_UNROLL; ++u) {
          const int p = p0 + u * R_NT;
          if (whole || p < px) {
            const tj::BpTaps tp =
                Pol::bp(pp, bt, a, r0 + rr, c, static_cast<float>(c) - ctr,
                        ctr - static_cast<float>(r0 + rr), off, n);
            const V zero = vzero<SB>();
            const V v0 = (tp.j0 >= 0 && tp.j0 < nt) ? res[tp.j0] : zero;
            const V v1 =
                (tp.j0 + 1 >= 0 && tp.j0 + 1 < nt) ? res[tp.j0 + 1] : zero;
            const float scale = Pol::scale(bb, bt, icv[u]);
#pragma unroll
            for (int i = 0; i < SB; ++i) {
              float& xi = lanes<SB>(xv[u])[i];
              xi = fmaxf(__fadd_rn(xi, __fmul_rn(scale, Pol::upd(
                                                       lanes<SB>(v0)[i],
                                                       lanes<SB>(v1)[i], tp))),
                         0.f);
            }
            if (p < p_held) {
              band[rr * rs + c] = xv[u];
            } else {
              sp[p - p_held] = xv[u];
            }
          }
          advance(c, rr);
        }
      }
    } else if constexpr (Pol::UPDATE) {
      int c = c_first, rr = rr_first;
      for (int p = tid; p < px; p += R_NT) {
        const tj::BpTaps tp =
            Pol::bp(pp, bt, a, r0 + rr, c, static_cast<float>(c) - ctr,
                    ctr - static_cast<float>(r0 + rr), off, n);
        const V zero = vzero<SB>();
        const V v0 = (tp.j0 >= 0 && tp.j0 < nt) ? res[tp.j0] : zero;
        const V v1 = (tp.j0 + 1 >= 0 && tp.j0 + 1 < nt) ? res[tp.j0 + 1]
                                                        : zero;
        const float scale = Pol::scale(bb, bt, icol[p]);
        V& xr = band[rr * rs + c];
        V xv = xr;
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          float& xi = lanes<SB>(xv)[i];
          xi = fmaxf(__fadd_rn(xi, __fmul_rn(scale, Pol::upd(
                                                   lanes<SB>(v0)[i],
                                                   lanes<SB>(v1)[i], tp))),
                     0.f);
        }
        xr = xv;
        c += c_step;
        rr += rr_step;
        if (c >= n) {
          c -= n;
          ++rr;
        }
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
    if constexpr (SPILL) {
      if (p >= p_held) {
        store_px<SB>(os + static_cast<size_t>(p) * ns, sp[p - p_held], valid,
                     vec);
        continue;
      }
    }
    store_px<SB>(os + static_cast<size_t>(p) * ns, band[p / n * rs + p % n],
                 valid, vec);
  }
  if (PROF && tid == 0) {
    long long* o = prof + static_cast<size_t>(blockIdx.x) * 2 *
                              (R_PHASES + 1);
    for (int i = 0; i < 2 * (R_PHASES + 1); ++i) o[i] = clk[i];
  }
}

// The launch of one instantiation at this shape: its shared memory opted
// in (once, to the card's limit less the kernel's static shared memory),
// clusters of BLOCKS blocks (above 8: the non-portable cluster size allowed
// once), one cluster per SB slices. Refuses a shape whose block does not
// fit.
template <class Pol, int BLOCKS, int SB, bool PROF, bool SPILL = false,
          int CHAINS = 1>
int resident_config(int n, int nt, int ns, cudaStream_t st,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  static bool opted = false;
  const auto kernel = sart_resident_kernel<Pol, BLOCKS, SB, PROF, SPILL,
                                           CHAINS>;
  cudaFuncAttributes fa;
  int err = static_cast<int>(cudaFuncGetAttributes(&fa, kernel));
  if (err != 0) return err;
  const int limit = tj::smem_limit() - static_cast<int>(fa.sharedSizeBytes);
  const size_t smem = resident_smem(n, nt, BLOCKS, SB, SPILL);
  if (limit < 0 || smem > static_cast<size_t>(limit) ||
      !resident_fits(n, nt, BLOCKS, SB, SPILL)) {
    return cudaErrorInvalidValue;
  }
  err = tj::allow_smem(kernel, limit, &opted);
  if (err != 0) return err;
  if constexpr (BLOCKS > 8) {
    static bool wide = false;
    if (!wide) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) {
        cudaGetLastError();
        return static_cast<int>(e);
      }
      wide = true;
    }
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(BLOCKS * ((ns + SB - 1) / SB));
  cfg->blockDim = dim3(R_NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// One sweep over order[0 .. steps) of x into out (which may not alias x).
// SPILL: spill holds (clusters, BLOCKS, spill_rows, N) pixels, where
// spill_rows > 0. A launch that fails returns its error.
template <class Pol, int BLOCKS, int SB, bool PROF, bool SPILL = false,
          int CHAINS = 1>
int resident_sweep(const float* x, const float4* ft, const float4* bt,
                   const float* b, const float* inv_row,
                   const float* inv_col_a, const float* beta,
                   const int* order, int steps, float* out, int n, int nt,
                   int na, int ns, long long* prof,
                   const typename Pol::Params& pp, cudaStream_t st,
                   float* spill = nullptr) {
  if (SPILL && spill == nullptr && spill_rows(n, nt, BLOCKS, SB) > 0) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int err = resident_config<Pol, BLOCKS, SB, PROF, SPILL, CHAINS>(
      n, nt, ns, st, &cfg, attr);
  if (err != 0) return err;
  const size_t px_bytes = sizeof(float) * SB;
  const bool vec = ns % SB == 0 && tj::aligned_to(x, px_bytes) &&
                   tj::aligned_to(b, px_bytes) &&
                   tj::aligned_to(out, px_bytes);
  const bool icvec = n % 4 == 0 && tj::aligned16(inv_col_a);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, sart_resident_kernel<Pol, BLOCKS, SB, PROF, SPILL, CHAINS>, x, ft,
      bt, b, inv_row, inv_col_a, beta, order, steps, out, n, nt, na, ns, vec,
      icvec, prof, pp, spill);
  if (e != cudaSuccess) return static_cast<int>(e);
  return tj::launch_error();
}

// *clusters: how many clusters of this instantiation the card holds at
// once (cudaOccupancyMaxActiveClusters) for a launch at this shape.
template <class Pol, int BLOCKS, int SB, bool SPILL = false, int CHAINS = 1>
int active_clusters(int n, int nt, int ns, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int err = resident_config<Pol, BLOCKS, SB, false, SPILL, CHAINS>(
      n, nt, ns, nullptr, &cfg, attr);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, sart_resident_kernel<Pol, BLOCKS, SB, false, SPILL, CHAINS>,
      &cfg));
}

}  // namespace sr
}  // namespace tj
