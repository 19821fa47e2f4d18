// A1, the ART sweep: the kernel template shared by art.cu (the sweep) and
// art_split.cu (its variants, which split a ray's time). The design and
// its numbers are noted at the head of art.cu.
#pragma once

#include "common.cuh"
#include "staging.cuh"

namespace tj_art {

constexpr int A_R = 8;       // rays staged ahead (b, the ray's row)
constexpr int A_D = 4;       // rays ahead of the L2 prefetch of x (< A_R)
constexpr int A_RING = 16;   // slots of the ray rings (> A_R)
constexpr int A_ORING = 32;  // slots of the order ring (>= 2 A_R)
// cp.async groups a thread may leave pending at a ray's barrier: the copies
// of ray k + A_D must be visible by ray k's prefetch
constexpr int A_PENDING = A_R - A_D - 1;
constexpr int A_PHASES = 8;  // PROF: the phases of a ray (cuda_art.PHASES)

// slices a block SL -> slices a thread VS, threads a step group L, step
// groups a warp Q, warps a block at most W; steps a thread KS where N
// allows (more warps: more of the chain's latency hidden), else KL
// (cuda_art.art_config; KS measured at 256^3 x 90, chip_smoke.py)
template <int SL>
struct Cfg {
  static constexpr int VS = SL < 4 ? SL : 4;
  static constexpr int L = SL / VS;
  static constexpr int Q = 32 / L;
  static constexpr int W = SL <= 2 ? 16 : 8;
  static constexpr int KS = SL <= 4 ? 1 : 2;
  static constexpr int KL = SL == 1 ? 8 : 4;
  static constexpr int MAX_N = W * Q * KL;
};

// Variants (bits; tj_art_variant): NOLOAD takes every pixel value from
// registers (the values the thread last held) in place of x; NORED takes
// the warp's sum for the block's (no shared partials; the barrier stays,
// it publishes the staged rays); NOSTORE writes no update; NOPREF issues
// no L2 prefetch (NOLOAD | NOSTORE | NOPREF: the chain alone); PROF counts
// thread 0's cycles per phase of a ray. Their results are not the
// sweep's.
enum Variant {
  FULL = 0, NOLOAD = 1, NORED = 2, NOSTORE = 4, NOPREF = 8, PROF = 16
};

// cp.async of 4 (16) bytes from src to shared dst where `go`, zeros where
// go && !ok (src then unread), nothing where !go: a predicate, no branch.
__device__ __forceinline__ void stage4(bool go, void* dst, const void* src,
                                       bool ok) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4, %2;\n}\n" ::"r"(
          tj::smem_addr(dst)),
      "l"(src), "r"(ok ? 4 : 0), "r"(static_cast<int>(go)));
}

__device__ __forceinline__ void stage16(bool go, void* dst, const void* src,
                                        bool ok) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n" ::"r"(
          tj::smem_addr(dst)),
      "l"(src), "r"(ok ? 16 : 0), "r"(static_cast<int>(go)));
}

template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// VS slices of one pixel at p, of which nv (<= 0: none) lie below ns: one
// vector access (VEC: Ns % VS == 0, so nv is 0 or VS), else one float
// each.
template <int VS, bool VEC>
__device__ __forceinline__ void load_px(float (&v)[VS], const float* p,
                                        int nv) {
  if constexpr (VEC && VS == 4) {
    if (nv > 0) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    }
  } else if constexpr (VEC && VS == 2) {
    if (nv > 0) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      v[0] = t.x, v[1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VS; ++e) {
      if (e < nv) v[e] = p[e];
    }
  }
}

template <int VS, bool VEC>
__device__ __forceinline__ void store_px(float* p, const float (&v)[VS],
                                         int nv) {
  if constexpr (VEC && VS == 4) {
    if (nv > 0) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else if constexpr (VEC && VS == 2) {
    if (nv > 0) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < VS; ++e) {
      if (e < nv) p[e] = v[e];
    }
  }
}

// Step m of a ray: its two taps' clipped indices along the interpolated
// axis and their weights, in the reference's float32 order, from the ray's
// row {t1 = t_j / divisor, sh, scale, row_driven} (cuda_art.art_table)
// and cm = ctr - m (row-driven) or m - ctr.
struct Tap {
  int c0, c1;
  float w0, w1;
};

__device__ __forceinline__ Tap ray_tap(float4 row, float cm_row,
                                       float cm_col, float ctr, int n) {
  const bool rd = row.w != 0.f;
  const float pos =
      rd ? __fadd_rn(__fadd_rn(row.x, __fmul_rn(cm_row, row.y)), ctr)
         : __fadd_rn(__fsub_rn(ctr, row.x), __fmul_rn(cm_col, row.y));
  const float f = floorf(pos);
  const float frac = __fsub_rn(pos, f);
  const int i0 = static_cast<int>(f);
  const int i1 = i0 + 1;
  Tap t;
  t.w0 = __fmul_rn((i0 >= 0 && i0 < n) ? __fsub_rn(1.f, frac) : 0.f, row.z);
  t.w1 = __fmul_rn((i1 >= 0 && i1 < n) ? frac : 0.f, row.z);
  t.c0 = min(max(i0, 0), n - 1);
  t.c1 = min(max(i1, 0), n - 1);
  return t;
}

// This thread's slices of pixel c of step m (row m, or column m).
__device__ __forceinline__ float* px(float* xs, bool rd, int m, int c, int n,
                                     int ns) {
  const unsigned p = static_cast<unsigned>(rd ? m * n + c : c * n + m);
  return xs + static_cast<size_t>(p) * static_cast<unsigned>(ns);
}

// x updated in place (the wrapper passes a copy); rtab (Na Nt) float4 per
// ray {t1, sh, scale, row_driven}; order `count` rays; K steps a thread.
// PROF: thread 0 of each block adds the clock64 cycles of each phase of
// its valid rays, then their count, into prof[block][A_PHASES + 1].
template <int SL, int K, int V, bool VEC>
__global__ void __launch_bounds__(Cfg<SL>::W * 32)
art_sweep_kernel(float* __restrict__ x, const float* __restrict__ b,
                 const float4* __restrict__ rtab,
                 const int* __restrict__ order, int count, float beta,
                 int n, int rays, int ns, long long* __restrict__ prof) {
  using C = Cfg<SL>;
  constexpr int VS = C::VS, L = C::L;
  constexpr int W4 = (C::W + 3) / 4 * 4;  // the warps' partials, padded
  __shared__ int oring[A_ORING];
  __shared__ float4 tring[A_RING];
  __shared__ float bring[A_RING][SL];
  __shared__ __align__(16) float part[2][SL][W4];  // per slice, per warp
  __shared__ __align__(16) float npart[2][W4];
  const int lane = threadIdx.x;  // slice lane
  const int g = threadIdx.y;     // step group
  const int G = blockDim.y;
  const int nthreads = L * G;
  const int tid = lane + L * g;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int sb = blockIdx.x * SL;  // the block's first slice
  const int s0 = sb + lane * VS;   // this thread's
  const int nv = min(max(ns - s0, 0), VS);
  const float ctr = 0.5f * static_cast<float>(n - 1);
  float* const xs = x + s0;
  long long acc[A_PHASES + 1] = {};
  long long t_prev = 0;
  auto mark = [&](int ph) {
    if ((V & PROF) && tid == 0) {
      const long long t = clock64();
      acc[ph] += t - t_prev;
      t_prev = t;
    }
  };

  // the rings' first rays, read directly; the partials zeroed (a warp
  // beyond the block's adds 0)
  for (int i = tid; i < 2 * A_R; i += nthreads) {
    oring[i] = i < count ? order[i] : -1;
  }
  for (int i = tid; i < 2 * SL * W4; i += nthreads) (&part[0][0][0])[i] = 0.f;
  for (int i = tid; i < 2 * W4; i += nthreads) (&npart[0][0])[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < A_R * SL; i += nthreads) {
    const int kk = i / SL, e = i - kk * SL;
    const int r = oring[kk];
    const bool ok = r >= 0 && r < rays;
    bring[kk][e] =
        ok && sb + e < ns ? b[static_cast<size_t>(r) * ns + sb + e] : 0.f;
    if (e == 0) tring[kk] = ok ? rtab[r] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // per step: in range (and with slices below ns: mem), cm for both axes
  bool in[K], mem[K];
  float cmr[K], cmc[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int m = g + q * G;
    in[q] = m < n;
    mem[q] = in[q] && nv > 0;
    cmr[q] = __fsub_rn(ctr, static_cast<float>(m));
    cmc[q] = __fsub_rn(static_cast<float>(m), ctr);
  }
  Tap tp[K];
  float v0[K][VS], v1[K][VS];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    tp[q] = Tap{0, 0, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < VS; ++e) v0[q][e] = v1[q][e] = 0.f;
  }
  bool have = false;  // this ray's taps and values are in registers
  int prev_rd = -1, buf = 0;
  int pc0[K], pc1[K];  // the taps of the last L2 prefetch
  bool pf_ok = false, pf_rd = false;
  // the ring entries a ray reads first, read one ray ahead of their use:
  // this ray and its row, the next ray and its row, the ray staged now
  int r = oring[0], r1 = count > 1 ? oring[1] : -1;
  float4 row = tring[0], row1 = tring[1];
  int rr = A_R < count ? oring[A_R] : -1;
  for (int k = 0; k < count; ++k) {
    if ((V & PROF) && tid == 0) t_prev = clock64();
    {  // stage ray k + A_R and the order entry k + 2 A_R
      const int ko = k + 2 * A_R;
      const int kk = k + A_R;
      const bool ok = rr >= 0 && rr < rays;
      stage4(tid == 0, &oring[ko & (A_ORING - 1)],
             order + (ko < count ? ko : 0), ko < count);
      stage16(tid == 0, &tring[kk & (A_RING - 1)], rtab + (ok ? rr : 0), ok);
      stage4(tid < SL, &bring[kk & (A_RING - 1)][tid < SL ? tid : 0],
             b + (ok ? static_cast<size_t>(rr) * ns + sb + tid : 0),
             ok && sb + tid < ns);
      tj::copy_commit();
      rr = kk + 1 < count ? oring[(kk + 1) & (A_ORING - 1)] : -1;
    }
    // ray k + 2, read now for the next ray's carry and header
    const int r2 = k + 2 < count ? oring[(k + 2) & (A_ORING - 1)] : -1;
    const float4 row2 = tring[(k + 2) & (A_RING - 1)];
    if (r < 0 || r >= rays) {  // uniform over the block: x stays
      stage_wait<A_PENDING>();
      __syncthreads();
      have = pf_ok = false;
      r = r1, r1 = r2;
      row = row1, row1 = row2;
      continue;
    }
    mark(0);
    const bool rd = row.w != 0.f;
    if (!have) {  // the full fetch, after the previous ray's stores
      if (prev_rd >= 0 && static_cast<int>(rd) != prev_rd) __syncthreads();
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int m = g + q * G;
        tp[q] = ray_tap(row, cmr[q], cmc[q], ctr, n);
        if (!(V & NOLOAD) && mem[q]) {
          load_px<VS, VEC>(v0[q], px(xs, rd, m, tp[q].c0, n, ns), nv);
          load_px<VS, VEC>(v1[q], px(xs, rd, m, tp[q].c1, n, ns), nv);
        }
      }
    }
    prev_rd = rd;
    mark(1);

    const bool carry = r1 >= 0 && r1 < rays && (row1.w != 0.f) == rd;
    Tap tn[K];
    float l0[K][VS], l1[K][VS];

    // dot and nsq: a thread's steps as a tree, then the warp's butterfly
    float dot[VS], nsq;
    {
      float td[K][VS], tq[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        tq[q] = in[q] ? __fadd_rn(__fmul_rn(tp[q].w0, tp[q].w0),
                                  __fmul_rn(tp[q].w1, tp[q].w1))
                      : 0.f;
#pragma unroll
        for (int e = 0; e < VS; ++e) {
          td[q][e] = in[q] ? __fadd_rn(__fmul_rn(v0[q][e], tp[q].w0),
                                       __fmul_rn(v1[q][e], tp[q].w1))
                           : 0.f;
        }
      }
#pragma unroll
      for (int h = 1; h < K; h <<= 1) {
#pragma unroll
        for (int q = 0; q + h < K; q += 2 * h) {
          tq[q] = __fadd_rn(tq[q], tq[q + h]);
#pragma unroll
          for (int e = 0; e < VS; ++e) {
            td[q][e] = __fadd_rn(td[q][e], td[q + h][e]);
          }
        }
      }
      nsq = tq[0];
#pragma unroll
      for (int e = 0; e < VS; ++e) dot[e] = td[0][e];
    }
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < VS; ++e) {
        dot[e] = __fadd_rn(dot[e], __shfl_xor_sync(0xffffffffu, dot[e], o));
      }
      nsq = __fadd_rn(nsq, __shfl_xor_sync(0xffffffffu, nsq, o));
    }
    constexpr bool RED = !(V & NORED);  // the warps' partials
    if (RED && (tid & 31) < L) {  // step group 0 of the warp
#pragma unroll
      for (int e = 0; e < VS; ++e) part[buf][lane * VS + e][warp] = dot[e];
      if (lane == 0) npart[buf][warp] = nsq;
    }
    const float bv0 = bring[k & (A_RING - 1)][lane * VS];  // b, loaded early
    mark(2);
    // ray k + 1, carried where it keeps the driving axis: its pixels that
    // ray k does not write are loaded now, before k's stores (and after the
    // ray's shuffles and partials, which would queue behind the loads)
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int m = g + q * G;
      tn[q] = ray_tap(row1, cmr[q], cmc[q], ctr, n);
#pragma unroll
      for (int e = 0; e < VS; ++e) {
        l0[q][e] = (V & NOLOAD) ? v0[q][e] : 0.f;
        l1[q][e] = (V & NOLOAD) ? v1[q][e] : 0.f;
      }
      const bool ld = !(V & NOLOAD) && carry && mem[q];
      if (ld && tn[q].c0 != tp[q].c0 && tn[q].c0 != tp[q].c1) {
        load_px<VS, VEC>(l0[q], px(xs, rd, m, tn[q].c0, n, ns), nv);
      }
      if (ld && tn[q].c1 != tp[q].c0 && tn[q].c1 != tp[q].c1) {
        load_px<VS, VEC>(l1[q], px(xs, rd, m, tn[q].c1, n, ns), nv);
      }
    }
    mark(3);
    stage_wait<A_PENDING>();
    __syncthreads();
    mark(4);
    if (RED) {  // the warps' partials in order, four a load
      nsq = 0.f;
#pragma unroll
      for (int e = 0; e < VS; ++e) dot[e] = 0.f;
      for (int w0 = 0; w0 < nwarps; w0 += 4) {
        const float4 pq = *reinterpret_cast<const float4*>(&npart[buf][w0]);
        float4 pd[VS];
#pragma unroll
        for (int e = 0; e < VS; ++e) {
          pd[e] = *reinterpret_cast<const float4*>(
              &part[buf][lane * VS + e][w0]);
        }
        nsq = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(nsq, pq.x), pq.y),
                                  pq.z), pq.w);
#pragma unroll
        for (int e = 0; e < VS; ++e) {
          dot[e] = __fadd_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(dot[e], pd[e].x), pd[e].y),
                        pd[e].z),
              pd[e].w);
        }
      }
      buf ^= 1;
    }
    mark(5);
    // ray k + A_D: its pixels into L2, those that ray k + A_D - 1 (the
    // previous prefetch, where it kept the axis) did not take; after the
    // partials' loads, so that those do not queue behind it. A prefetch
    // brings a 32-byte sector (8 slices) for every block that shares it
    if (!(V & NOPREF)) {
      constexpr int PF = SL < 8 ? 8 / SL : 1;
      const int kd = k + A_D;
      const int rD = kd < count ? oring[kd & (A_ORING - 1)] : -1;
      const float4 rowD = tring[kd & (A_RING - 1)];
      const bool okD = rD >= 0 && rD < rays;
      const bool rdD = rowD.w != 0.f;
      const bool cont = pf_ok && rdD == pf_rd;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int m = g + q * G;
        const Tap t = ray_tap(rowD, cmr[q], cmc[q], ctr, n);
        // the PF blocks whose slices share a 32-byte sector split it by step
        const bool go = okD && mem[q] &&
                        m % PF == static_cast<int>(blockIdx.x) % PF;
        if (go && (!cont || (t.c0 != pc0[q] && t.c0 != pc1[q]))) {
          prefetch_l2(px(xs, rdD, m, t.c0, n, ns));
        }
        if (go && t.c1 != t.c0 &&
            (!cont || (t.c1 != pc0[q] && t.c1 != pc1[q]))) {
          prefetch_l2(px(xs, rdD, m, t.c1, n, ns));
        }
        pc0[q] = t.c0;
        pc1[q] = t.c1;
      }
      pf_ok = okD;
      pf_rd = rdD;
    }
    mark(6);
    // coeff = beta (b - dot) / max(nsq, 1e-12), one IEEE division; a zero
    // numerator (a ray through empty space) is its own quotient (den > 0),
    // so 1 is divided in its place: the same result without the
    // division's slow path, which zero dividends take
    float coeff[VS];
    const float den = fmaxf(nsq, 1e-12f);
#pragma unroll
    for (int e = 0; e < VS; ++e) {
      const float bv = e == 0 ? bv0 : bring[k & (A_RING - 1)][lane * VS + e];
      const float num = __fmul_rn(beta, __fsub_rn(bv, dot[e]));
      const float q = __fdiv_rn(num != 0.f ? num : 1.f, den);
      coeff[e] = num != 0.f ? q : num;
    }

    // the update: stores, then ray k + 1's values
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int m = g + q * G;
      float u0[VS], u1[VS];
      const bool same = tp[q].c0 == tp[q].c1;
#pragma unroll
      for (int e = 0; e < VS; ++e) {
        const float a = __fadd_rn(v0[q][e], __fmul_rn(coeff[e], tp[q].w0));
        u0[e] = same ? __fadd_rn(a, __fmul_rn(coeff[e], tp[q].w1)) : a;
        u1[e] = same ? u0[e]
                     : __fadd_rn(v1[q][e], __fmul_rn(coeff[e], tp[q].w1));
      }
      // a pixel that ray k + 1 carries is stored by the ray that lets it go
      const int a0 = tn[q].c0, a1 = tn[q].c1;
      const bool keep0 = carry && (a0 == tp[q].c0 || a1 == tp[q].c0);
      const bool keep1 = carry && (a0 == tp[q].c1 || a1 == tp[q].c1);
      const bool st = !(V & NOSTORE) && mem[q];
      if (st && !keep0) {
        store_px<VS, VEC>(px(xs, rd, m, tp[q].c0, n, ns), u0, nv);
      }
      if (st && !same && !keep1) {
        store_px<VS, VEC>(px(xs, rd, m, tp[q].c1, n, ns), u1, nv);
      }
#pragma unroll
      for (int e = 0; e < VS; ++e) {
        const float n0 = a0 == tp[q].c0 ? u0[e] : a0 == tp[q].c1 ? u1[e]
                                                                 : l0[q][e];
        const float n1 = a1 == tp[q].c0 ? u0[e] : a1 == tp[q].c1 ? u1[e]
                                                                 : l1[q][e];
        v0[q][e] = carry ? n0 : (V & NOLOAD) ? u0[e] : v0[q][e];
        v1[q][e] = carry ? n1 : (V & NOLOAD) ? u1[e] : v1[q][e];
      }
      if (carry) tp[q] = tn[q];
    }
    have = carry;
    r = r1, r1 = r2;
    row = row1, row1 = row2;
    mark(7);
    if ((V & PROF) && tid == 0) ++acc[A_PHASES];
  }
  tj::copy_wait();
  if ((V & PROF) && tid == 0) {
#pragma unroll
    for (int p = 0; p <= A_PHASES; ++p) {
      prof[static_cast<size_t>(blockIdx.x) * (A_PHASES + 1) + p] = acc[p];
    }
  }
}

// Launch one sweep: K = KS steps a thread where N allows, else KL; the
// vector path where Ns % VS == 0 and x is aligned to VS floats (the
// variants take only that path).
template <int SL, int V>
int launch(float* x, const float* b, const float4* rtab, const int* order,
           int count, float beta, int n, int rays, int ns, long long* prof,
           cudaStream_t st) {
  using C = Cfg<SL>;
  const int ws = (n + C::Q * C::KS - 1) / (C::Q * C::KS);
  const int wl = (n + C::Q * C::KL - 1) / (C::Q * C::KL);
  const bool small = ws <= C::W;
  const bool vec = ns % C::VS == 0 && tj::aligned_to(x, 4 * C::VS);
  if (wl > C::W || (V != FULL && !vec)) return cudaErrorInvalidValue;
  const dim3 block(C::L, C::Q * (small ? ws : wl));
  const dim3 grid((ns + SL - 1) / SL);
#define TJ_ART_GO(K_, VEC_)                                             \
  art_sweep_kernel<SL, K_, V, VEC_><<<grid, block, 0, st>>>(           \
      x, b, rtab, order, count, beta, n, rays, ns, prof)
  if (vec) {
    if (small) {
      TJ_ART_GO(C::KS, true);
    } else {
      TJ_ART_GO(C::KL, true);
    }
  } else if constexpr (V == FULL) {
    if (small) {
      TJ_ART_GO(C::KS, false);
    } else {
      TJ_ART_GO(C::KL, false);
    }
  }
#undef TJ_ART_GO
  return tj::launch_error();
}

template <int V>
int launch_sl(int slices, float* x, const float* b, const float4* t,
              const int* order, int count, float beta, int n, int rays,
              int ns, long long* prof, cudaStream_t st) {
  switch (slices) {
    case 1:
      return launch<1, V>(x, b, t, order, count, beta, n, rays, ns, prof, st);
    case 2:
      return launch<2, V>(x, b, t, order, count, beta, n, rays, ns, prof, st);
    case 4:
      return launch<4, V>(x, b, t, order, count, beta, n, rays, ns, prof, st);
    case 8:
      return launch<8, V>(x, b, t, order, count, beta, n, rays, ns, prof, st);
    default:
      return launch<16, V>(x, b, t, order, count, beta, n, rays, ns, prof,
                           st);
  }
}

// The largest N a sweep with `slices` slices a block takes (0: no such
// instantiation): W warps of Q step groups, KL steps each.
inline int max_n(int slices) {
  switch (slices) {
    case 1:
      return Cfg<1>::MAX_N;
    case 2:
      return Cfg<2>::MAX_N;
    case 4:
      return Cfg<4>::MAX_N;
    case 8:
      return Cfg<8>::MAX_N;
    case 16:
      return Cfg<16>::MAX_N;
    default:
      return 0;
  }
}

// The checks of both entry points.
inline bool valid(const float* rtab, int count, int n, int rays, int ns,
                  int slices) {
  return n > 0 && rays > 0 && ns > 0 && count > 0 && n <= max_n(slices) &&
         tj::aligned_to(rtab, 16);
}

}  // namespace tj_art
