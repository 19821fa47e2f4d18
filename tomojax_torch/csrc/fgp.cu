// FGP TV prox for Hopper: K3 (one fused FGP iteration), K4 (the final
// objective pass with the FISTA Nesterov step as an epilogue), their slab
// variants K9a/K9b, which take the neighbouring ranks' boundary planes
// along axis 2 (the slab axis of a z-sharded slice-last volume), K11 (two
// fused iterations per launch) and K12 (the dual pass of the two-pass FGP).
//
// Volume x (n0, n1, n2) f32, contiguous, n2 fastest; duals P1..P3 of the
// same shape stored as T (float or bf16). FGP does not change under a
// permutation of the axes (the same boundary rule holds on every axis),
// so the kernels use the axis roles of the array they are given, as the
// JAX call on the same array does: P1 pairs with axis 0, P2 with axis 1,
// P3 with axis 2. Arithmetic is f32 throughout; duals are rounded to T
// only when stored (tomojax/tv/pallas_fgp.py:143-184).
//
// One body serves K3/K4 and K9a/K9b: the HALO template flag replaces the
// in-slab boundary on axis 2 by halo planes, so a slab chain computes
// bit for bit what K3/K4 compute on the whole volume.
#include "tv_march.cuh"

namespace {

constexpr int BX = 32;  // axis-2 voxels per block (threadIdx.x)
constexpr int BY = 8;   // axis-1 voxels per block (threadIdx.y)

struct Vol {
  int n0, n1, n2;
  __device__ size_t at(int i0, int i1, int i2) const {
    return (static_cast<size_t>(i0) * n1 + i1) * n2 + i2;
  }
  __device__ size_t plane(int i0, int i1) const {
    return static_cast<size_t>(i0) * n1 + i1;
  }
};

// Axis-2 neighbours of a slab: contiguous (n0, n1) planes. p3_lo is P3 at
// slice -1 (the left rank's last slice, zeros on the bottom rank). x_hi and
// p*_hi are slice n2 (the right rank's first slice); all null on the top
// rank, whose forward difference at slice n2 - 1 is then 0
// (tomojax/tv/pallas_fgp_sharded.py:40-107).
template <typename T>
struct Halo {
  const T* p3_lo;
  const float* x_hi;
  const T* p1_hi;
  const T* p2_hi;
  const T* p3_hi;
};

// d = max(x - lam * div P, 0) at the voxel with index c in x and P1..P3,
// whose axis-0 and axis-1 predecessors lie s0 and s1 before it (has0/has1
// false at the low boundary: P[-1] = 0) and whose P3 one slice below is
// `below`. div is the sum of backward differences (reference
// tv_fgp.cu:56-62, tomojax/tv/__init__.py:_bdiff_accum). The caller picks
// the arrays: the slab, or a halo plane (s0 = n1, s1 = 1).
template <typename T>
__device__ __forceinline__ float objective(const float* __restrict__ x,
                                           const T* __restrict__ p1,
                                           const T* __restrict__ p2,
                                           const T* __restrict__ p3, size_t c,
                                           size_t s0, size_t s1, bool has0,
                                           bool has1, float below,
                                           float lam) {
  float div = tj::load(p1, c) - (has0 ? tj::load(p1, c - s0) : 0.f);
  div += tj::load(p2, c) - (has1 ? tj::load(p2, c - s1) : 0.f);
  div += tj::load(p3, c) - below;
  return fmaxf(__fsub_rn(x[c], __fmul_rn(lam, div)), 0.f);
}

// The dual update at one voxel: Q_k = P_k + multip * g_k, then the
// isotropic projection Q *= 1/sqrt(|Q|^2) where |Q|^2 > 1. Rounded as the
// plain versions round (no FMA contraction, rsqrt as in the reference), so
// that bf16 storage rounds the same values.
struct Dual {
  float q1, q2, q3;
};

__device__ __forceinline__ Dual dual_step(float p1, float p2, float p3,
                                          float g1, float g2, float g3,
                                          float multip) {
  const float q1 = __fadd_rn(p1, __fmul_rn(multip, g1));
  const float q2 = __fadd_rn(p2, __fmul_rn(multip, g2));
  const float q3 = __fadd_rn(p3, __fmul_rn(multip, g3));
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(q1, q1), __fmul_rn(q2, q2)),
                              __fmul_rn(q3, q3));
  const float sc = den > 1.f ? rsqrtf(den) : 1.f;
  return {q1 * sc, q2 * sc, q3 * sc};
}

// P3 one slice below voxel o (plane index row) of slice i2: 0 under slice 0
// of the whole volume, the left halo plane under slice 0 of a slab (HALO).
template <typename T, bool HALO>
__device__ __forceinline__ float p3_below(const T* __restrict__ p3,
                                          const Halo<T>& h, size_t o,
                                          size_t row, int i2) {
  if (HALO) return i2 > 0 ? tj::load(p3, o - 1) : tj::load(h.p3_lo, row);
  return i2 > 0 ? tj::load(p3, o - 1) : 0.f;
}

// d = max(x - lam * div P, 0) from staged values: P1 and the P1 one plane
// below (p1m), P2 and the one a row before (p2m), P3 and the one a slice
// before (p3m), zero where the predecessor lies outside the volume. The
// same operations in the same order as `objective`.
__device__ __forceinline__ float objective_at(float x, float p1, float p1m,
                                              float p2, float p2m, float p3,
                                              float p3m, float lam) {
  float div = p1 - p1m;
  div += p2 - p2m;
  div += p3 - p3m;
  return fmaxf(__fsub_rn(x, __fmul_rn(lam, div)), 0.f);
}

// K3 -- replaces tomojax/tv/pallas_fgp.py:_fused_kernel (HALO false).
// K9a -- replaces tomojax/tv/pallas_fgp_sharded.py:_fused_kernel_halo
// (HALO true): the same iteration on a slab, whose slice-n2 neighbour and
// P3 below slice 0 come from the halo planes.
//
// One FGP iteration: d = max(x - lam div P, 0), the forward difference
// g = d - d(+1) on each axis (zero at the far boundary), P += g / (26 lam),
// and the isotropic projection: if |P|^2 > 1, P *= 1/sqrt(|P|^2). It reads
// P_in and writes P_out (ping-pong), so no thread reads an updated P.
//
// Bound on the H100: device memory. At 256^3 with bf16 duals one launch
// must move 64 MiB of x and 96 MiB of duals in and 96 MiB out. The kernel
// marches along axis 0 (tv_march.cuh): each plane of x, P1, P2 and P3 is
// staged once over the tile and its one-voxel halo (16-byte copies two
// planes ahead where every row is 16-byte aligned), zeros outside the
// volume (HALO: P3 below slice 0 from p3_lo, slice n2 from the right halo
// planes); d is computed once a voxel at plane i0 + 1 on the tile plus one
// row and one column, into one of two region buffers; g1 reads d of plane
// i0 from the other buffer, g2 and g3 read it one row and one column on;
// the dual step runs on P of plane i0, staged a step earlier.
// `objective_at` and `dual_step` take the operands of the per-voxel form in
// its order, so the duals are the same bit for bit.
template <typename T, bool HALO, bool VEC>
__global__ void __launch_bounds__(tj::TV_NT, tj::TV_MIN_BLOCKS)
fgp_iter_kernel(const float* __restrict__ x, const T* __restrict__ p1,
                const T* __restrict__ p2, const T* __restrict__ p3,
                T* __restrict__ o1, T* __restrict__ o2, T* __restrict__ o3,
                Halo<T> h, Vol v, float lam, float multip) {
  using BXb = tj::TvBox<float>;
  using BPb = tj::TvBox<T>;
  using Cells = tj::CellSet<VEC, false, HALO>;
  constexpr int R2 = tj::TV_R2;
  using S = tj::PlaneSlot<T, 3>;
  __shared__ __align__(16) unsigned char ring[tj::TV_RING * S::BYTES];
  __shared__ float ds[2][tj::TV_REG];  // d of planes i0 and i0 + 1
  const int tx = threadIdx.x % tj::TV_T2, ty = threadIdx.x / tj::TV_T2;
  const int c0 = blockIdx.x * tj::TV_T2, r0 = blockIdx.y * tj::TV_T1;
  const int i_s = blockIdx.z * tj::TV_C;
  const int i_e = min(v.n0, i_s + tj::TV_C);
  const int c = c0 + tx;
  const size_t plane = static_cast<size_t>(v.n1) * v.n2;
  const T* pv[3] = {p1, p2, p3};
  const T* lo[3] = {nullptr, nullptr, HALO ? h.p3_lo : nullptr};
  const T* hi[3] = {HALO ? h.p1_hi : nullptr, HALO ? h.p2_hi : nullptr,
                    HALO ? h.p3_hi : nullptr};
  const float* x_hi = HALO ? h.x_hi : nullptr;
  const bool has_hi = x_hi != nullptr;
  const bool in_lo = c0 == 0, in_hi = v.n2 <= c0 + tj::TV_T2;
  Cells cells;
  cells.init(r0, c0, v.n1, v.n2);
  // which operands' cells a thread stores: with VEC only the halo columns
  // that come from elsewhere, P3's column -1 (HALO) and every operand's
  // column n2 (a right halo); the copies bring the rest
  const bool keep = !VEC || (!cells.lo_side && has_hi);  // x, P1, P2
  const bool keep_p3 = !VEC || (cells.lo_side ? HALO : has_hi);
  // the cells of two planes in flight (tj::Set)
  float vx[2][Cells::N];
  T vp[2][3][Cells::N];
  auto slot = [&](int p) { return (p - i_s + 1) % tj::TV_RING; };
  auto X = [&](int b) {
    return reinterpret_cast<float*>(ring + b * S::BYTES);
  };
  auto P = [&](int b, int k) {
    return reinterpret_cast<T*>(ring + b * S::BYTES + S::XB + k * S::PB);
  };
  tj::PlaneCopy cps[S::COPIES];
#pragma unroll
  for (int j = 0; j < S::COPIES; ++j) {
    cps[j] = tj::plane_copy<T, 3, false>(
        threadIdx.x + j * tj::TV_NT, r0, c0, v.n1, v.n2,
        HALO && in_lo ? 1 << 3 : 0, has_hi && in_hi ? 0xf : 0);
  }
  const void* const ops[4] = {x, p1, p2, p3};
  // plane p (zeros outside [0, n0)); only P1 unless `all`; planes past the
  // chunk's last + 1 are not needed: an empty group
  auto stage_async = [&](int p, bool all) {
    if (VEC && p <= i_e) {
      const bool ok = p >= 0 && p < v.n0;
      tj::copy_plane<T, 3>(ring + slot(p) * S::BYTES, cps, ops,
                            ok ? p * plane : 0, ok, all ? -1 : 1);
    }
    tj::tv_commit();
  };
  auto fetch = [&](int p, bool all, auto set) {
    constexpr int k_ = decltype(set)::value;
    const bool ok = p >= 0 && p < v.n0;
    const size_t po = ok ? p * plane : 0, ho = ok ? p * size_t(v.n1) : 0;
#pragma unroll
    for (int s = 0; s < Cells::N; ++s) {
      if (!cells.live[s]) continue;
      tj::BoxCell cl = cells.cell[s];
      if (!ok) cl.src = tj::BOX_ZERO;
      if (all) {
        vx[k_][s] = tj::cell_fetch<float>(cl, x, nullptr, x_hi, po, ho);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (all || k == 0) {
          vp[k_][k][s] = tj::cell_fetch<T>(cl, pv[k], lo[k], hi[k], po, ho);
        }
      }
    }
  };
  auto put = [&](int p, bool all, auto set) {
    constexpr int k_ = decltype(set)::value;
    const int b = slot(p);
#pragma unroll
    for (int s = 0; s < Cells::N; ++s) {
      if (!cells.live[s]) continue;
      const int ax = BXb::at(cells.cell[s].a, cells.cell[s].b);
      const int ap = BPb::at(cells.cell[s].a, cells.cell[s].b);
      if (all && keep) X(b)[ax] = vx[k_][s];
      if (keep) P(b, 0)[ap] = vp[k_][0][s];
      if (all && keep) P(b, 1)[ap] = vp[k_][1][s];
      if (all && keep_p3) P(b, 2)[ap] = vp[k_][2][s];
    }
  };
  // d of plane p on the region (box rows 1..TV_T1 + 1, columns
  // 1..TV_T2 + 1: the tile and one row and one column after it), P1 one
  // plane below from plane p - 1's buffer; NR cells a thread at most
  constexpr int ROWS = tj::TV_ROWS, TY = tj::TV_TY, NR = tj::TV_RCELLS;
  int rx[NR], rp[NR];
#pragma unroll
  for (int m = 0; m < NR; ++m) {
    const int e = threadIdx.x + m * tj::TV_NT;
    rx[m] = BXb::at(e / R2 + 1, e % R2 + 1);
    rp[m] = BPb::at(e / R2 + 1, e % R2 + 1);
  }
  auto region_d = [&](int p, float* out) {
    const int b = slot(p), bm = slot(p - 1);
    const float* Xb = X(b);
    const T* P1 = P(b, 0);
    const T* P2 = P(b, 1);
    const T* P3 = P(b, 2);
    const T* P1m = P(bm, 0);
#pragma unroll
    for (int m = 0; m < NR; ++m) {
      const int e = threadIdx.x + m * tj::TV_NT, ox = rx[m], op = rp[m];
      if (m == 0 || e < tj::TV_REG) {
        out[e] = objective_at(Xb[ox], tj::load(P1, op), tj::load(P1m, op),
                              tj::load(P2, op), tj::load(P2, op - BPb::W),
                              tj::load(P3, op), tj::load(P3, op - 1), lam);
      }
    }
  };

  // plane i_s - 1: P1 only, which the divergence of plane i_s reads
  stage_async(i_s - 1, false);
  stage_async(i_s, true);
  stage_async(i_s + 1, true);
  stage_async(i_s + 2, true);
  tj::tv_wait<2>();
  fetch(i_s - 1, false, tj::Set0{});
  fetch(i_s, true, tj::Set1{});
  put(i_s - 1, false, tj::Set0{});
  put(i_s, true, tj::Set1{});
  fetch(i_s + 1, true, tj::Set1{});  // the loop's steps take sets 1, 0, 1, ...
  fetch(i_s + 2, true, tj::Set0{});
  __syncthreads();
  region_d(i_s, ds[0]);
  const bool has3 = c < v.n2 - 1 || has_hi;
  // plane i0, its d in ds[dc]: the cells of plane i0 + 1 come from `set`,
  // which then takes plane i0 + 3's
  auto step = [&](int i0, int dc, auto set) {
    const size_t at = i0 * plane + static_cast<size_t>(r0 + ty) * v.n2 + c;
    tj::tv_wait<1>();
    put(i0 + 1, true, set);
    __syncthreads();
    stage_async(i0 + 3, true);
    if (i0 + 3 <= i_e) fetch(i0 + 3, true, set);
    region_d(i0 + 1, ds[dc ^ 1]);
    __syncthreads();
    const int b = slot(i0);
    const float* dd = ds[dc];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int r = r0 + ty + TY * j;
      if (r >= v.n1 || c >= v.n2) continue;
      const int op = BPb::at(ty + TY * j + 1, tx + 1);  // the voxel in the box
      const int q = (ty + TY * j) * R2 + tx;            // in the region
      const float d = dd[q];
      const float g1 = i0 < v.n0 - 1 ? d - ds[dc ^ 1][q] : 0.f;
      const float g2 = r < v.n1 - 1 ? d - dd[q + R2] : 0.f;
      const float g3 = has3 ? d - dd[q + 1] : 0.f;
      const Dual u = dual_step(tj::load(P(b, 0), op), tj::load(P(b, 1), op),
                               tj::load(P(b, 2), op), g1, g2, g3, multip);
      const size_t o = at + static_cast<size_t>(TY * j) * v.n2;
      o1[o] = tj::store<T>(u.q1);
      o2[o] = tj::store<T>(u.q2);
      o3[o] = tj::store<T>(u.q3);
    }
  };
  for (int i0 = i_s; i0 < i_e; i0 += 2) {
    step(i0, 0, tj::Set1{});
    if (i0 + 1 < i_e) step(i0 + 1, 1, tj::Set0{});
  }
}

// K11 -- replaces tomojax/tv/pallas_fgp.py:_fused2_kernel
// (tv_fgp_pallas_fused with fuse_pairs=True): two FGP iterations per
// launch, P -> P^1 -> P^2, with the intermediate duals P^1 kept in f32 and
// never stored; P^2 is rounded to T once. The reference's boundary rules
// hold at both iterations: P = 0 below index 0 in the divergence, a zero
// forward difference at the last index, the clamp d >= 0, the isotropic
// projection.
//
// Bound on the H100: device memory, as K3: x, P in and P out once per two
// iterations, 256 MiB at 256^3 with bf16 duals (K3 moves that per
// iteration). The kernel marches along axis 0 on K3's machinery with a
// two-voxel halo (tv_march.cuh, H = TV_H2): each plane of x and P is
// staged once over the tile and two voxels around it, and march step k
// computes, into region buffers of two planes each in shared memory,
//   d^1 on plane k over the tile + 1 row and column below, + 2 above;
//   P^1 on plane k - 1 over the tile +- 1 (0 below plane 0 and outside
//       the volume, so that the divergence of iteration 2 reads P^1 = 0
//       below index 0);
//   d^2 on plane k - 1 over the tile + 1 row and column above;
//   P^2 on plane k - 2 over the tile, stored as T.
// So each plane's d^1, P^1 and d^2 are computed once along axis 0; only
// the in-plane halo is recomputed (1.50x, 1.33x and 1.16x the tile's
// cells). A chunk starts staging two planes below its first output plane
// (the lowest P1 only) and runs two planes past its last. The operations
// are K3's (objective_at, dual_step) operand for operand, so one launch
// equals two plain iterations with P^1 in f32 bit for bit.
constexpr int H2 = tj::TV_H2;
// K11's region buffers, row-major over rows x W columns of the tile's
// frame: d^1 on rows and columns -1 .. T + 1, P^1 on -1 .. T, d^2 on 0 .. T
constexpr int D1W = tj::TV_T2 + 3, D1N = (tj::TV_T1 + 3) * D1W;
constexpr int QW = tj::TV_T2 + 2, QN = (tj::TV_T1 + 2) * QW;
constexpr int D2W = tj::TV_T2 + 1, D2N = (tj::TV_T1 + 1) * D2W;

template <typename T, bool VEC>
__global__ void __launch_bounds__(tj::TV_NT, tj::TV2_MIN_BLOCKS)
fgp_iter2_kernel(const float* __restrict__ x, const T* __restrict__ p1,
                 const T* __restrict__ p2, const T* __restrict__ p3,
                 T* __restrict__ o1, T* __restrict__ o2, T* __restrict__ o3,
                 Vol v, float lam, float multip) {
  using BXb = tj::TvBox<float, H2>;
  using BPb = tj::TvBox<T, H2>;
  using S = tj::PlaneSlot<T, 3, H2>;
  // every box cell through registers, without VEC only (no halo column
  // comes from elsewhere: with VEC the copies bring the whole box)
  using Cells = tj::CellSet<false, false, false, H2>;
  constexpr int NT = tj::TV_NT;
  __shared__ __align__(16) unsigned char ring[tj::TV_RING * S::BYTES];
  __shared__ float d1s[2][D1N];   // d^1 of planes k - 1 and k
  __shared__ float qs[2][3][QN];  // P^1 of planes k - 2 and k - 1
  __shared__ float d2s[2][D2N];   // d^2 of planes k - 2 and k - 1
  const int tx = threadIdx.x % tj::TV_T2, ty = threadIdx.x / tj::TV_T2;
  const int c0 = blockIdx.x * tj::TV_T2, r0 = blockIdx.y * tj::TV_T1;
  const int i_s = blockIdx.z * tj::TV_C;
  const int i_e = min(v.n0, i_s + tj::TV_C);
  const int last = i_e + 1;  // the last plane staged
  const size_t plane = static_cast<size_t>(v.n1) * v.n2;
  const T* pv[3] = {p1, p2, p3};
  Cells cells;
  if (!VEC) cells.init(r0, c0, v.n1, v.n2);
  // the cells of two planes in flight (tj::Set)
  float vx[2][Cells::N];
  T vp[2][3][Cells::N];
  auto slot = [&](int p) { return (p - i_s + 2) % tj::TV_RING; };
  auto X = [&](int b) {
    return reinterpret_cast<float*>(ring + b * S::BYTES);
  };
  auto P = [&](int b, int k) {
    return reinterpret_cast<T*>(ring + b * S::BYTES + S::XB + k * S::PB);
  };
  tj::PlaneCopy cps[S::COPIES];
#pragma unroll
  for (int j = 0; j < S::COPIES; ++j) {
    cps[j] = tj::plane_copy<T, 3, false, H2>(threadIdx.x + j * NT, r0, c0,
                                             v.n1, v.n2, 0, 0);
  }
  const void* const ops[4] = {x, p1, p2, p3};
  // plane p (zeros outside [0, n0)); only P1 unless `all`
  auto stage_async = [&](int p, bool all) {
    if (VEC && p <= last) {
      const bool ok = p >= 0 && p < v.n0;
      tj::copy_plane<T, 3, H2>(ring + slot(p) * S::BYTES, cps, ops,
                               ok ? p * plane : 0, ok, all ? -1 : 1);
    }
    tj::tv_commit();
  };
  auto fetch = [&](int p, bool all, auto set) {
    constexpr int k_ = decltype(set)::value;
    if (VEC) return;
    const bool ok = p >= 0 && p < v.n0;
    const size_t po = ok ? p * plane : 0;
#pragma unroll
    for (int s = 0; s < Cells::N; ++s) {
      if (!cells.live[s]) continue;
      tj::BoxCell cl = cells.cell[s];
      if (!ok) cl.src = tj::BOX_ZERO;
      if (all) {
        vx[k_][s] = tj::cell_fetch<float>(cl, x, nullptr, nullptr, po, 0);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (all || k == 0) {
          vp[k_][k][s] =
              tj::cell_fetch<T>(cl, pv[k], nullptr, nullptr, po, 0);
        }
      }
    }
  };
  auto put = [&](int p, bool all, auto set) {
    constexpr int k_ = decltype(set)::value;
    if (VEC) return;
    const int b = slot(p);
#pragma unroll
    for (int s = 0; s < Cells::N; ++s) {
      if (!cells.live[s]) continue;
      const int ax = BXb::at(cells.cell[s].a, cells.cell[s].b);
      const int ap = BPb::at(cells.cell[s].a, cells.cell[s].b);
      if (all) X(b)[ax] = vx[k_][s];
      P(b, 0)[ap] = vp[k_][0][s];
      if (all) P(b, 1)[ap] = vp[k_][1][s];
      if (all) P(b, 2)[ap] = vp[k_][2][s];
    }
  };
  // d^1 of plane k on its region; region cell (u, w) is the tile's row
  // u - 1, column w - 1, box cell (u + 1, w + 1); P1 one plane below from
  // plane k - 1's slot
  auto region_d1 = [&](int k) {
    const int b = slot(k);
    const float* Xb = X(b);
    const T* P1 = P(b, 0);
    const T* P2 = P(b, 1);
    const T* P3 = P(b, 2);
    const T* P1m = P(slot(k - 1), 0);
    float* out = d1s[k & 1];
#pragma unroll
    for (int m = 0; m < (D1N + NT - 1) / NT; ++m) {
      const int e = threadIdx.x + m * NT;
      if (e < D1N) {
        const int u = e / D1W, w = e % D1W;
        const int ox = BXb::at(u + 1, w + 1), op = BPb::at(u + 1, w + 1);
        out[e] = objective_at(Xb[ox], tj::load(P1, op), tj::load(P1m, op),
                              tj::load(P2, op), tj::load(P2, op - BPb::W),
                              tj::load(P3, op), tj::load(P3, op - 1), lam);
      }
    }
  };
  // P^1 of plane k - 1 from d^1 of planes k - 1 and k; region cell (u, w)
  // is the tile's row u - 1, column w - 1
  auto region_q = [&](int k) {
    const int pl = k - 1;
    const bool in0 = pl >= 0 && pl < v.n0;
    const int b = slot(pl);
    const float* dd = d1s[pl & 1];
    const float* dn = d1s[k & 1];
    float* q1 = qs[pl & 1][0];
    float* q2 = qs[pl & 1][1];
    float* q3 = qs[pl & 1][2];
#pragma unroll
    for (int m = 0; m < (QN + NT - 1) / NT; ++m) {
      const int e = threadIdx.x + m * NT;
      if (e < QN) {
        const int u = e / QW, w = e % QW;
        const int r = r0 + u - 1, c = c0 + w - 1;
        Dual q{0.f, 0.f, 0.f};
        if (in0 && r >= 0 && r < v.n1 && c >= 0 && c < v.n2) {
          const int di = u * D1W + w, op = BPb::at(u + 1, w + 1);
          const float d = dd[di];
          q = dual_step(tj::load(P(b, 0), op), tj::load(P(b, 1), op),
                        tj::load(P(b, 2), op),
                        pl < v.n0 - 1 ? d - dn[di] : 0.f,
                        r < v.n1 - 1 ? d - dd[di + D1W] : 0.f,
                        c < v.n2 - 1 ? d - dd[di + 1] : 0.f, multip);
        }
        q1[e] = q.q1;
        q2[e] = q.q2;
        q3[e] = q.q3;
      }
    }
  };
  // d^2 of plane k - 1 from P^1 of planes k - 1 and k - 2; region cell
  // (u, w) is the tile's row u, column w, P^1's cell (u + 1, w + 1)
  auto region_d2 = [&](int k) {
    const int pl = k - 1;
    const float* Xb = X(slot(pl));
    const float* q1 = qs[pl & 1][0];
    const float* q2 = qs[pl & 1][1];
    const float* q3 = qs[pl & 1][2];
    const float* q1m = qs[(pl - 1) & 1][0];
    float* out = d2s[pl & 1];
#pragma unroll
    for (int m = 0; m < (D2N + NT - 1) / NT; ++m) {
      const int e = threadIdx.x + m * NT;
      if (e < D2N) {
        const int u = e / D2W, w = e % D2W;
        const int qi = (u + 1) * QW + w + 1;
        out[e] = objective_at(Xb[BXb::at(u + 2, w + 2)], q1[qi], q1m[qi],
                              q2[qi], q2[qi - QW], q3[qi], q3[qi - 1],
                              lam);
      }
    }
  };
  // P^2 of plane k - 2 on the tile, from d^2 of planes k - 2 and k - 1
  auto out_p2 = [&](int k) {
    const int pl = k - 2;
    const float* dd = d2s[pl & 1];
    const float* dn = d2s[(pl + 1) & 1];
    const float* q1 = qs[pl & 1][0];
    const float* q2 = qs[pl & 1][1];
    const float* q3 = qs[pl & 1][2];
    const int c = c0 + tx;
#pragma unroll
    for (int j = 0; j < tj::TV_ROWS; ++j) {
      const int u = ty + tj::TV_TY * j, r = r0 + u;
      if (r >= v.n1 || c >= v.n2) continue;
      const int di = u * D2W + tx, qi = (u + 1) * QW + tx + 1;
      const float d = dd[di];
      const Dual q = dual_step(q1[qi], q2[qi], q3[qi],
                               pl < v.n0 - 1 ? d - dn[di] : 0.f,
                               r < v.n1 - 1 ? d - dd[di + D2W] : 0.f,
                               c < v.n2 - 1 ? d - dd[di + 1] : 0.f, multip);
      const size_t o = pl * plane + static_cast<size_t>(r) * v.n2 + c;
      o1[o] = tj::store<T>(q.q1);
      o2[o] = tj::store<T>(q.q2);
      o3[o] = tj::store<T>(q.q3);
    }
  };

  // plane i_s - 2: P1 only, which d^1 of plane i_s - 1 reads
  stage_async(i_s - 2, false);
  stage_async(i_s - 1, true);
  stage_async(i_s, true);
  fetch(i_s - 2, false, tj::Set0{});
  put(i_s - 2, false, tj::Set0{});
  fetch(i_s - 1, true, tj::Set1{});  // the loop's steps take sets 1, 0, ...
  fetch(i_s, true, tj::Set0{});
  // march step k (plane k's cells in `set`, which then takes plane k + 2's)
  auto step = [&](int k, auto set) {
    tj::tv_wait<1>();
    put(k, true, set);
    __syncthreads();
    stage_async(k + 2, true);
    if (k + 2 <= last) fetch(k + 2, true, set);
    region_d1(k);
    __syncthreads();
    if (k >= i_s) region_q(k);
    __syncthreads();
    if (k > i_s) region_d2(k);
    __syncthreads();
    if (k > i_s + 1) out_p2(k);
  };
  for (int k = i_s - 1; k <= last; k += 2) {
    step(k, tj::Set1{});
    if (k + 1 <= last) step(k + 1, tj::Set0{});
  }
}

// K12 -- replaces tomojax/tv/pallas_fgp.py:_grad_kernel, the dual pass of
// the two-pass FGP (tv_fgp_pallas), whose objective pass is K4 with the
// momentum off (_obj_kernel). P <- project(P + multip * grad d) from the
// stored d, the forward difference 0 at the last index of each axis. f32
// duals, as the reference keeps them in x's dtype. It reads P and d and
// writes fresh dual tensors, so no thread reads an updated neighbour.
//
// Bound on the H100: device memory. One launch moves d and three duals in
// and three duals out (448 MiB at 256^3); the d neighbours hit L1/L2.
__global__ void __launch_bounds__(BX * BY)
fgp_grad_kernel(const float* __restrict__ d, const float* __restrict__ p1,
                const float* __restrict__ p2, const float* __restrict__ p3,
                float* __restrict__ o1, float* __restrict__ o2,
                float* __restrict__ o3, Vol v, float multip) {
  const int i2 = blockIdx.x * BX + threadIdx.x;
  const int i1 = blockIdx.y * BY + threadIdx.y;
  const int i0 = blockIdx.z;
  if (i2 >= v.n2 || i1 >= v.n1) return;
  const size_t o = v.at(i0, i1, i2);
  const float dv = d[o];
  const Dual r = dual_step(
      p1[o], p2[o], p3[o],
      i0 < v.n0 - 1 ? dv - d[o + static_cast<size_t>(v.n1) * v.n2] : 0.f,
      i1 < v.n1 - 1 ? dv - d[o + v.n2] : 0.f,
      i2 < v.n2 - 1 ? dv - d[o + 1] : 0.f, multip);
  o1[o] = r.q1;
  o2[o] = r.q2;
  o3[o] = r.q3;
}

// K4 -- replaces tomojax/tv/pallas_fgp.py:_obj_mom_kernel (MOM true) and
// _obj_kernel (MOM false), HALO false.
// K9b -- replaces tomojax/tv/pallas_fgp_sharded.py:_obj_kernel_halo (HALO
// true): P3 below slice 0 from the left halo; the Nesterov epilogue stays,
// as the port's FISTA fuses its beta step here on both paths.
//
// d = max(x - lam div P, 0), the FGP result; with MOM also the FISTA
// Nesterov step y = d + beta (d - x_old), beta read from device memory so
// the host never waits for it.
//
// Bound on the H100: one streaming pass (x, three duals and x_old in;
// d and y out).
template <typename T, bool MOM, bool HALO>
__global__ void __launch_bounds__(BX * BY)
fgp_obj_kernel(const float* __restrict__ x, const T* __restrict__ p1,
               const T* __restrict__ p2, const T* __restrict__ p3,
               const float* __restrict__ x_old,
               const float* __restrict__ beta, float* __restrict__ d_out,
               float* __restrict__ y_out, Halo<T> h, Vol v, float lam) {
  const int i2 = blockIdx.x * BX + threadIdx.x;
  const int i1 = blockIdx.y * BY + threadIdx.y;
  const int i0 = blockIdx.z;
  if (i2 >= v.n2 || i1 >= v.n1) return;
  const size_t o = v.at(i0, i1, i2);
  const float d = objective(
      x, p1, p2, p3, o, static_cast<size_t>(v.n1) * v.n2, v.n2, i0 > 0,
      i1 > 0, p3_below<T, HALO>(p3, h, o, v.plane(i0, i1), i2), lam);
  d_out[o] = d;
  if (MOM) y_out[o] = __fadd_rn(d, __fmul_rn(beta[0], d - x_old[o]));
}

bool vol_ok(int n0, int n1, int n2) {
  return n0 > 0 && n1 > 0 && n2 > 0 && n0 <= 65535 &&
         (n1 + BY - 1) / BY <= 65535;
}

dim3 vol_grid(const Vol& v) {
  return dim3((v.n2 + BX - 1) / BX, (v.n1 + BY - 1) / BY, v.n0);
}

// VEC where every operand's rows are 16-byte aligned.
template <typename T, bool HALO>
void launch_iter(const float* x, const void* p1, const void* p2,
                 const void* p3, void* o1, void* o2, void* o3,
                 const Halo<T>& h, Vol v, float lam, float multip,
                 cudaStream_t st) {
  const bool vec =
      v.n2 % tj::TvBox<T>::PAD == 0 &&
      (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(p1) |
       reinterpret_cast<size_t>(p2) | reinterpret_cast<size_t>(p3)) % 16 == 0;
  auto kernel = vec ? fgp_iter_kernel<T, HALO, true>
                    : fgp_iter_kernel<T, HALO, false>;
  kernel<<<tj::march_grid(v.n0, v.n1, v.n2), tj::TV_NT, 0, st>>>(
      x, static_cast<const T*>(p1), static_cast<const T*>(p2),
      static_cast<const T*>(p3), static_cast<T*>(o1), static_cast<T*>(o2),
      static_cast<T*>(o3), h, v, lam, multip);
}

// VEC where every operand's rows are 16-byte aligned.
template <typename T>
void launch_iter2(const float* x, const void* p1, const void* p2,
                  const void* p3, void* o1, void* o2, void* o3, Vol v,
                  float lam, float multip, cudaStream_t st) {
  const bool vec =
      v.n2 % tj::TvBox<T>::PAD == 0 &&
      (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(p1) |
       reinterpret_cast<size_t>(p2) | reinterpret_cast<size_t>(p3)) % 16 == 0;
  auto kernel = vec ? fgp_iter2_kernel<T, true> : fgp_iter2_kernel<T, false>;
  kernel<<<tj::march_grid(v.n0, v.n1, v.n2), tj::TV_NT, 0, st>>>(
      x, static_cast<const T*>(p1), static_cast<const T*>(p2),
      static_cast<const T*>(p3), static_cast<T*>(o1), static_cast<T*>(o2),
      static_cast<T*>(o3), v, lam, multip);
}

template <typename T, bool HALO>
void launch_obj(const float* x, const void* p1, const void* p2,
                const void* p3, const Halo<T>& h, const float* x_old,
                const float* beta, float* d, float* y, Vol v, float lam,
                cudaStream_t st) {
  const auto* q1 = static_cast<const T*>(p1);
  const auto* q2 = static_cast<const T*>(p2);
  const auto* q3 = static_cast<const T*>(p3);
  if (x_old != nullptr) {
    fgp_obj_kernel<T, true, HALO><<<vol_grid(v), dim3(BX, BY), 0, st>>>(
        x, q1, q2, q3, x_old, beta, d, y, h, v, lam);
  } else {
    fgp_obj_kernel<T, false, HALO><<<vol_grid(v), dim3(BX, BY), 0, st>>>(
        x, q1, q2, q3, nullptr, nullptr, d, nullptr, h, v, lam);
  }
}

template <typename T>
Halo<T> halo(const void* p3_lo, const float* x_hi, const void* p1_hi,
             const void* p2_hi, const void* p3_hi) {
  return Halo<T>{static_cast<const T*>(p3_lo), x_hi,
                 static_cast<const T*>(p1_hi), static_cast<const T*>(p2_hi),
                 static_cast<const T*>(p3_hi)};
}

bool obj_args_ok(const float* x_old, const float* beta, const float* y) {
  const bool mom = x_old != nullptr;
  return (beta != nullptr) == mom && (y != nullptr) == mom;
}

}  // namespace

// bf16 != 0: duals are __nv_bfloat16, else float.
TJ_API int tj_fgp_iter(const float* x, const void* p1, const void* p2,
                       const void* p3, void* o1, void* o2, void* o3, int n0,
                       int n1, int n2, int bf16, float lam, float multip,
                       void* stream) {
  if (!tj::march_ok(n0, n1, n2)) return cudaErrorInvalidValue;
  const Vol v{n0, n1, n2};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_iter<__nv_bfloat16, false>(x, p1, p2, p3, o1, o2, o3, {}, v, lam,
                                      multip, st);
  } else {
    launch_iter<float, false>(x, p1, p2, p3, o1, o2, o3, {}, v, lam, multip,
                              st);
  }
  return tj::launch_error();
}

// K11: two FGP iterations; operands as tj_fgp_iter.
TJ_API int tj_fgp_iter2(const float* x, const void* p1, const void* p2,
                        const void* p3, void* o1, void* o2, void* o3, int n0,
                        int n1, int n2, int bf16, float lam, float multip,
                        void* stream) {
  if (!tj::march_ok(n0, n1, n2)) return cudaErrorInvalidValue;
  const Vol v{n0, n1, n2};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_iter2<__nv_bfloat16>(x, p1, p2, p3, o1, o2, o3, v, lam, multip,
                                st);
  } else {
    launch_iter2<float>(x, p1, p2, p3, o1, o2, o3, v, lam, multip, st);
  }
  return tj::launch_error();
}

// K12: the dual pass of the two-pass FGP from the stored d; f32 duals.
TJ_API int tj_fgp_grad(const float* d, const float* p1, const float* p2,
                       const float* p3, float* o1, float* o2, float* o3,
                       int n0, int n1, int n2, float multip, void* stream) {
  if (!vol_ok(n0, n1, n2)) return cudaErrorInvalidValue;
  const Vol v{n0, n1, n2};
  fgp_grad_kernel<<<vol_grid(v), dim3(BX, BY), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      d, p1, p2, p3, o1, o2, o3, v, multip);
  return tj::launch_error();
}

// K9a. p3_lo: (n0, n1), zeros on the bottom rank. x_hi, p1_hi, p2_hi,
// p3_hi: (n0, n1) planes, all set (a right neighbour) or all null (the top
// rank).
TJ_API int tj_fgp_iter_halo(const float* x, const void* p1, const void* p2,
                            const void* p3, void* o1, void* o2, void* o3,
                            const void* p3_lo, const float* x_hi,
                            const void* p1_hi, const void* p2_hi,
                            const void* p3_hi, int n0, int n1, int n2,
                            int bf16, float lam, float multip, void* stream) {
  const int n_hi = (x_hi != nullptr) + (p1_hi != nullptr) +
                   (p2_hi != nullptr) + (p3_hi != nullptr);
  if (!tj::march_ok(n0, n1, n2) || p3_lo == nullptr ||
      (n_hi != 0 && n_hi != 4)) {
    return cudaErrorInvalidValue;
  }
  const Vol v{n0, n1, n2};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_iter<__nv_bfloat16, true>(
        x, p1, p2, p3, o1, o2, o3,
        halo<__nv_bfloat16>(p3_lo, x_hi, p1_hi, p2_hi, p3_hi), v, lam,
        multip, st);
  } else {
    launch_iter<float, true>(x, p1, p2, p3, o1, o2, o3,
                             halo<float>(p3_lo, x_hi, p1_hi, p2_hi, p3_hi),
                             v, lam, multip, st);
  }
  return tj::launch_error();
}

// x_old, beta and y all null: d only; all set: the Nesterov epilogue.
TJ_API int tj_fgp_obj(const float* x, const void* p1, const void* p2,
                      const void* p3, const float* x_old, const float* beta,
                      float* d, float* y, int n0, int n1, int n2, int bf16,
                      float lam, void* stream) {
  if (!vol_ok(n0, n1, n2) || !obj_args_ok(x_old, beta, y)) {
    return cudaErrorInvalidValue;
  }
  const Vol v{n0, n1, n2};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_obj<__nv_bfloat16, false>(x, p1, p2, p3, {}, x_old, beta, d, y, v,
                                     lam, st);
  } else {
    launch_obj<float, false>(x, p1, p2, p3, {}, x_old, beta, d, y, v, lam,
                             st);
  }
  return tj::launch_error();
}

// K9b: tj_fgp_obj with P3 below slice 0 from p3_lo ((n0, n1), zeros on the
// bottom rank).
TJ_API int tj_fgp_obj_halo(const float* x, const void* p1, const void* p2,
                           const void* p3, const void* p3_lo,
                           const float* x_old, const float* beta, float* d,
                           float* y, int n0, int n1, int n2, int bf16,
                           float lam, void* stream) {
  if (!vol_ok(n0, n1, n2) || p3_lo == nullptr ||
      !obj_args_ok(x_old, beta, y)) {
    return cudaErrorInvalidValue;
  }
  const Vol v{n0, n1, n2};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_obj<__nv_bfloat16, true>(
        x, p1, p2, p3,
        halo<__nv_bfloat16>(p3_lo, nullptr, nullptr, nullptr, nullptr),
        x_old, beta, d, y, v, lam, st);
  } else {
    launch_obj<float, true>(
        x, p1, p2, p3, halo<float>(p3_lo, nullptr, nullptr, nullptr, nullptr),
        x_old, beta, d, y, v, lam, st);
  }
  return tj::launch_error();
}
