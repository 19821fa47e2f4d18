// The plane march of K7/K9c (tvgd.cu), K3/K9a and K11 (fgp.cu) and K5
// (tv_value.cu), mirrored by tomojax_torch/tv/march.py (TV_T1, TV_T2, TV_C,
// TV_H2; change them together).
//
// A block owns a tile of TV_T1 rows (axis 1) x TV_T2 voxels (axis 2, the
// contiguous one) and walks a chunk of TV_C planes of axis 0; a thread
// computes TV_ROWS voxels of the tile, TV_TY rows apart. Each plane of each
// operand is staged once in shared memory over the box of the tile plus a
// halo of H voxels on axes 1 and 2 (H = 1; K11, two iterations deep, H =
// TV_H2), in a ring of TV_RING plane slots: where every row of the
// operands is 16-byte aligned (VEC), as 16-byte cp.async copies, and the
// halo columns that come from elsewhere (the periodic wrap, a halo plane)
// through registers; otherwise every box cell through registers. Both are
// started two planes ahead (K5 stages steps of planes ahead, every cell
// asynchronously: tv_value.cu). The stencil's shared values (K7's denominator
// D, K3's objective d; K11's d^1, P^1 and d^2) are computed once a voxel
// on the tile plus the rows and columns its neighbours read, and read by
// the neighbours from shared memory; the previous plane's values stay in
// registers (K7) or a second region buffer (K3, K11). A chunk starts from
// the planes below i0 that its first plane reads, which it stages once.
// The kernels execute instructions more than they move bytes, so
// TV_MIN_BLOCKS caps their registers for 6 resident blocks an SM.
#pragma once

#include "common.cuh"

namespace tj {

constexpr int TV_T1 = 8;   // tile rows (axis 1)
constexpr int TV_T2 = 32;  // tile voxels of a row (axis 2)
constexpr int TV_C = 32;   // planes (axis 0) a block marches
constexpr int TV_NT = 256;            // threads: TV_T2 along axis 2 x
constexpr int TV_TY = TV_NT / TV_T2;  // TV_TY along axis 1, each thread
constexpr int TV_ROWS = TV_T1 / TV_TY;  // TV_ROWS voxels TV_TY rows apart
static_assert(TV_T1 % TV_TY == 0, "whole rows of threads");
constexpr int TV_MIN_BLOCKS = 6;  // resident blocks an SM: caps registers
constexpr int TV_H2 = 2;  // K11's halo: two iterations deep
constexpr int TV2_MIN_BLOCKS = 5;  // K11's resident blocks an SM

// The staged box of a halo of H voxels: B1 rows x B2 columns, SLOTS box
// cells a thread
template <int H>
struct TvHalo {
  static constexpr int B1 = TV_T1 + 2 * H, B2 = TV_T2 + 2 * H;
  static constexpr int BOX = B1 * B2;
  static constexpr int SLOTS = (BOX + TV_NT - 1) / TV_NT;
};
constexpr int TV_B1 = TvHalo<1>::B1;
constexpr int TV_R1 = TV_T1 + 1, TV_R2 = TV_T2 + 1;  // the computed region
constexpr int TV_REG = TV_R1 * TV_R2;
constexpr int TV_RCELLS = (TV_REG + TV_NT - 1) / TV_NT;  // region cells a
                                                         // thread
constexpr int TV_RING = 4;  // plane buffers: two in use, two in flight

inline dim3 march_grid(int n0, int n1, int n2) {
  return dim3((n2 + TV_T2 - 1) / TV_T2, (n1 + TV_T1 - 1) / TV_T1,
              (n0 + TV_C - 1) / TV_C);
}

inline bool march_ok(int n0, int n1, int n2) {
  return n0 > 0 && n1 > 0 && n2 > 0 && (n1 + TV_T1 - 1) / TV_T1 <= 65535 &&
         (n0 + TV_C - 1) / TV_C <= 65535;
}

// One operand's staged box in shared memory: B1 rows (box row a is row
// r0 - H + a) of W elements, column c at element c - c0 + PAD of its row,
// so that 16-byte chunks of the volume's rows land on 16-byte boundaries.
template <typename T, int H = 1>
struct TvBox {
  static constexpr int PAD = 16 / sizeof(T);
  static_assert(H <= PAD, "the halo fits the padding");
  static constexpr int W = TV_T2 + 2 * PAD;
  static constexpr int CH = W / PAD;  // chunks a row
  static constexpr int SIZE = TvHalo<H>::B1 * W;
  // box cell (a, b), b = 0 being column c0 - H
  __device__ static constexpr int at(int a, int b) {
    return a * W + b + PAD - H;
  }
};

// Row of box row a, or -1 where nothing is read: PERIODIC wraps rows -1
// and n1 (K7, K5); otherwise they lie outside (K3's and K11's zero
// boundary).
template <bool PERIODIC, int H = 1>
__device__ __forceinline__ int box_row(int a, int r0, int n1) {
  static_assert(!PERIODIC || H == 1, "the wrap takes one row");
  int r = r0 - H + a;
  if (PERIODIC && r == -1) r = n1 - 1;
  if (PERIODIC && r == n1) r = 0;
  return r >= 0 && r < n1 ? r : -1;
}

// Where a box cell reads from, the same on every plane: the volume at
// in-plane offset `off`, the halo plane below slice 0 (LO) or above slice
// n2 - 1 (HI) at row `off`, or nothing (zero). PERIODIC wraps columns -1
// and n2; HALO takes them from the halo planes instead (both with H = 1);
// otherwise they lie outside. Cells past the volume are never read by a
// stored result.
enum BoxSrc : int { BOX_ZERO = 0, BOX_VOL, BOX_LO, BOX_HI };

struct BoxCell {
  int src, off;
  int a, b;  // box row and column (b = 0: column c0 - H)
};

template <bool PERIODIC, bool HALO, int H = 1>
__device__ __forceinline__ BoxCell box_cell(int a, int b, int r0, int c0,
                                            int n1, int n2) {
  static_assert(!HALO || H == 1, "halo planes are one slice");
  const int r = box_row<PERIODIC, H>(a, r0, n1);
  int c = c0 - H + b;
  if (r < 0 || c < -1 || c > n2) return {BOX_ZERO, 0, a, b};
  if (c == -1 || c == n2) {
    if (HALO) return {c < 0 ? BOX_LO : BOX_HI, r, a, b};
    if (!PERIODIC) return {BOX_ZERO, 0, a, b};
    c = c < 0 ? n2 - 1 : 0;
  }
  return {BOX_VOL, r * n2 + c, a, b};
}

// A cell's value on the plane at vol + plane_off (lo, hi + halo_off: the
// halo planes' row 0 of that plane; null: zeros), as stored.
template <typename T>
__device__ __forceinline__ T cell_fetch(const BoxCell& s, const T* vol,
                                        const T* lo, const T* hi,
                                        size_t plane_off, size_t halo_off) {
  const T* p = s.src == BOX_VOL ? vol + plane_off
               : s.src == BOX_LO ? (lo != nullptr ? lo + halo_off : nullptr)
               : s.src == BOX_HI ? (hi != nullptr ? hi + halo_off : nullptr)
                                 : nullptr;
  return p != nullptr ? p[s.off] : store<T>(0.f);
}

// K7's denominator D and K5's term t at a voxel with value c whose
// neighbours along the axes in the plain version's order are p0, p1, p2:
// sqrt(((eps + (c - p0)^2) + (c - p1)^2) + (c - p2)^2), every operation
// rounded as written (no FMA contraction), so that it equals the plain
// PyTorch expression bit for bit.
constexpr float EPS_TV = 1e-6f;

__device__ __forceinline__ float sq_diff(float a, float b) {
  const float d = __fsub_rn(a, b);
  return __fmul_rn(d, d);
}

__device__ __forceinline__ float denom(float c, float p0, float p1,
                                       float p2) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fadd_rn(EPS_TV, sq_diff(c, p0)),
                                        sq_diff(c, p1)),
                              sq_diff(c, p2)));
}

__device__ __forceinline__ unsigned tv_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void tv_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void tv_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One ring slot holds a plane of every operand: x (f32) and NP operands of
// type T, each in its TvBox layout, one after the other.
template <typename T, int NP, int H = 1>
struct PlaneSlot {
  static constexpr int XB = TvBox<float, H>::SIZE * 4;  // bytes of x's box
  static constexpr int PB =
      TvBox<T, H>::SIZE * static_cast<int>(sizeof(T));
  static constexpr int BYTES = XB + NP * PB;
  // VEC: the 16-byte copies of a plane, and at most COPIES a thread
  static constexpr int NCOPY =
      TvHalo<H>::B1 * (TvBox<float, H>::CH + NP * TvBox<T, H>::CH);
  static constexpr int COPIES = (NCOPY + TV_NT - 1) / TV_NT;
};

// A thread's 16-byte copy of each plane (VEC): operand `f` (0 x, k > 0 the
// k-th of type T; -1 none), `dst` bytes into the ring slot, `src` bytes
// past the operand's plane start, or zeros (src < 0). Copy i of a plane:
// x's chunks row by row, then each other operand's. A chunk of column
// c0 - 1 (operands in lo_mask) or n2 (hi_mask) is left to the halo cells.
// The box's rows are its halo's (H); its columns, whole chunks, cover it.
// Needs n2 % PAD == 0 and 16-byte aligned operands, so that every chunk
// lies inside or outside the volume.
struct PlaneCopy {
  int f, dst, src;
};

template <typename T, int NP, bool PERIODIC, int H = 1>
__device__ __forceinline__ PlaneCopy plane_copy(int i, int r0, int c0,
                                                int n1, int n2, int lo_mask,
                                                int hi_mask) {
  using S = PlaneSlot<T, NP, H>;
  using BX = TvBox<float, H>;
  using BP = TvBox<T, H>;
  constexpr int B1 = TvHalo<H>::B1;
  if (i >= S::NCOPY) return {-1, 0, 0};
  int f = 0, a, k, pad, w, es, off = 0;
  if (i < B1 * BX::CH) {
    a = i / BX::CH, k = i % BX::CH, pad = BX::PAD, w = BX::W, es = 4;
  } else {
    const int j = i - B1 * BX::CH;
    f = 1 + j / (B1 * BP::CH);
    a = (j / BP::CH) % B1, k = j % BP::CH;
    pad = BP::PAD, w = BP::W, es = static_cast<int>(sizeof(T));
    off = S::XB + (f - 1) * S::PB;
  }
  const int c = c0 - pad + k * pad;
  if ((c < 0 && (lo_mask >> f & 1)) || (c == n2 && (hi_mask >> f & 1))) {
    return {-1, 0, 0};
  }
  const int r = box_row<PERIODIC, H>(a, r0, n1);
  const bool in = r >= 0 && c >= 0 && c < n2;
  return {f, off + (a * w + k * pad) * es, in ? (r * n2 + c) * es : -1};
}

// Start a thread's copies of the plane of the operands `ops` (ok false:
// zeros) into `slot`: x at ops[0], the others at ops[k]; `only` >= 0 copies
// that operand alone.
template <typename T, int NP, int H = 1>
__device__ __forceinline__ void copy_plane(
    unsigned char* slot, const PlaneCopy (&cp)[PlaneSlot<T, NP, H>::COPIES],
    const void* const (&ops)[NP + 1], size_t plane_elems, bool ok, int only) {
#pragma unroll
  for (int j = 0; j < PlaneSlot<T, NP, H>::COPIES; ++j) {
    const int f = cp[j].f;
    if (f < 0 || (only >= 0 && f != only)) continue;
    const size_t es = f == 0 ? 4 : sizeof(T);
    const bool in = ok && cp[j].src >= 0;
    const void* op = ops[0];  // ops[f], picked without indexing the array
#pragma unroll
    for (int k = 1; k <= NP; ++k) op = f == k ? ops[k] : op;
    const unsigned char* base = static_cast<const unsigned char*>(op);
    const unsigned char* src = in ? base + plane_elems * es + cp[j].src : base;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     tv_smem(slot + cp[j].dst)),
                 "l"(src), "r"(in ? 16 : 0));
  }
}

// Fixed-order block sum of one value a thread (TV_NT threads): the warps'
// shuffle trees, then thread 0 adds the warps in order. `warps`: TV_NT / 32
// floats of shared memory. Valid in thread 0.
__device__ __forceinline__ float march_block_sum(float v, float* warps) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    total = warps[0];
#pragma unroll
    for (int w = 1; w < TV_NT / 32; ++w) total = __fadd_rn(total, warps[w]);
  }
  return total;
}

// The two register sets of the cells in flight, as tag types: a lambda
// reads the set as decltype(tag)::value, a constant, so the registers are
// never indexed at run time (which would move them to local memory).
template <int K>
struct Set {
  static constexpr int value = K;
};
using Set0 = Set<0>;
using Set1 = Set<1>;

// The register-staged cells of a thread: with VEC (H = 1) the halo cell of
// box row tid % TV_B1 at column c0 - 1 (tid < TV_B1, first tile only) or
// n2 (TV_B1 <= tid < 2 TV_B1, the tile holding it); otherwise SLOTS cells
// of the whole box. `live` says which cells exist.
template <bool VEC, bool PERIODIC, bool HALO, int H = 1>
struct CellSet {
  static_assert(!VEC || H == 1, "VEC stages only one-voxel halo cells");
  static constexpr int N = VEC ? 1 : TvHalo<H>::SLOTS;
  BoxCell cell[N];
  bool live[N];
  bool lo_side;  // VEC: this thread's cell is column c0 - 1

  __device__ __forceinline__ void init(int r0, int c0, int n1, int n2) {
    if (VEC) {
      const int t = threadIdx.x;
      lo_side = t < TV_B1;
      live[0] = t < 2 * TV_B1 && (lo_side ? c0 == 0 : n2 <= c0 + TV_T2);
      cell[0] = box_cell<PERIODIC, HALO>(t % TV_B1,
                                         lo_side ? 0 : n2 - c0 + 1, r0, c0,
                                         n1, n2);
    } else {
      lo_side = false;
#pragma unroll
      for (int s = 0; s < N; ++s) {
        const int e = threadIdx.x + s * TV_NT;
        live[s] = e < TvHalo<H>::BOX;
        cell[s] = box_cell<PERIODIC, HALO, H>(e / TvHalo<H>::B2,
                                              e % TvHalo<H>::B2, r0, c0, n1,
                                              n2);
      }
    }
  }
};

}  // namespace tj
