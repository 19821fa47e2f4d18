// The plane march of K7/K9c (tvgd.cu) and K3/K9a (fgp.cu), mirrored by
// tomojax_torch/tv/march.py (TV_T1, TV_T2, TV_C; change them together).
//
// A block owns a tile of TV_T1 rows (axis 1) x TV_T2 voxels (axis 2, the
// contiguous one) and walks a chunk of TV_C planes of axis 0; a thread
// computes TV_ROWS voxels of the tile, TV_TY rows apart. Each plane of each
// operand is staged once in shared memory over the box of the tile plus a
// one-voxel halo on axes 1 and 2, in a ring of TV_RING plane slots: where
// every row of the operands is 16-byte aligned (VEC), as 16-byte cp.async
// copies, and the halo columns that come from elsewhere (the periodic wrap,
// a halo plane) through registers; otherwise every box cell through
// registers. Both are started two planes ahead. The stencil's shared values
// (K7's denominator D, K3's objective d) are computed once a voxel on the
// tile plus one row and one column (TV_R1 x TV_R2) and read by the
// neighbours from shared memory; the previous plane's values stay in
// registers (K7) or a second region buffer (K3). A chunk starts from plane
// i0 - 1, which it stages once. The kernels execute instructions more than
// they move bytes, so TV_MIN_BLOCKS caps their registers for 6 resident
// blocks an SM.
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
constexpr int TV_B1 = TV_T1 + 2, TV_B2 = TV_T2 + 2;  // the staged box
constexpr int TV_BOX = TV_B1 * TV_B2;
constexpr int TV_SLOTS = (TV_BOX + TV_NT - 1) / TV_NT;  // box cells a thread
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

// One operand's staged box in shared memory: TV_B1 rows (box row a is row
// r0 - 1 + a) of W elements, column c at element c - c0 + PAD of its row,
// so that 16-byte chunks of the volume's rows land on 16-byte boundaries.
template <typename T>
struct TvBox {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int W = TV_T2 + 2 * PAD;
  static constexpr int CH = W / PAD;  // chunks a row
  static constexpr int SIZE = TV_B1 * W;
  // box cell (a, b), b = 0 being column c0 - 1
  __device__ static constexpr int at(int a, int b) {
    return a * W + b + PAD - 1;
  }
};

// Row of box row a, or -1 where nothing is read: PERIODIC wraps rows -1
// and n1 (K7); otherwise they lie outside (K3's zero boundary).
template <bool PERIODIC>
__device__ __forceinline__ int box_row(int a, int r0, int n1) {
  int r = r0 - 1 + a;
  if (PERIODIC && r == -1) r = n1 - 1;
  if (PERIODIC && r == n1) r = 0;
  return r >= 0 && r < n1 ? r : -1;
}

// Where a box cell reads from, the same on every plane: the volume at
// in-plane offset `off`, the halo plane below slice 0 (LO) or above slice
// n2 - 1 (HI) at row `off`, or nothing (zero). PERIODIC wraps columns -1
// and n2; HALO takes them from the halo planes instead; otherwise they lie
// outside. Cells past the volume are never read by a stored result.
enum BoxSrc : int { BOX_ZERO = 0, BOX_VOL, BOX_LO, BOX_HI };

struct BoxCell {
  int src, off;
  int a, b;  // box row and column (b = 0: column c0 - 1)
};

template <bool PERIODIC, bool HALO>
__device__ __forceinline__ BoxCell box_cell(int a, int b, int r0, int c0,
                                            int n1, int n2) {
  const int r = box_row<PERIODIC>(a, r0, n1);
  int c = c0 - 1 + b;
  if (r < 0 || c > n2) return {BOX_ZERO, 0, a, b};
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
template <typename T, int NP>
struct PlaneSlot {
  static constexpr int XB = TvBox<float>::SIZE * 4;  // bytes of x's box
  static constexpr int PB = TvBox<T>::SIZE * static_cast<int>(sizeof(T));
  static constexpr int BYTES = XB + NP * PB;
  // VEC: the 16-byte copies of a plane, and at most COPIES a thread
  static constexpr int NCOPY =
      TV_B1 * (TvBox<float>::CH + NP * TvBox<T>::CH);
  static constexpr int COPIES = (NCOPY + TV_NT - 1) / TV_NT;
};

// A thread's 16-byte copy of each plane (VEC): operand `f` (0 x, k > 0 the
// k-th of type T; -1 none), `dst` bytes into the ring slot, `src` bytes
// past the operand's plane start, or zeros (src < 0). Copy i of a plane:
// x's chunks row by row, then each other operand's. A chunk of column
// c0 - 1 (operands in lo_mask) or n2 (hi_mask) is left to the halo cells.
// Needs n2 % PAD == 0 and 16-byte aligned operands, so that every chunk
// lies inside or outside the volume.
struct PlaneCopy {
  int f, dst, src;
};

template <typename T, int NP, bool PERIODIC>
__device__ __forceinline__ PlaneCopy plane_copy(int i, int r0, int c0,
                                                int n1, int n2, int lo_mask,
                                                int hi_mask) {
  using S = PlaneSlot<T, NP>;
  using BX = TvBox<float>;
  using BP = TvBox<T>;
  if (i >= S::NCOPY) return {-1, 0, 0};
  int f = 0, a, k, pad, w, es, off = 0;
  if (i < TV_B1 * BX::CH) {
    a = i / BX::CH, k = i % BX::CH, pad = BX::PAD, w = BX::W, es = 4;
  } else {
    const int j = i - TV_B1 * BX::CH;
    f = 1 + j / (TV_B1 * BP::CH);
    a = (j / BP::CH) % TV_B1, k = j % BP::CH;
    pad = BP::PAD, w = BP::W, es = static_cast<int>(sizeof(T));
    off = S::XB + (f - 1) * S::PB;
  }
  const int c = c0 - pad + k * pad;
  if ((c < 0 && (lo_mask >> f & 1)) || (c == n2 && (hi_mask >> f & 1))) {
    return {-1, 0, 0};
  }
  const int r = box_row<PERIODIC>(a, r0, n1);
  const bool in = r >= 0 && c >= 0 && c < n2;
  return {f, off + (a * w + k * pad) * es, in ? (r * n2 + c) * es : -1};
}

// Start a thread's copies of the plane of the operands `ops` (ok false:
// zeros) into `slot`: x at ops[0], the others at ops[k]; `only` >= 0 copies
// that operand alone.
template <typename T, int NP>
__device__ __forceinline__ void copy_plane(
    unsigned char* slot, const PlaneCopy (&cp)[PlaneSlot<T, NP>::COPIES],
    const void* const (&ops)[NP + 1], size_t plane_elems, bool ok, int only) {
#pragma unroll
  for (int j = 0; j < PlaneSlot<T, NP>::COPIES; ++j) {
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

// The register-staged cells of a thread: with VEC the halo cell of box row
// tid % TV_B1 at column c0 - 1 (tid < TV_B1, first tile only) or n2
// (TV_B1 <= tid < 2 TV_B1, the tile holding it); otherwise TV_SLOTS cells
// of the whole box. `live` says which cells exist.
template <bool VEC, bool PERIODIC, bool HALO>
struct CellSet {
  static constexpr int N = VEC ? 1 : TV_SLOTS;
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
        live[s] = e < TV_BOX;
        cell[s] = box_cell<PERIODIC, HALO>(e / TV_B2, e % TV_B2, r0, c0, n1,
                                           n2);
      }
    }
  }
};

}  // namespace tj
