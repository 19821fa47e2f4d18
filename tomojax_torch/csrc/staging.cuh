// Shared-memory staging helpers of the slab-resident projectors: K1, K2 and
// K10 (joseph.cu), E1 and E2 (exp_projector.cu), and of K8's resident sweep
// (sart.cu). A block owns SLAB slices of a tile of outputs and copies the
// part of its input that the tile's taps reach into a double-buffered ring
// in shared memory with cp.async (zeros for positions or slices outside the
// operand); its threads then read 4 slices at a time as one 16-byte load.
#pragma once

#include "joseph.cuh"

namespace tj {

constexpr int SLAB = 32;  // slices per block of K1, K2, K10, E1 and E2

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 8, or 4) bytes from src into shared dst, or zeros when !ok (src
// is then not read; `safe` is any valid address).
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       const float* safe, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(ok ? src : safe), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy8(float* dst, const float* src,
                                      const float* safe, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(ok ? src : safe), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* safe, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(ok ? src : safe), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 32 slices [s0, s0 + 32) of the row at `src` (its slice 0) into shared
// dst[0, 32), zeros beyond ns or when !ok: part p of 8 (vec, 16 bytes; ns %
// 4 == 0 and 16-byte aligned rows) or of 32 (4 bytes, any ns).
__device__ __forceinline__ void copy_slices(float* dst, const float* src,
                                            const float* safe, bool ok,
                                            int s0, int ns, int p, bool vec) {
  if (vec) {
    const int s = s0 + 4 * p;
    copy16(dst + 4 * p, src + s, safe, ok && s < ns);
  } else {
    const int s = s0 + p;
    copy4(dst + p, src + s, safe, ok && s < ns);
  }
}

// 4 slices starting at p, of which `valid` (<= 0: none) lie below ns.
__device__ __forceinline__ float4 load4(const float* p, int valid, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (valid > 0) v = *reinterpret_cast<const float4*>(p);
  } else {
    if (valid > 0) v.x = p[0];
    if (valid > 1) v.y = p[1];
    if (valid > 2) v.z = p[2];
    if (valid > 3) v.w = p[3];
  }
  return v;
}

__device__ __forceinline__ void store4(float* p, float4 v, int valid,
                                       bool vec) {
  if (vec) {
    if (valid > 0) *reinterpret_cast<float4*>(p) = v;
  } else {
    if (valid > 0) p[0] = v.x;
    if (valid > 1) p[1] = v.y;
    if (valid > 2) p[2] = v.z;
    if (valid > 3) p[3] = v.w;
  }
}

inline bool aligned_to(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<size_t>(p) % bytes == 0;
}

inline bool aligned16(const void* p) { return aligned_to(p, 16); }

// The most dynamic shared memory one block may have on the current card
// (227 KB on an H100), or -1 when the card cannot be asked.
inline int smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Opts a kernel instantiation in to `bytes` of dynamic shared memory (a
// launch above 48 KB needs it), once; returns the attribute call's error.
// A refused call is also cleared from the runtime's last error, which the
// next launch's check (launch_error) would otherwise report.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// The backprojection tile of K2 and K10 (joseph.cu bp_kernel) and E2
// (exp_projector.cu bp_variant_kernel), mirrored by cuda_joseph.BP_TILE and
// BP_WINDOW: a block owns a BP_T x BP_T tile of pixels x SLAB slices, a
// thread BP_PX pixels of one column x 4 slices, and the block streams the
// angles `stage` at a time (K2, E2: BP_G) through a double-buffered ring of
// BP_W staged bins an angle.
constexpr int BP_T = 16;                 // tile side, rows and columns
constexpr int BP_NT = 256;               // threads per block
constexpr int BP_PX = BP_T * BP_T / 32;  // pixels per thread (8)
constexpr int BP_G = 8;                  // K2's and E2's angles per stage
constexpr int BP_W = 24;                 // staged bins per angle

// The dynamic shared memory of one BP block: the ring, then the tables and
// window starts of the na_pad angles it walks.
inline size_t bp_smem(int stage, int na_pad) {
  return 2 * static_cast<size_t>(stage) * BP_W * SLAB * sizeof(float) +
         static_cast<size_t>(na_pad) * (sizeof(float4) + sizeof(int));
}

// The table entries stab[a] and window starts slo[a] of the tile at rows
// r0.., columns c0.. for its na_pad angles (entries past na are {0, 0, 0,
// 0}); cuda_joseph.bp_window_lo mirrors the rule. J* is monotone in x_c and
// y_r, so every tap of the tile (pixels past N included) lies in [lo, lo +
// (BP_T-1)(|sin| + |cos|) + 3), and BP_W = 24 covers it. The caller
// synchronises the block before reading them.
__device__ __forceinline__ void bp_windows(const float4* __restrict__ tab,
                                           int na, int na_pad, int r0, int c0,
                                           int n, int nt, float4* stab,
                                           int* slo) {
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const float xa = static_cast<float>(c0) - ctr;
  const float xb = static_cast<float>(c0 + BP_T - 1) - ctr;
  const float ya = ctr - static_cast<float>(r0);
  const float yb = ctr - static_cast<float>(r0 + BP_T - 1);
  for (int a = threadIdx.x; a < na_pad; a += BP_NT) {
    const float4 t = a < na ? tab[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    stab[a] = t;
    const float lo = fminf(
        fminf(bp_jstar(t, xa, ya, off), bp_jstar(t, xb, ya, off)),
        fminf(bp_jstar(t, xa, yb, off), bp_jstar(t, xb, yb, off)));
    slo[a] = static_cast<int>(floorf(lo));
  }
}

// Stage g of the ring into buf: for each of its `stage` angles, BP_W bins
// from the angle's window start x the SLAB slices from s0 of y (Na, Nt,
// Ns), zeros for bins outside [0, Nt), slices past ns and padded angles
// (a >= na); one commit group.
__device__ __forceinline__ void bp_stage(float* buf,
                                         const float* __restrict__ y,
                                         const int* slo, int g, int stage,
                                         int na, int nt, int ns, int s0,
                                         bool vec) {
  const int shift = vec ? 3 : 5;  // 8 copies of 16 B or 32 of 4 B per row
  for (int i = threadIdx.x; i < (stage * BP_W) << shift; i += BP_NT) {
    const int row = i >> shift;  // k * BP_W + bin offset
    const int k = row / BP_W;
    const int a = g * stage + k;
    const int j = (a < na ? slo[a] : 0) + row - k * BP_W;
    const bool in = a < na && j >= 0 && j < nt;
    copy_slices(buf + row * SLAB,
                y + (in ? (static_cast<size_t>(a) * nt + j) * ns : 0), y, in,
                s0, ns, i & ((1 << shift) - 1), vec);
  }
  copy_commit();
}

}  // namespace tj
