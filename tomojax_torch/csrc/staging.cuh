// Shared-memory staging helpers of the slab-resident projectors: K1 and K2
// (joseph.cu) and E1 (exp_projector.cu). A block owns SLAB slices of a tile
// of outputs and copies the part of its input that the tile's taps reach
// into a double-buffered ring in shared memory with cp.async (zeros for
// positions or slices outside the operand); its threads then read 4 slices
// at a time as one 16-byte load.
#pragma once

#include "common.cuh"

namespace tj {

constexpr int SLAB = 32;  // slices per block of K1, K2, K10 and E1

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from src into shared dst, or zeros when !ok (src is then
// not read; `safe` is any valid address).
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       const float* safe, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(ok ? src : safe), "r"(ok ? 16 : 0));
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

inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0;
}

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
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  return static_cast<int>(err);
}

}  // namespace tj
