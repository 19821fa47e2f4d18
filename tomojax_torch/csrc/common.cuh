// Shared helpers for the port's kernels: dual-storage loads and stores,
// a deterministic block sum, the fixed-order second stage of the
// reductions, and the launch-error return convention.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TJ_API extern "C" __attribute__((visibility("default")))

namespace tj {

template <typename T>
__device__ __forceinline__ float load(const T* p, size_t i);
template <>
__device__ __forceinline__ float load<float>(const float* p, size_t i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ T store(float v);
template <>
__device__ __forceinline__ float store<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of `v` over a block of NT threads (a power of two), in a fixed tree
// order, so that repeated runs give identical results (no float atomics).
// Every thread of the block must call it. The result is valid in thread 0.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* buf) {
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y *
                                              threadIdx.z);
  buf[tid] = v;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) buf[tid] += buf[tid + s];
    __syncthreads();
  }
  return buf[0];
}

// out[0] = sum of partials[0 .. count) in a fixed order (one block; the
// second stage of K1's data-distance sum and of K5). Defined in
// tv_value.cu.
cudaError_t sum_partials(const float* partials, float* out, int count,
                         cudaStream_t stream);

// A launch that cannot be configured is refused here, before it is made.
inline int launch_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace tj

TJ_API const char* tj_error_string(int err);
