// K5 -- replaces tomojax/tv/pallas_tv_value.py:_tv_value_kernel.
//
// Isotropic TV value with periodic wrap on all three axes,
//   sum sqrt(1e-6 + (x - x[i0+1])^2 + (x - x[i1+1])^2 + (x - x[i2+1])^2),
// of a contiguous (n0, n1, n2) f32 volume (the FISTA metric). On a slab of
// a z-sharded volume (HALO) the axis-2 neighbour of the last slice is the
// right rank's first slice, a (n0, n1) halo plane, instead of the in-slab
// wrap; the caller all-reduces the slab's sum.
//
// Bound on the H100: one streaming pass (64 MiB at 256^3). Stage 1: one
// thread per voxel, axis 2 across the warp so that every load is a
// contiguous row (the +1 neighbours are rows the same or a nearby block
// reads, so they hit L1/L2); per-block tree sums to a partials buffer.
// Stage 2: one block sums the partials in a fixed order. No float atomics,
// so repeated runs give identical metrics.
#include "common.cuh"

namespace {

constexpr int TV_BX = 32;  // axis-2 voxels per block (threadIdx.x)
constexpr int TV_BY = 8;   // axis-1 voxels per block (threadIdx.y)
constexpr int TV_NT = TV_BX * TV_BY;
constexpr int SUM_NT = 1024;

template <bool HALO>
__global__ void __launch_bounds__(TV_NT)
tv_value_kernel(const float* __restrict__ x, const float* __restrict__ hi,
                float* __restrict__ partials, int n0, int n1, int n2) {
  const int i2 = blockIdx.x * TV_BX + threadIdx.x;
  const int i1 = blockIdx.y * TV_BY + threadIdx.y;
  const int i0 = blockIdx.z;
  float t = 0.f;
  if (i2 < n2 && i1 < n1) {
    const int j0 = i0 + 1 == n0 ? 0 : i0 + 1;
    const int j1 = i1 + 1 == n1 ? 0 : i1 + 1;
    const int j2 = i2 + 1 == n2 ? 0 : i2 + 1;
    const size_t row = static_cast<size_t>(i0) * n1;
    const float c = x[(row + i1) * n2 + i2];
    const float d0 = c - x[(static_cast<size_t>(j0) * n1 + i1) * n2 + i2];
    const float d1 = c - x[(row + j1) * n2 + i2];
    const float d2 =
        c - (HALO && j2 == 0 ? hi[row + i1] : x[(row + i1) * n2 + j2]);
    t = sqrtf(1e-6f + d0 * d0 + d1 * d1 + d2 * d2);
  }
  __shared__ float buf[TV_NT];
  const float total = tj::block_sum<TV_NT>(t, buf);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[(static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                 gridDim.x + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(SUM_NT)
sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
           int count) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += SUM_NT) acc += partials[i];
  __shared__ float buf[SUM_NT];
  const float total = tj::block_sum<SUM_NT>(acc, buf);
  if (threadIdx.x == 0) out[0] = total;
}

dim3 tv_grid(int n0, int n1, int n2) {
  return dim3((n2 + TV_BX - 1) / TV_BX, (n1 + TV_BY - 1) / TV_BY, n0);
}

bool tv_shape_ok(int n0, int n1, int n2) {
  return n0 > 0 && n1 > 0 && n2 > 0 && n0 <= 65535 &&
         (n1 + TV_BY - 1) / TV_BY <= 65535;
}

}  // namespace

namespace tj {

cudaError_t sum_partials(const float* partials, float* out, int count,
                         cudaStream_t stream) {
  if (count <= 0) return cudaErrorInvalidValue;
  sum_kernel<<<1, SUM_NT, 0, stream>>>(partials, out, count);
  return cudaGetLastError();
}

}  // namespace tj

TJ_API int tj_tv_value_partials(int n0, int n1, int n2) {
  const dim3 g = tv_grid(n0, n1, n2);
  return static_cast<int>(g.x * g.y * g.z);
}

// partials: tj_tv_value_partials(n0, n1, n2) floats of scratch; out: 1 float.
// hi: null (periodic wrap on axis 2) or the (n0, n1) plane above slice
// n2 - 1.
TJ_API int tj_tv_value(const float* x, const float* hi, float* partials,
                       float* out, int n0, int n1, int n2, void* stream) {
  if (!tv_shape_ok(n0, n1, n2)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = tv_grid(n0, n1, n2), block(TV_BX, TV_BY);
  if (hi != nullptr) {
    tv_value_kernel<true><<<grid, block, 0, st>>>(x, hi, partials, n0, n1,
                                                  n2);
  } else {
    tv_value_kernel<false><<<grid, block, 0, st>>>(x, nullptr, partials, n0,
                                                   n1, n2);
  }
  const int err = tj::launch_error();
  if (err != 0) return err;
  return static_cast<int>(
      tj::sum_partials(partials, out, tj_tv_value_partials(n0, n1, n2), st));
}
