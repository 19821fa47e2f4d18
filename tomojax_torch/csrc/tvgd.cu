// K7 -- replaces tomojax/tv/pallas_tvgd.py:_grad_kernel.
//
// The 4-term isotropic TV subgradient with periodic wrap on all three axes
// (tomojax/tv/__init__.py:_tv_grad) of a contiguous (n0, n1, n2) f32
// volume, plus ||g||^2. In the port's slice-last layout (N, N, Ns) the
// reference's axes map as i (slices) -> axis 2, j (rows) -> axis 0,
// k (columns) -> axis 1. With D(v) = sqrt(eps + (x_v - x_{v+i})^2 +
// (x_v - x_{v+j})^2 + (x_v - x_{v+k})^2),
//   g = (3 x - x_{+i} - x_{+j} - x_{+k}) / D(v)
//     + (x - x_{-i}) / D(v-i) + (x - x_{-j}) / D(v-j) + (x - x_{-k}) / D(v-k).
// Every sum and product is rounded as the reference writes it (slice term,
// then row, then column), with round-to-nearest intrinsics, so no FMA
// contraction moves the kernel off its plain version.
//
// Bound on the H100: one streaming pass over x (64 MiB at 256^3) and one
// over g. One thread per voxel, axis 2 across the warp, so every load is a
// contiguous row; the 12 neighbour reads fall on rows this or a nearby
// block reads and hit L1/L2. Each thread recomputes the three neighbour
// denominators instead of a second pass over a D field (4 sqrt per voxel
// against 64 MiB more traffic). The block's partial sum of g^2 goes to a
// partials buffer, and tj::sum_partials adds the partials in a fixed order:
// no float atomics, so ||g||^2 repeats bit for bit and the descent loop
// never reads it on the host.
#include "common.cuh"

namespace {

constexpr int GD_BX = 32;  // axis-2 voxels per block (threadIdx.x)
constexpr int GD_BY = 8;   // axis-1 voxels per block (threadIdx.y)
constexpr int GD_NT = GD_BX * GD_BY;
constexpr float EPS_TV = 1e-6f;

__device__ __forceinline__ float sq_diff(float a, float b) {
  const float d = __fsub_rn(a, b);
  return __fmul_rn(d, d);
}

// D at a voxel with value c whose +i, +j, +k neighbours are pi, pj, pk.
__device__ __forceinline__ float denom(float c, float pi, float pj,
                                       float pk) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fadd_rn(EPS_TV, sq_diff(c, pi)),
                                        sq_diff(c, pj)),
                              sq_diff(c, pk)));
}

__global__ void __launch_bounds__(GD_NT)
tv_grad_kernel(const float* __restrict__ x, float* __restrict__ g,
               float* __restrict__ partials, int n0, int n1, int n2) {
  const int i2 = blockIdx.x * GD_BX + threadIdx.x;
  const int i1 = blockIdx.y * GD_BY + threadIdx.y;
  const int i0 = blockIdx.z;
  float gsq = 0.f;
  if (i2 < n2 && i1 < n1) {
    const int p0 = i0 + 1 == n0 ? 0 : i0 + 1;
    const int m0 = i0 == 0 ? n0 - 1 : i0 - 1;
    const int p1 = i1 + 1 == n1 ? 0 : i1 + 1;
    const int m1 = i1 == 0 ? n1 - 1 : i1 - 1;
    const int p2 = i2 + 1 == n2 ? 0 : i2 + 1;
    const int m2 = i2 == 0 ? n2 - 1 : i2 - 1;
    auto at = [&](int a0, int a1, int a2) {
      return x[(static_cast<size_t>(a0) * n1 + a1) * n2 + a2];
    };
    const float c = at(i0, i1, i2);
    const float ip = at(i0, i1, p2), jp = at(p0, i1, i2), kp = at(i0, p1, i2);
    const float im = at(i0, i1, m2), jm = at(m0, i1, i2), km = at(i0, m1, i2);
    const float d = denom(c, ip, jp, kp);
    const float d_im = denom(im, c, at(p0, i1, m2), at(i0, p1, m2));
    const float d_jm = denom(jm, at(m0, i1, p2), c, at(m0, p1, i2));
    const float d_km = denom(km, at(i0, m1, p2), at(p0, m1, i2), c);
    const float num = __fsub_rn(
        __fsub_rn(__fsub_rn(__fmul_rn(3.f, c), ip), jp), kp);
    float gv = __fdiv_rn(num, d);
    gv = __fadd_rn(gv, __fdiv_rn(__fsub_rn(c, im), d_im));
    gv = __fadd_rn(gv, __fdiv_rn(__fsub_rn(c, jm), d_jm));
    gv = __fadd_rn(gv, __fdiv_rn(__fsub_rn(c, km), d_km));
    g[(static_cast<size_t>(i0) * n1 + i1) * n2 + i2] = gv;
    gsq = __fmul_rn(gv, gv);
  }
  __shared__ float buf[GD_NT];
  const float total = tj::block_sum<GD_NT>(gsq, buf);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[(static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                 gridDim.x + blockIdx.x] = total;
  }
}

dim3 gd_grid(int n0, int n1, int n2) {
  return dim3((n2 + GD_BX - 1) / GD_BX, (n1 + GD_BY - 1) / GD_BY, n0);
}

}  // namespace

TJ_API int tj_tv_grad_partials(int n0, int n1, int n2) {
  const dim3 g = gd_grid(n0, n1, n2);
  return static_cast<int>(g.x * g.y * g.z);
}

// partials: tj_tv_grad_partials(n0, n1, n2) floats of scratch; gsq: 1
// float, the fixed-order sum of the partials (||g||^2).
TJ_API int tj_tv_grad(const float* x, float* g, float* partials, float* gsq,
                      int n0, int n1, int n2, void* stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || n0 > 65535 ||
      (n1 + GD_BY - 1) / GD_BY > 65535) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  tv_grad_kernel<<<gd_grid(n0, n1, n2), dim3(GD_BX, GD_BY), 0, st>>>(
      x, g, partials, n0, n1, n2);
  const int err = tj::launch_error();
  if (err != 0) return err;
  return static_cast<int>(
      tj::sum_partials(partials, gsq, tj_tv_grad_partials(n0, n1, n2), st));
}
