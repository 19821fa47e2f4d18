// K7 -- replaces tomojax/tv/pallas_tvgd.py:_grad_kernel (HALO false).
// K9c -- replaces tomojax/tv/pallas_tvgd_sharded.py:_grad_kernel_halo
// (HALO true): the same body on a slab of a z-sharded volume, whose axis-2
// neighbours below slice 0 and above slice n2 - 1 come from the ring's
// halo planes instead of the in-slab wrap. Its g equals K7's on the whole
// volume bit for bit; its ||g||^2 is the slab's partial, which the caller
// all-reduces.
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

// lo, hi: (n0, n1) planes at slices -1 and n2 (HALO only).
template <bool HALO>
__global__ void __launch_bounds__(GD_NT)
tv_grad_kernel(const float* __restrict__ x, const float* __restrict__ lo,
               const float* __restrict__ hi, float* __restrict__ g,
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
    // Slices i2 - 1, i2 and i2 + 1: element (a0, a1) at [(a0 n1 + a1) st].
    // With HALO the slices past the slab's ends are the halo planes
    // (stride 1) instead of the wrap; choosing pointers, not branching
    // around loads, keeps every load unconditional.
    const bool lo_halo = HALO && i2 == 0, hi_halo = HALO && i2 + 1 == n2;
    const float* xm = lo_halo ? lo : x + m2;
    const float* xp = hi_halo ? hi : x + p2;
    const size_t sm = lo_halo ? 1 : n2, sp = hi_halo ? 1 : n2;
    auto row = [&](int a0, int a1) {
      return static_cast<size_t>(a0) * n1 + a1;
    };
    auto C = [&](int a0, int a1) { return x[row(a0, a1) * n2 + i2]; };
    auto M = [&](int a0, int a1) { return xm[row(a0, a1) * sm]; };
    auto P = [&](int a0, int a1) { return xp[row(a0, a1) * sp]; };
    const float c = C(i0, i1);
    const float ip = P(i0, i1), jp = C(p0, i1), kp = C(i0, p1);
    const float im = M(i0, i1), jm = C(m0, i1), km = C(i0, m1);
    const float d = denom(c, ip, jp, kp);
    const float d_im = denom(im, c, M(p0, i1), M(i0, p1));
    const float d_jm = denom(jm, P(m0, i1), c, C(m0, p1));
    const float d_km = denom(km, P(i0, m1), C(p0, m1), c);
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
namespace {

int launch_grad(const float* x, const float* lo, const float* hi, float* g,
                float* partials, float* gsq, int n0, int n1, int n2,
                void* stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || n0 > 65535 ||
      (n1 + GD_BY - 1) / GD_BY > 65535) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = gd_grid(n0, n1, n2), block(GD_BX, GD_BY);
  if (lo != nullptr) {
    tv_grad_kernel<true><<<grid, block, 0, st>>>(x, lo, hi, g, partials, n0,
                                                 n1, n2);
  } else {
    tv_grad_kernel<false><<<grid, block, 0, st>>>(x, nullptr, nullptr, g,
                                                  partials, n0, n1, n2);
  }
  const int err = tj::launch_error();
  if (err != 0) return err;
  return static_cast<int>(
      tj::sum_partials(partials, gsq, tj_tv_grad_partials(n0, n1, n2), st));
}

}  // namespace

TJ_API int tj_tv_grad(const float* x, float* g, float* partials, float* gsq,
                      int n0, int n1, int n2, void* stream) {
  return launch_grad(x, nullptr, nullptr, g, partials, gsq, n0, n1, n2,
                     stream);
}

// K9c: lo, hi are the (n0, n1) planes below slice 0 and above slice n2 - 1
// (the ring neighbours' last and first slices); both required.
TJ_API int tj_tv_grad_halo(const float* x, const float* lo, const float* hi,
                           float* g, float* partials, float* gsq, int n0,
                           int n1, int n2, void* stream) {
  if (lo == nullptr || hi == nullptr) return cudaErrorInvalidValue;
  return launch_grad(x, lo, hi, g, partials, gsq, n0, n1, n2, stream);
}
