// FGP TV prox for Hopper: K3 (one fused FGP iteration) and K4 (the final
// objective pass with the FISTA Nesterov step as an epilogue).
//
// Volume x (n0, n1, n2) f32, contiguous, n2 fastest; duals P1..P3 of the
// same shape stored as T (float or bf16). FGP does not change under a
// permutation of the axes (the same boundary rule holds on every axis),
// so the kernels use the axis roles of the array they are given, as the
// JAX call on the same array does: P1 pairs with axis 0, P2 with axis 1,
// P3 with axis 2. Arithmetic is f32 throughout; duals are rounded to T
// only when stored (tomojax/tv/pallas_fgp.py:143-184).
#include "common.cuh"

namespace {

constexpr int BX = 32;  // axis-2 voxels per block (threadIdx.x)
constexpr int BY = 8;   // axis-1 voxels per block (threadIdx.y)

struct Vol {
  int n0, n1, n2;
  __device__ size_t at(int i0, int i1, int i2) const {
    return (static_cast<size_t>(i0) * n1 + i1) * n2 + i2;
  }
};

// d = max(x - lam * div P, 0) at one voxel. div is the sum of backward
// differences with P[-1] = 0 below the low boundary of each axis
// (reference tv_fgp.cu:56-62, tomojax/tv/__init__.py:_bdiff_accum).
template <typename T>
__device__ __forceinline__ float objective(const float* __restrict__ x,
                                           const T* __restrict__ p1,
                                           const T* __restrict__ p2,
                                           const T* __restrict__ p3,
                                           const Vol& v, int i0, int i1,
                                           int i2, float lam) {
  const size_t o = v.at(i0, i1, i2);
  float div = tj::load(p1, o) -
              (i0 > 0 ? tj::load(p1, o - static_cast<size_t>(v.n1) * v.n2)
                      : 0.f);
  div += tj::load(p2, o) - (i1 > 0 ? tj::load(p2, o - v.n2) : 0.f);
  div += tj::load(p3, o) - (i2 > 0 ? tj::load(p3, o - 1) : 0.f);
  return fmaxf(__fsub_rn(x[o], __fmul_rn(lam, div)), 0.f);
}

// K3 -- replaces tomojax/tv/pallas_fgp.py:_fused_kernel.
//
// One thread per voxel: d at the voxel and at its +1 neighbour along each
// axis (recomputed from P_in, never stored), the forward difference
// g = d - d(+1) (zero at the far boundary), P += g / (26 lam), and the
// isotropic projection: if |P|^2 > 1, P *= 1/sqrt(|P|^2). It reads P_in and
// writes P_out (ping-pong), so no thread reads a neighbour's updated P.
//
// Bound on the H100: device memory. At 256^3 with bf16 duals one launch
// must move 64 MiB of x and 96 MiB of duals in and 96 MiB out; the
// neighbour reloads (x and P at the +1 voxels) hit L1/L2, because the
// axis-2 neighbours sit in the same warp and the axis-0/1 neighbours are
// read by nearby blocks in the same wave.
template <typename T>
__global__ void __launch_bounds__(BX * BY)
fgp_iter_kernel(const float* __restrict__ x, const T* __restrict__ p1,
                const T* __restrict__ p2, const T* __restrict__ p3,
                T* __restrict__ o1, T* __restrict__ o2, T* __restrict__ o3,
                Vol v, float lam, float multip) {
  const int i2 = blockIdx.x * BX + threadIdx.x;
  const int i1 = blockIdx.y * BY + threadIdx.y;
  const int i0 = blockIdx.z;
  if (i2 >= v.n2 || i1 >= v.n1) return;
  const float d = objective(x, p1, p2, p3, v, i0, i1, i2, lam);
  const float g1 =
      i0 < v.n0 - 1 ? d - objective(x, p1, p2, p3, v, i0 + 1, i1, i2, lam)
                    : 0.f;
  const float g2 =
      i1 < v.n1 - 1 ? d - objective(x, p1, p2, p3, v, i0, i1 + 1, i2, lam)
                    : 0.f;
  const float g3 =
      i2 < v.n2 - 1 ? d - objective(x, p1, p2, p3, v, i0, i1, i2 + 1, lam)
                    : 0.f;
  // Rounded as the plain version rounds (no FMA contraction, rsqrt as in
  // the reference), so that bf16 storage rounds the same values.
  const size_t o = v.at(i0, i1, i2);
  const float q1 = __fadd_rn(tj::load(p1, o), __fmul_rn(multip, g1));
  const float q2 = __fadd_rn(tj::load(p2, o), __fmul_rn(multip, g2));
  const float q3 = __fadd_rn(tj::load(p3, o), __fmul_rn(multip, g3));
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(q1, q1), __fmul_rn(q2, q2)),
                              __fmul_rn(q3, q3));
  const float sc = den > 1.f ? rsqrtf(den) : 1.f;
  o1[o] = tj::store<T>(q1 * sc);
  o2[o] = tj::store<T>(q2 * sc);
  o3[o] = tj::store<T>(q3 * sc);
}

// K4 -- replaces tomojax/tv/pallas_fgp.py:_obj_mom_kernel (MOM true) and
// _obj_kernel (MOM false).
//
// d = max(x - lam div P, 0), the FGP result; with MOM also the FISTA
// Nesterov step y = d + beta (d - x_old), beta read from device memory so
// the host never waits for it.
//
// Bound on the H100: one streaming pass (x, three duals and x_old in;
// d and y out).
template <typename T, bool MOM>
__global__ void __launch_bounds__(BX * BY)
fgp_obj_kernel(const float* __restrict__ x, const T* __restrict__ p1,
               const T* __restrict__ p2, const T* __restrict__ p3,
               const float* __restrict__ x_old,
               const float* __restrict__ beta, float* __restrict__ d_out,
               float* __restrict__ y_out, Vol v, float lam) {
  const int i2 = blockIdx.x * BX + threadIdx.x;
  const int i1 = blockIdx.y * BY + threadIdx.y;
  const int i0 = blockIdx.z;
  if (i2 >= v.n2 || i1 >= v.n1) return;
  const size_t o = v.at(i0, i1, i2);
  const float d = objective(x, p1, p2, p3, v, i0, i1, i2, lam);
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

template <typename T>
void launch_iter(const float* x, const void* p1, const void* p2,
                 const void* p3, void* o1, void* o2, void* o3, Vol v,
                 float lam, float multip, cudaStream_t st) {
  fgp_iter_kernel<T><<<vol_grid(v), dim3(BX, BY), 0, st>>>(
      x, static_cast<const T*>(p1), static_cast<const T*>(p2),
      static_cast<const T*>(p3), static_cast<T*>(o1), static_cast<T*>(o2),
      static_cast<T*>(o3), v, lam, multip);
}

template <typename T>
void launch_obj(const float* x, const void* p1, const void* p2,
                const void* p3, const float* x_old, const float* beta,
                float* d, float* y, Vol v, float lam, cudaStream_t st) {
  const auto* q1 = static_cast<const T*>(p1);
  const auto* q2 = static_cast<const T*>(p2);
  const auto* q3 = static_cast<const T*>(p3);
  if (x_old != nullptr) {
    fgp_obj_kernel<T, true><<<vol_grid(v), dim3(BX, BY), 0, st>>>(
        x, q1, q2, q3, x_old, beta, d, y, v, lam);
  } else {
    fgp_obj_kernel<T, false><<<vol_grid(v), dim3(BX, BY), 0, st>>>(
        x, q1, q2, q3, nullptr, nullptr, d, nullptr, v, lam);
  }
}

}  // namespace

// bf16 != 0: duals are __nv_bfloat16, else float.
TJ_API int tj_fgp_iter(const float* x, const void* p1, const void* p2,
                       const void* p3, void* o1, void* o2, void* o3, int n0,
                       int n1, int n2, int bf16, float lam, float multip,
                       void* stream) {
  if (!vol_ok(n0, n1, n2)) return cudaErrorInvalidValue;
  const Vol v{n0, n1, n2};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_iter<__nv_bfloat16>(x, p1, p2, p3, o1, o2, o3, v, lam, multip, st);
  } else {
    launch_iter<float>(x, p1, p2, p3, o1, o2, o3, v, lam, multip, st);
  }
  return tj::launch_error();
}

// x_old, beta and y all null: d only; all set: the Nesterov epilogue.
TJ_API int tj_fgp_obj(const float* x, const void* p1, const void* p2,
                      const void* p3, const float* x_old, const float* beta,
                      float* d, float* y, int n0, int n1, int n2, int bf16,
                      float lam, void* stream) {
  const bool mom = x_old != nullptr;
  if (!vol_ok(n0, n1, n2) || (beta != nullptr) != mom ||
      (y != nullptr) != mom) {
    return cudaErrorInvalidValue;
  }
  const Vol v{n0, n1, n2};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_obj<__nv_bfloat16>(x, p1, p2, p3, x_old, beta, d, y, v, lam, st);
  } else {
    launch_obj<float>(x, p1, p2, p3, x_old, beta, d, y, v, lam, st);
  }
  return tj::launch_error();
}
