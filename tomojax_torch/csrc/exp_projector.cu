// Experiment projectors E1 (forward) and E2 (back), the counterparts of
// the TPU kernels of scripts/exp_hat_model.py, exp_projector_variants.py,
// exp_projector_variants2.py and exp_pair_fp.py. Each is K1's or K2's
// one-thread-per-output gather with the weight forms of exp_hat.cuh, so a
// script's variant is a template instantiation of one kernel and not a TPU
// tiling: band windows, MXU tiles and VMEM blocks do not carry over.
//
// Bound on the H100: gather issue, as K1/K2 (3.0e9 tap loads per launch at
// 256^3 x 90). The forms change only the arithmetic per tap, so E1/E2 FULL
// against NOHAT (same loads, no hat) and NODOT (hat, no loads) splits a
// projector's time into tap arithmetic and loads.
#include "exp_hat.cuh"

namespace {

using namespace tj::xp;

constexpr int BS = 32;            // slices per block (threadIdx.x)
constexpr int FP_THREADS = 256;   // E1 block, BS x bins x angles, for ab < 8
constexpr int BP_BC = 8;          // E2 columns per block (threadIdx.y)
constexpr int BP_MAX_ANGLES = 3072;

// E1 -- replaces scripts/exp_hat_model.py:_fp_banded_kernel (FULL, HAT5,
// BF16, NOHAT, NODOT), exp_projector_variants.py:_fp_kernel (FULL, W4; its
// a_blk is the angles per block here) and exp_pair_fp.py's paired
// production _fp_banded_kernel (PAIR).
//
// One thread per (angle, bin j, slice s) walks the driving axis: at step k
// the two taps i0 = floor(pos), i0 + 1 of K1's position, each weighted by
// weight<FORM>(j, J*(tap)). A block holds blockDim.z angles (the TPU's
// a_blk, a launch parameter) of blockDim.y bins of 32 slices; a warp is one
// (angle, bin) and 32 contiguous slices.
//
// PAIR: for a series with theta[na-1-i] = -theta[i], J*(-theta, row r) =
// J*(theta, row N-1-r), so the ray of -theta is the ray of +theta through
// the row-flipped volume with the same taps and weights. Thread index z
// runs over the na/2 pairs; each walks the taps of angle na/2 + z and
// writes that angle's ray and the ray of angle na/2 - 1 - z, reading the
// flipped row in place.
template <int FORM, bool PAIR, bool ROW>
__device__ __forceinline__ void fp_walk(const float* __restrict__ xs,
                                        float4 ft, float4 bt, int n, int nt,
                                        int ns, int j, float& acc,
                                        float& acc_m) {
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const float jf = static_cast<float>(j);
  const float base = __fmul_rn(jf - off, ft.x);
  const float invd = bt.z, inv2 = __fmul_rn(bt.z, bt.z);
  const size_t plane = static_cast<size_t>(n) * ns;
#pragma unroll 4  // the loads of 4 steps issue before their serial sums
  for (int k = 0; k < n; ++k) {
    const float fk = static_cast<float>(k);
    const float f = floorf(fp_pos<ROW>(ft, base, ctr, fk));
    const int i0 = static_cast<int>(f);
    const float w0 = weight<FORM>(
        jf, FORM == NOHAT ? 0.f : tap_jstar<ROW>(bt, ctr, off, fk, f), invd,
        inv2);
    const float w1 = weight<FORM>(
        jf,
        FORM == NOHAT ? 0.f
                      : tap_jstar<ROW>(bt, ctr, off, fk, __fadd_rn(f, 1.f)),
        invd, inv2);
    if (FORM == NODOT) {
      acc = __fadd_rn(acc, w0);
      acc = __fadd_rn(acc, w1);
      continue;
    }
    const float v0 = tap_load<ROW>(xs, n, ns, plane, k, i0, false);
    const float v1 = tap_load<ROW>(xs, n, ns, plane, k, i0 + 1, false);
    acc = __fadd_rn(acc, __fmul_rn(w0, v0));
    acc = __fadd_rn(acc, __fmul_rn(w1, v1));
    if (PAIR) {
      const float u0 = tap_load<ROW>(xs, n, ns, plane, k, i0, true);
      const float u1 = tap_load<ROW>(xs, n, ns, plane, k, i0 + 1, true);
      acc_m = __fadd_rn(acc_m, __fmul_rn(w0, u0));
      acc_m = __fadd_rn(acc_m, __fmul_rn(w1, u1));
    }
  }
}

template <int FORM, bool PAIR>
__global__ void __launch_bounds__(1024)
fp_variant_kernel(const float* __restrict__ x, const float4* __restrict__ ftab,
                  const float4* __restrict__ btab, float* __restrict__ out,
                  int n, int nt, int na, int ns) {
  const int s = blockIdx.x * BS + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z * blockDim.z + threadIdx.z;
  if (s >= ns || j >= nt || z >= (PAIR ? na / 2 : na)) return;
  const int a = PAIR ? na / 2 + z : z;
  const float4 ft = ftab[a], bt = btab[a];
  float acc = 0.f, acc_m = 0.f;
  if (ft.w != 0.f) {
    fp_walk<FORM, PAIR, true>(x + s, ft, bt, n, nt, ns, j, acc, acc_m);
  } else {
    fp_walk<FORM, PAIR, false>(x + s, ft, bt, n, nt, ns, j, acc, acc_m);
  }
  if (FORM == HAT5 || FORM == BF16) acc = __fmul_rn(acc, bt.z);
  out[(static_cast<size_t>(a) * nt + j) * ns + s] = acc;
  if (PAIR) out[(static_cast<size_t>(na - 1 - a) * nt + j) * ns + s] = acc_m;
}

// E2 -- replaces scripts/exp_hat_model.py:_bp_kernel (FULL, BF16, NOHAT,
// NODOT) and _bp_banded_kernel_v (the same operator with a TPU band; no
// banded split on Hopper, as K2), exp_projector_variants.py:_bp_kernel
// (FULL, W4) and exp_projector_variants2.py:_bp2_kernel (FULL with APS 2).
//
// One thread per voxel (r, c, s) loops over the angles as K2: the bins
// j0 = floor(J*), j0 + 1 weighted by weight<FORM>(j, J*). APS = 2 takes two
// angles per step and issues their four sinogram loads before the first
// product; the products are added in K2's angle order, so APS does not
// change the result.
template <int FORM>
__device__ __forceinline__ void bp_taps_of(float4 t, float xc, float yr,
                                           float off, int& j0, float& w0,
                                           float& w1) {
  const float jstar = tj::bp_jstar(t, xc, yr, off);
  const float f = floorf(jstar);
  const float inv2 = __fmul_rn(t.z, t.z);
  j0 = static_cast<int>(f);
  w0 = weight<FORM>(f, jstar, t.z, inv2);
  w1 = weight<FORM>(__fadd_rn(f, 1.f), jstar, t.z, inv2);
}

template <int FORM>
__device__ __forceinline__ float bp_load(const float* __restrict__ ya,
                                         int j, int nt, int ns, float invd) {
  if (FORM == NODOT) return 0.f;
  const float v = (j >= 0 && j < nt) ? ya[j * ns] : 0.f;
  return FORM == BF16 ? __fmul_rn(v, invd) : v;  // BF16: y invd, in f32
}

template <int FORM>
__device__ __forceinline__ float bp_add(float acc, float w0, float w1,
                                        float v0, float v1) {
  if (FORM == NODOT) return __fadd_rn(__fadd_rn(acc, w0), w1);
  return __fadd_rn(__fadd_rn(acc, __fmul_rn(w0, v0)), __fmul_rn(w1, v1));
}

template <int FORM, int APS>
__global__ void __launch_bounds__(BS * BP_BC)
bp_variant_kernel(const float* __restrict__ y, const float4* __restrict__ tab,
                  float* __restrict__ out, int n, int nt, int na, int ns) {
  extern __shared__ float4 stab[];
  const int tid = threadIdx.y * BS + threadIdx.x;
  for (int i = tid; i < na; i += BS * BP_BC) stab[i] = tab[i];
  __syncthreads();

  const int s = blockIdx.x * BS + threadIdx.x;
  const int c = blockIdx.y * BP_BC + threadIdx.y;
  const int r = blockIdx.z;
  if (s >= ns || c >= n) return;
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float xc = static_cast<float>(c) - ctr;
  const float yr = ctr - static_cast<float>(r);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const size_t plane = static_cast<size_t>(nt) * ns;
  const float* ys = y + s;
  float acc = 0.f;
  int a = 0;
  if (APS == 2) {
    for (; a + 1 < na; a += 2) {
      const float4 t0 = stab[a], t1 = stab[a + 1];
      int j0, j1;
      float w00, w01, w10, w11;
      bp_taps_of<FORM>(t0, xc, yr, off, j0, w00, w01);
      bp_taps_of<FORM>(t1, xc, yr, off, j1, w10, w11);
      const float* y0 = ys + a * plane;
      const float* y1 = y0 + plane;
      const float v00 = bp_load<FORM>(y0, j0, nt, ns, t0.z);
      const float v01 = bp_load<FORM>(y0, j0 + 1, nt, ns, t0.z);
      const float v10 = bp_load<FORM>(y1, j1, nt, ns, t1.z);
      const float v11 = bp_load<FORM>(y1, j1 + 1, nt, ns, t1.z);
      acc = bp_add<FORM>(acc, w00, w01, v00, v01);
      acc = bp_add<FORM>(acc, w10, w11, v10, v11);
    }
  }
  for (; a < na; ++a) {
    const float4 t = stab[a];
    int j0;
    float w0, w1;
    bp_taps_of<FORM>(t, xc, yr, off, j0, w0, w1);
    const float* ya = ys + a * plane;
    acc = bp_add<FORM>(acc, w0, w1, bp_load<FORM>(ya, j0, nt, ns, t.z),
                       bp_load<FORM>(ya, j0 + 1, nt, ns, t.z));
  }
  out[(static_cast<size_t>(r) * n + c) * ns + s] = acc;
}

struct Launch {
  const float* in;  // x (E1) or y (E2)
  const float4* ft;
  const float4* bt;
  float* out;
  int n, nt, na, ns, ab;
  cudaStream_t st;
};

template <int FORM, bool PAIR>
int launch_fp(const Launch& g) {
  const int bj = g.ab >= FP_THREADS / BS ? 1 : FP_THREADS / BS / g.ab;
  const int nz = PAIR ? g.na / 2 : g.na;
  const dim3 block(BS, bj, g.ab);
  const dim3 grid((g.ns + BS - 1) / BS, (g.nt + bj - 1) / bj,
                  (nz + g.ab - 1) / g.ab);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  fp_variant_kernel<FORM, PAIR><<<grid, block, 0, g.st>>>(
      g.in, g.ft, g.bt, g.out, g.n, g.nt, g.na, g.ns);
  return tj::launch_error();
}

template <int FORM, int APS>
int launch_bp(const Launch& g) {
  const dim3 grid((g.ns + BS - 1) / BS, (g.n + BP_BC - 1) / BP_BC, g.n);
  bp_variant_kernel<FORM, APS><<<grid, dim3(BS, BP_BC),
                                 g.na * sizeof(float4), g.st>>>(
      g.in, g.bt, g.out, g.n, g.nt, g.na, g.ns);
  return tj::launch_error();
}

}  // namespace

// E1: out (Na, Nt, Ns) from x (N, N, Ns); form a Form, pair 0/1 (PAIR with
// FULL only; Na even, the caller checks the symmetry), ab the angles per
// block (1, 2, 4, 8, 16 or 32).
TJ_API int tj_exp_fp(int form, int pair, const float* x, const float* fp_tab,
                     const float* bp_tab, float* out, int n, int nt, int na,
                     int ns, int ab, void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || n > 65535 ||
      (ab & (ab - 1)) != 0 || ab < 1 || ab > 32 ||
      (pair && (form != FULL || na % 2 != 0))) {
    return cudaErrorInvalidValue;
  }
  const Launch g{x, reinterpret_cast<const float4*>(fp_tab),
                 reinterpret_cast<const float4*>(bp_tab), out, n, nt, na, ns,
                 ab, static_cast<cudaStream_t>(stream)};
  if (pair) return launch_fp<FULL, true>(g);
  switch (form) {
    case FULL: return launch_fp<FULL, false>(g);
    case HAT5: return launch_fp<HAT5, false>(g);
    case BF16: return launch_fp<BF16, false>(g);
    case NOHAT: return launch_fp<NOHAT, false>(g);
    case NODOT: return launch_fp<NODOT, false>(g);
    case W4: return launch_fp<W4, false>(g);
    default: return cudaErrorInvalidValue;
  }
}

// E2: out (N, N, Ns) from y (Na, Nt, Ns); form a Form other than HAT5, aps
// 1 or 2 (2 with FULL only).
TJ_API int tj_exp_bp(int form, int aps, const float* y, const float* bp_tab,
                     float* out, int n, int nt, int na, int ns,
                     void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || na > BP_MAX_ANGLES ||
      n > 65535 || (aps != 1 && aps != 2) || (aps == 2 && form != FULL)) {
    return cudaErrorInvalidValue;
  }
  const Launch g{y, nullptr, reinterpret_cast<const float4*>(bp_tab), out, n,
                 nt, na, ns, 1, static_cast<cudaStream_t>(stream)};
  if (aps == 2) return launch_bp<FULL, 2>(g);
  switch (form) {
    case FULL: return launch_bp<FULL, 1>(g);
    case BF16: return launch_bp<BF16, 1>(g);
    case NOHAT: return launch_bp<NOHAT, 1>(g);
    case NODOT: return launch_bp<NODOT, 1>(g);
    case W4: return launch_bp<W4, 1>(g);
    default: return cudaErrorInvalidValue;
  }
}
