// Joseph tap helpers shared by the projector pair (joseph.cu: K1, K2), the
// SART sweep (sart.cu: K8) and the experiment kernels (exp_hat.cuh), so
// every kernel picks its taps with the same arithmetic. Slice-last
// layouts: volume x[r][c][s] (N, N, Ns), sinogram plane y[j][s] (Nt, Ns);
// s is the caller's slice index.
#pragma once

#include "common.cuh"

namespace tj {

// The tiling of K1's host plan (cuda_joseph.fp_plan: FP_GROUP, FP_BINS,
// FP_STEPS, FP_WINDOW), which E1 (exp_projector.cu) reads as well: groups
// of up to FP_G angles of one driving type x FP_B bins, walked FP_K
// driving steps a chunk, windows of at most FP_W positions a step.
constexpr int FP_G = 8;
constexpr int FP_B = 32;
constexpr int FP_K = 2;
constexpr int FP_W = 96;

// Unscaled driving-axis sum of one ray (bin j, slice s) through x, as
// tomojax/projector/joseph.py:_fp_branch walks it. t = {1/denom, shear,
// 1/|denom|, row_driven} (cuda_joseph.angle_tables, f64 rounded to f32).
// Row-driven angles step over rows r and interpolate two columns at
//   pos = t_j / cos + y_r (-sin / cos) + (N-1)/2,
// column-driven angles step over columns and interpolate two rows at
//   pos = (N-1)/2 - t_j / sin + x_c (cos / sin);
// out-of-range taps read 0. The position is computed with round-to-nearest
// intrinsics in the plain version's order (no FMA contraction), so the
// kernels pick the same taps as the plain versions. The caller scales the
// sum by t.z = 1/D.
__device__ __forceinline__ float fp_ray(const float* __restrict__ x,
                                        float4 t, int n, int nt, int ns,
                                        int j, int s) {
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float tdet =
      static_cast<float>(j) - 0.5f * static_cast<float>(nt - 1);
  const float base = __fmul_rn(tdet, t.x);
  const size_t plane = static_cast<size_t>(n) * ns;
  float acc = 0.f;
  if (t.w != 0.f) {  // row-driven: step over rows, taps along columns
    for (int k = 0; k < n; ++k) {
      const float coord = ctr - static_cast<float>(k);
      const float pos = __fadd_rn(__fadd_rn(base, __fmul_rn(coord, t.y)),
                                  ctr);
      const float f = floorf(pos);
      const float frac = pos - f;
      const int i0 = static_cast<int>(f);
      const float* row = x + k * plane + s;
      const float v0 = (i0 >= 0 && i0 < n) ? row[i0 * ns] : 0.f;
      const float v1 = (i0 + 1 >= 0 && i0 + 1 < n) ? row[(i0 + 1) * ns]
                                                   : 0.f;
      acc = fmaf(v1, frac, fmaf(v0, 1.f - frac, acc));
    }
  } else {  // column-driven: step over columns, taps along rows
    for (int k = 0; k < n; ++k) {
      const float coord = static_cast<float>(k) - ctr;
      const float pos = __fadd_rn(__fsub_rn(ctr, base),
                                  __fmul_rn(coord, t.y));
      const float f = floorf(pos);
      const float frac = pos - f;
      const int i0 = static_cast<int>(f);
      const float* col = x + static_cast<size_t>(k) * ns + s;
      const float v0 = (i0 >= 0 && i0 < n) ? col[i0 * plane] : 0.f;
      const float v1 = (i0 + 1 >= 0 && i0 + 1 < n) ? col[(i0 + 1) * plane]
                                                   : 0.f;
      acc = fmaf(v1, frac, fmaf(v0, 1.f - frac, acc));
    }
  }
  return acc;
}

// J* = x_c cos + y_r sin + (Nt-1)/2 of one angle at pixel (x_c, y_r), in
// round-to-nearest steps (no FMA contraction). t = {cos, sin, 1/D, -}. The
// computed J* is monotone in x_c (each step rounds a monotone function), so
// the taps of a run of columns lie between those of its two ends.
__device__ __forceinline__ float bp_jstar(float4 t, float xc, float yr,
                                          float off) {
  return __fadd_rn(__fadd_rn(__fmul_rn(t.x, xc), __fmul_rn(t.y, yr)), off);
}

// The two taps of one angle at pixel (x_c, y_r), as
// tomojax/projector/joseph.py:_bp_impl picks them: bins floor(J*) and
// floor(J*)+1 with weights hat((j - J*)/D)/D. K2 lets the compiler contract
// 1 - |j - J*| / D into one FMA; with RN every operation is rounded on its
// own, as the plain versions round them (K8's update, bp_angle).
struct BpTaps {
  int j0;
  float w0, w1;
};

template <bool RN = false>
__device__ __forceinline__ BpTaps bp_taps(float4 t, float xc, float yr,
                                          float off) {
  const float jstar = bp_jstar(t, xc, yr, off);
  const float f = floorf(jstar);
  if (RN) {
    return {static_cast<int>(f),
            fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(fabsf(f - jstar), t.z))) *
                t.z,
            fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(fabsf((f + 1.f) - jstar),
                                                t.z))) *
                t.z};
  }
  return {static_cast<int>(f),
          fmaxf(0.f, 1.f - fabsf(f - jstar) * t.z) * t.z,
          fmaxf(0.f, 1.f - fabsf((f + 1.f) - jstar) * t.z) * t.z};
}

// acc plus one angle's backprojection at pixel (x_c, y_r): a 2-point read
// of ya (the angle's (Nt, Ns) plane, offset to the caller's slice) at the
// taps of `bp_taps<true>`; out-of-range bins read 0. K8's update: where a
// pixel's one in-range tap nearly vanishes its weight is near 0, and
// inv_col_a (1 / the weight) magnifies any difference from the plain
// version's weight, so the weights are rounded as the plain version's.
__device__ __forceinline__ float bp_angle(const float* __restrict__ ya,
                                          float4 t, float xc, float yr,
                                          float off, int nt, int ns,
                                          float acc) {
  const BpTaps k = bp_taps<true>(t, xc, yr, off);
  const float v0 = (k.j0 >= 0 && k.j0 < nt) ? ya[k.j0 * ns] : 0.f;
  const float v1 = (k.j0 + 1 >= 0 && k.j0 + 1 < nt) ? ya[(k.j0 + 1) * ns]
                                                     : 0.f;
  return fmaf(v1, k.w1, fmaf(v0, k.w0, acc));
}

}  // namespace tj
