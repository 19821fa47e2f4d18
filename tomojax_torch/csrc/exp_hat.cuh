// Weight forms and tap walks shared by the experiment kernels E1-E4
// (exp_projector.cu, exp_sart.cu), the counterparts of the TPU kernels of
// scripts/exp_*.py. Slice-last layouts as joseph.cuh: volume x[r][c][s]
// (N, N, Ns), sinogram plane y[j][s] (Nt, Ns).
//
// The TPU kernels build the dense Joseph matrix W[j, (r, c)] = hat((j -
// J*)/D)/D of one angle from the closed form and contract it on the MXU.
// On Hopper an output walks only its nonzero taps: an FP ray (bin j) takes
// at each driving step the two pixels around the position K1 computes
// (tj::fp_ray), a BP voxel the two bins around J* (tj::bp_taps), and each
// tap's weight comes from its distance d = j - J*(pixel) (tj::bp_jstar), so
// the FULL form is the TPU's hat FP and BP tap for tap. Every product and
// sum is rounded on its own (round-to-nearest intrinsics, no FMA
// contraction) in the order the plain versions use
// (experiments/cuda_projector_variants.py, cuda_sart_variants.py), so the
// kernels equal them bit for bit.
#pragma once

#include "joseph.cuh"

namespace tj {
namespace xp {

// Projector weight forms (E1, E2; values shared with the Python wrappers).
//   FULL  max(0, 1 - |d| invd) invd            the TPU's production chain
//   HAT5  max(0, min(1 - u, 1 + u)), u = d invd; x invd after the sum (FP)
//   BF16  max(0, 1 - |bf16(u)|) rounded to bf16; x invd after the sum (FP),
//         on the sinogram before the product (BP)
//   NOHAT the constant invd / 2 on the same taps (every load kept)
//   NODOT the FULL weights summed, no volume or sinogram read
//   W4    max(0, invd - |j invd^2 - invd^2 J*|)
enum Form { FULL = 0, HAT5 = 1, BF16 = 2, NOHAT = 3, NODOT = 4, W4 = 5 };

// SART modes (E3, E4). Weights are the unscaled hat w = max(0, min(1 - u,
// 1 + u)); the FP sum is scaled by invd in the residual and the update by
// beta invd, as the TPU sweeps defer the 1/D.
//   TAPS_F32   taps and weights computed, f32 operands
//   TAPS_BF16  taps computed, w, x (FP) and the residual (update) in bf16
//   TABLE_BF16 taps and bf16 weights read from tables built per geometry
//   NOHAT      the constant weight 0.01 on the same taps
//   NOFP       no FP walk: the residual is b inv_row
//   NOUPD      the FP walks, x is left unchanged
enum Mode {
  TAPS_F32 = 0, TAPS_BF16 = 1, TABLE_BF16 = 2, S_NOHAT = 3, NOFP = 4,
  NOUPD = 5
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Weight of a tap at bin jf (as a float) with J* = jstar, for one angle of
// 1/D = invd (inv2 = invd^2, read by W4 only).
template <int FORM>
__device__ __forceinline__ float weight(float jf, float jstar, float invd,
                                        float inv2) {
  if (FORM == NOHAT) return __fmul_rn(invd, 0.5f);
  if (FORM == W4) {
    return fmaxf(0.f, __fsub_rn(invd, fabsf(__fsub_rn(
                                          __fmul_rn(jf, inv2),
                                          __fmul_rn(inv2, jstar)))));
  }
  const float d = __fsub_rn(jf, jstar);
  if (FORM == HAT5) {
    const float u = __fmul_rn(d, invd);
    return fmaxf(0.f, fminf(__fsub_rn(1.f, u), __fadd_rn(1.f, u)));
  }
  if (FORM == BF16) {
    const float ub = bf16_round(__fmul_rn(d, invd));
    return fmaxf(0.f, bf16_round(__fsub_rn(1.f, fabsf(ub))));
  }
  return __fmul_rn(fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(fabsf(d), invd))),
                   invd);
}

// The FP walk of bin j over the driving steps k of one angle, templated on
// the driving axis as tj::fp_ray branches on it, outside the loop. ROW: a
// row-driven angle, taps along the columns of row k; else taps along the
// rows of column k.
//
// Position of bin j's ray at step k as K1 computes it (its first tap is
// floor(pos)); ft = {1/denom, shear, 1/|denom|, row_driven}, base = (j -
// (Nt-1)/2) ft.x.
template <bool ROW>
__device__ __forceinline__ float fp_pos(float4 ft, float base, float ctr,
                                        float fk) {
  return ROW ? __fadd_rn(__fadd_rn(base, __fmul_rn(ctr - fk, ft.y)), ctr)
             : __fadd_rn(__fsub_rn(ctr, base), __fmul_rn(fk - ctr, ft.y));
}

// J* of tap fi at step fk: pixel (row k, column i) or (row i, column k).
template <bool ROW>
__device__ __forceinline__ float tap_jstar(float4 bt, float ctr, float off,
                                           float fk, float fi) {
  return ROW ? bp_jstar(bt, fi - ctr, ctr - fk, off)
             : bp_jstar(bt, fk - ctr, ctr - fi, off);
}

// x at tap i of step k, 0 outside the image; xs is x offset to the
// caller's slice, plane = N Ns.
template <bool ROW>
__device__ __forceinline__ float tap_load(const float* xs, int n, int ns,
                                          size_t plane, int k, int i) {
  if (i < 0 || i >= n) return 0.f;
  return ROW ? xs[k * plane + i * ns] : xs[i * plane + k * ns];
}

// SART FP sum of bin j at one angle: sum over the driving steps of
// w0 x(tap0) + w1 x(tap1) in the mode's weights (unscaled), out-of-range
// taps reading 0; xs is x offset to the slice. ti/tw are the angle's bin-j
// rows of the FP tables (TABLE_BF16 only): first tap index and (w0, w1) per
// step.
template <int MODE, bool ROW>
__device__ __forceinline__ float sart_fp_walk(const float* xs, float4 ft,
                                              float4 bt, const int* ti,
                                              const __nv_bfloat162* tw,
                                              int n, int nt, int ns, int j) {
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const float jf = static_cast<float>(j);
  const float base = __fmul_rn(jf - off, ft.x);
  const size_t plane = static_cast<size_t>(n) * ns;
  float acc = 0.f;
#pragma unroll 4  // the loads of 4 steps issue before their serial sums
  for (int k = 0; k < n; ++k) {
    const float fk = static_cast<float>(k);
    int i0;
    float w0, w1;
    if (MODE == TABLE_BF16) {
      i0 = ti[k];
      const float2 w = __bfloat1622float2(tw[k]);
      w0 = w.x;
      w1 = w.y;
    } else {
      const float f = floorf(fp_pos<ROW>(ft, base, ctr, fk));
      i0 = static_cast<int>(f);
      if (MODE == S_NOHAT) {
        w0 = w1 = 0.01f;
      } else {
        w0 = weight<HAT5>(jf, tap_jstar<ROW>(bt, ctr, off, fk, f), bt.z,
                          0.f);
        w1 = weight<HAT5>(jf, tap_jstar<ROW>(bt, ctr, off, fk,
                                             __fadd_rn(f, 1.f)),
                          bt.z, 0.f);
        if (MODE == TAPS_BF16) {
          w0 = bf16_round(w0);
          w1 = bf16_round(w1);
        }
      }
    }
    float v0 = tap_load<ROW>(xs, n, ns, plane, k, i0);
    float v1 = tap_load<ROW>(xs, n, ns, plane, k, i0 + 1);
    if (MODE == TAPS_BF16 || MODE == TABLE_BF16) {
      v0 = bf16_round(v0);
      v1 = bf16_round(v1);
    }
    acc = __fadd_rn(acc, __fmul_rn(w0, v0));
    acc = __fadd_rn(acc, __fmul_rn(w1, v1));
  }
  return acc;
}

// The SART FP sum of bin j, slice s at one angle (0 for NOFP).
template <int MODE>
__device__ __forceinline__ float sart_fp_ray(const float* x, float4 ft,
                                             float4 bt, const int* ti,
                                             const __nv_bfloat162* tw, int n,
                                             int nt, int ns, int j, int s) {
  if (MODE == NOFP) return 0.f;
  return ft.w != 0.f
             ? sart_fp_walk<MODE, true>(x + s, ft, bt, ti, tw, n, nt, ns, j)
             : sart_fp_walk<MODE, false>(x + s, ft, bt, ti, tw, n, nt, ns, j);
}

// SART residual of one ray from its FP sum: (b - invd acc) inv_row, rounded
// to bf16 in the bf16 modes (the operand of the update's product).
template <int MODE>
__device__ __forceinline__ float sart_resid(float b, float acc, float invd,
                                            float inv_row) {
  const float r = __fmul_rn(__fsub_rn(b, __fmul_rn(invd, acc)), inv_row);
  return (MODE == TAPS_BF16 || MODE == TABLE_BF16) ? bf16_round(r) : r;
}

// SART update sum of pixel (x_c, y_r) at one angle: w0 res[j0] + w1
// res[j0+1] over the residual rows res[j * rs] (out-of-range bins read 0),
// in the mode's weights; tj/tw the pixel's entries of the BP tables
// (TABLE_BF16 only).
template <int MODE>
__device__ __forceinline__ float sart_bp_voxel(const float* res, int rs,
                                               float4 bt, const int* tjp,
                                               const __nv_bfloat162* tw,
                                               float xc, float yr, float off,
                                               int nt) {
  int j0;
  float w0, w1;
  if (MODE == TABLE_BF16) {
    j0 = *tjp;
    const float2 w = __bfloat1622float2(*tw);
    w0 = w.x;
    w1 = w.y;
  } else {
    const float jstar = bp_jstar(bt, xc, yr, off);
    const float f = floorf(jstar);
    j0 = static_cast<int>(f);
    if (MODE == S_NOHAT) {
      w0 = w1 = 0.01f;
    } else {
      w0 = weight<HAT5>(f, jstar, bt.z, 0.f);
      w1 = weight<HAT5>(__fadd_rn(f, 1.f), jstar, bt.z, 0.f);
      if (MODE == TAPS_BF16) {
        w0 = bf16_round(w0);
        w1 = bf16_round(w1);
      }
    }
  }
  const float r0 = (j0 >= 0 && j0 < nt) ? res[j0 * rs] : 0.f;
  const float r1 = (j0 + 1 >= 0 && j0 + 1 < nt) ? res[(j0 + 1) * rs] : 0.f;
  return __fadd_rn(__fmul_rn(w0, r0), __fmul_rn(w1, r1));
}

}  // namespace xp
}  // namespace tj
