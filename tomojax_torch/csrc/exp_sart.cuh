// The experiment SART modes (exp_hat.cuh Mode) as a tap policy of the
// cluster-resident sweep (sart_resident.cuh), shared by E3 (exp_sart.cu)
// and E4 (exp_sart_shapes.cu).
//
// Per tap the arithmetic of the streaming E3 kernels, unchanged: the
// unscaled hat w of each tap from its J* (sart_fp_walk, sart_bp_voxel), or
// the constant 0.01 (NOHAT), or the taps and bf16 weights of the tables
// (TABLE_BF16); w, the FP's x and the residual rounded to bf16 in the bf16
// modes; every product and sum rounded on its own. A ray's sum runs in the
// resident order: per band and phase over the band's steps, phase 0 +
// phase 1, then the bands in rank order (sart_variant_ref with bands = the
// cluster's blocks repeats it). NOFP drops the FP walk and the partials'
// exchange (the residual b inv_row), NOUPD the update.
#pragma once

#include "exp_hat.cuh"
#include "sart_resident.cuh"

namespace tj {
namespace xp {

struct Tables {  // TABLE_BF16 operands (null otherwise)
  const int* fp_i0;               // (Na, Nt, N) first tap of each step
  const __nv_bfloat162* fp_w;     // (Na, Nt, N) its two weights
  const int* bp_j0;               // (Na, N, N) first bin of each pixel
  const __nv_bfloat162* bp_w;     // (Na, N, N) its two weights
};

template <int MODE>
struct SartTaps {
  using Params = Tables;
  static constexpr bool FP = MODE != NOFP;
  static constexpr bool UPDATE = MODE != NOUPD;
  static constexpr bool BF16_OPS = MODE == TAPS_BF16 || MODE == TABLE_BF16;

  // One ray's walk at one angle: bin j; its table rows (TABLE_BF16).
  struct Ray {
    float4 bt;
    float jf, ctr, off;
    const int* ti;
    const __nv_bfloat162* tw;

    __device__ __forceinline__ Ray(const Tables& tb, const float4* btab,
                                   int a, int j, int n, int nt)
        : bt(btab[a]),
          jf(static_cast<float>(j)),
          ctr(0.5f * static_cast<float>(n - 1)),
          off(0.5f * static_cast<float>(nt - 1)),
          ti(MODE == TABLE_BF16
                 ? tb.fp_i0 + (static_cast<size_t>(a) * nt + j) * n
                 : nullptr),
          tw(MODE == TABLE_BF16
                 ? tb.fp_w + (static_cast<size_t>(a) * nt + j) * n
                 : nullptr) {}

    // the taps of step k at position pos, as sart_fp_walk picks them
    template <bool ROW>
    __device__ __forceinline__ sr::Tap tap(int k, float pos) const {
      if constexpr (MODE == TABLE_BF16) {
        const float2 w = __bfloat1622float2(tw[k]);
        return {ti[k], w.x, w.y};
      } else {
        const float f = floorf(pos);
        if constexpr (MODE == S_NOHAT) {
          return {static_cast<int>(f), 0.01f, 0.01f};
        } else {
          const float fk = static_cast<float>(k);
          float w0 = weight<HAT5>(jf, tap_jstar<ROW>(bt, ctr, off, fk, f),
                                  bt.z, 0.f);
          float w1 = weight<HAT5>(
              jf, tap_jstar<ROW>(bt, ctr, off, fk, __fadd_rn(f, 1.f)), bt.z,
              0.f);
          if constexpr (MODE == TAPS_BF16) {
            w0 = bf16_round(w0);
            w1 = bf16_round(w1);
          }
          return {static_cast<int>(f), w0, w1};
        }
      }
    }

    // (acc + w0 v0) + w1 v1 per slice, x rounded to bf16 in the bf16 modes
    template <int SB>
    __device__ __forceinline__ void add(sr::Vec<SB>& acc, sr::Vec<SB> v0,
                                        sr::Vec<SB> v1,
                                        const sr::Tap& t) const {
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        float x0 = sr::lanes<SB>(v0)[i], x1 = sr::lanes<SB>(v1)[i];
        if constexpr (BF16_OPS) {
          x0 = bf16_round(x0);
          x1 = bf16_round(x1);
        }
        float& a = sr::lanes<SB>(acc)[i];
        a = __fadd_rn(a, __fmul_rn(t.w0, x0));
        a = __fadd_rn(a, __fmul_rn(t.w1, x1));
      }
    }
  };

  static __device__ __forceinline__ float resid(float s, float b, float ir,
                                                float4, float4 bt) {
    return sart_resid<MODE>(b, s, bt.z, ir);
  }

  // pixel (r, c)'s two bins and weights, as sart_bp_voxel picks them
  static __device__ __forceinline__ BpTaps bp(const Tables& tb, float4 bt,
                                              int a, int r, int c, float xc,
                                              float yr, float off, int n) {
    if constexpr (MODE == TABLE_BF16) {
      const size_t pix = (static_cast<size_t>(a) * n + r) * n + c;
      const float2 w = __bfloat1622float2(tb.bp_w[pix]);
      return {tb.bp_j0[pix], w.x, w.y};
    } else {
      const float jstar = bp_jstar(bt, xc, yr, off);
      const float f = floorf(jstar);
      if constexpr (MODE == S_NOHAT) {
        return {static_cast<int>(f), 0.01f, 0.01f};
      } else {
        float w0 = weight<HAT5>(f, jstar, bt.z, 0.f);
        float w1 = weight<HAT5>(__fadd_rn(f, 1.f), jstar, bt.z, 0.f);
        if constexpr (MODE == TAPS_BF16) {
          w0 = bf16_round(w0);
          w1 = bf16_round(w1);
        }
        return {static_cast<int>(f), w0, w1};
      }
    }
  }

  static __device__ __forceinline__ float upd(float r0, float r1,
                                              const BpTaps& t) {
    return __fadd_rn(__fmul_rn(t.w0, r0), __fmul_rn(t.w1, r1));
  }

  static __device__ __forceinline__ float scale(float beta, float4 bt,
                                                float icol) {
    return __fmul_rn(__fmul_rn(beta, bt.z), icol);
  }
};

// The operands of one sweep (tj_exp_sart_sweep's, tj_exp_sart_resident's).
struct SweepArgs {
  const float* x;
  const float4* ft;
  const float4* bt;
  const float* b;
  const float* inv_row;
  const float* inv_col_a;
  const float* beta;
  const int* order;
  int steps;
  Tables tb;
  float* out;
  int n, nt, na, ns;
  cudaStream_t st;
};

// E3's resident route (8 blocks, 4 slices, K8's shape) in `mode`, its PROF
// instantiation when prof is not null; defined in exp_sart.cu, called by
// E4 (exp_sart_shapes.cu) for that shape.
int e3_resident(int mode, const SweepArgs& g, long long* prof);
// *clusters: cudaOccupancyMaxActiveClusters of E3's resident route in
// `mode` at this shape; defined in exp_sart.cu.
int e3_active_clusters(int mode, int n, int nt, int ns, int* clusters);

}  // namespace xp
}  // namespace tj
