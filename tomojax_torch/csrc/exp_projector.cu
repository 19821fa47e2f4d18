// Experiment projectors E1 (forward) and E2 (back), the counterparts of
// the TPU kernels of scripts/exp_hat_model.py, exp_projector_variants.py,
// exp_projector_variants2.py and exp_pair_fp.py. E1 is K1's slab-resident
// design (joseph.cu fp_kernel, on K1's host plan) and E2 K2's (joseph.cu
// bp_kernel, on the staging of staging.cuh), each with the weight forms of
// exp_hat.cuh, so a script's variant is a template instantiation of one
// kernel and not a TPU tiling: band windows, MXU tiles and VMEM blocks do
// not carry over.
//
// Bound on the H100: at 256^3 x 90 a launch reads 3.0e9 taps. The forms
// change only the arithmetic per tap, so FULL against NOHAT (the same loads
// and shared reads, no hat) and NODOT (the hat, nothing staged or read)
// splits a projector's time into tap arithmetic and loads.
#include <climits>

#include "exp_hat.cuh"
#include "staging.cuh"

namespace {

using namespace tj::xp;
using tj::BP_G;
using tj::BP_NT;
using tj::BP_PX;
using tj::BP_T;
using tj::BP_W;
using tj::FP_B;
using tj::FP_K;
using tj::FP_W;
using tj::SLAB;

// E1 -- replaces scripts/exp_hat_model.py:_fp_banded_kernel (FULL, HAT5,
// BF16, NOHAT, NODOT), exp_projector_variants.py:_fp_kernel (FULL, W4; its
// a_blk caps the angles a block takes) and exp_pair_fp.py's paired
// production _fp_banded_kernel (PAIR).
//
// K1's blocks: a group of up to `cap` angles of one driving type from the
// host plan (cuda_joseph.fp_plan(geom, group=cap), the TPU's a_blk) x FP_B
// bins x 32 slices, one warp per angle, a thread 8 rays x 4 slices. It
// walks the driving axis FP_K steps a chunk and stages, per step, the
// chunk's window {lo, width} x 32 slices in a double-buffered ring with
// cp.async (zeros outside the volume). Per tap pair a thread computes the
// position, J* of both taps (tap_jstar) and their weights once for its 4
// slices and reads two float4 from shared memory. The weights come from the
// true tap f = floor(pos); only the shared-memory index is clamped to
// [lo, lo + width - 2], which moves pairs that lie wholly outside the
// volume onto staged zeros. Every product and sum is rounded on its own and
// added in step order, so E1 equals fp_variant_ref bit for bit.
//
// NODOT stages nothing and reads neither shared nor global memory beyond
// the plan and the angle tables: its walk is the hat arithmetic alone.
// NOHAT keeps every staged copy and shared read.
//
// PAIR: for a series with theta[na-1-i] = -theta[i], J*(-theta, row r) =
// J*(theta, row N-1-r), so the ray of -theta is the ray of +theta through
// the row-flipped volume with the same taps and weights. The plan covers
// the angles Na/2 .. Na-1 (a0 = Na/2); per step the block also stages the
// mirrored window (row-driven: row N-1-k of the same columns; column-driven:
// rows N-1-i of column k, so that index i0 - lo addresses row N-1-i0), and
// one weight computation feeds both rays; it writes angle a and angle
// Na-1-a.
constexpr int E1_RAYS = FP_B / 4;  // rays per thread: bins j_first + 4i

__device__ __forceinline__ float4 add_pair(float4 acc, float w0, float4 v0,
                                           float w1, float4 v1) {
  acc.x = __fadd_rn(__fadd_rn(acc.x, __fmul_rn(w0, v0.x)),
                    __fmul_rn(w1, v1.x));
  acc.y = __fadd_rn(__fadd_rn(acc.y, __fmul_rn(w0, v0.y)),
                    __fmul_rn(w1, v1.y));
  acc.z = __fadd_rn(__fadd_rn(acc.z, __fmul_rn(w0, v0.z)),
                    __fmul_rn(w1, v1.z));
  acc.w = __fadd_rn(__fadd_rn(acc.w, __fmul_rn(w0, v0.w)),
                    __fmul_rn(w1, v1.w));
  return acc;
}

// What a block walks: x, its windows (two ints {lo, width} per chunk), the
// ring and the shape.
struct E1Block {
  const float* x;
  const int* win;
  float* ring;
  int wstride, n, nt, ns, s0;
  bool vec;
};

// The walk of one block over the driving axis, ROW the group's driving
// type; acc (and accm, PAIR) per ray and slice, or for NODOT the scalar sum
// per ray in acc[i].x.
template <int FORM, bool PAIR, bool ROW>
__device__ __forceinline__ void e1_walk(const E1Block& b, float4 ft,
                                        float4 bt, bool active, int j_first,
                                        float4 (&acc)[E1_RAYS],
                                        float4 (&accm)[E1_RAYS]) {
  const int n = b.n;
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(b.nt - 1);
  const float invd = bt.z, inv2 = __fmul_rn(bt.z, bt.z);
  // the ray's constant part, as fp_pos orders the sums: base = (j -
  // (Nt-1)/2) ft.x (row-driven) or ctr - base (column-driven)
  float u[E1_RAYS];
#pragma unroll
  for (int i = 0; i < E1_RAYS; ++i) {
    const float base = __fmul_rn(
        static_cast<float>(j_first + 4 * i) - off, ft.x);
    u[i] = ROW ? base : __fsub_rn(ctr, base);
  }
  // the taps (first tap f, weights w0, w1) of ray i at step k
  auto taps = [&](int i, float fk, float cs, float& f, float& w0,
                  float& w1) {
    float pos = __fadd_rn(u[i], cs);
    if (ROW) pos = __fadd_rn(pos, ctr);
    f = floorf(pos);
    const float jf = static_cast<float>(j_first + 4 * i);
    w0 = weight<FORM>(
        jf, FORM == NOHAT ? 0.f : tap_jstar<ROW>(bt, ctr, off, fk, f), invd,
        inv2);
    w1 = weight<FORM>(jf,
                      FORM == NOHAT ? 0.f
                                    : tap_jstar<ROW>(bt, ctr, off, fk,
                                                     __fadd_rn(f, 1.f)),
                      invd, inv2);
  };

  if (FORM == NODOT) {
    if (!active) return;
    for (int k = 0; k < n; ++k) {
      const float fk = static_cast<float>(k);
      const float cs = __fmul_rn(ROW ? ctr - fk : fk - ctr, ft.y);
#pragma unroll
      for (int i = 0; i < E1_RAYS; ++i) {
        float f, w0, w1;
        taps(i, fk, cs, f, w0, w1);
        acc[i].x = __fadd_rn(__fadd_rn(acc[i].x, w0), w1);
      }
    }
    return;
  }

  constexpr int COPIES = PAIR ? 2 : 1;  // the window, then its mirror
  const int row_floats = b.wstride * SLAB;
  const int stage_floats = FP_K * COPIES * row_floats;
  const int nch = (n + FP_K - 1) / FP_K;
  const size_t plane = static_cast<size_t>(n) * b.ns;
  // x offsets of (step, position): row-driven x[step][pos], column-driven
  // x[pos][step]
  const size_t step_stride = ROW ? plane : static_cast<size_t>(b.ns);
  const size_t pos_stride = ROW ? static_cast<size_t>(b.ns) : plane;
  const int shift = b.vec ? 3 : 5;  // 8 copies of 16 B or 32 of 4 B per row
  const int tid = threadIdx.x;
  auto stage = [&](int c, float* buf) {
    const int lo = b.win[2 * c], items = b.win[2 * c + 1] << shift;
    const int steps = min(FP_K, n - c * FP_K);
    for (int kk = 0; kk < steps; ++kk) {
      const int k = c * FP_K + kk;
      for (int i = tid; i < items; i += blockDim.x) {
        const int p = lo + (i >> shift);
        const bool in = p >= 0 && p < n;
        const int pc = in ? p : 0;
        float* dst = buf + kk * COPIES * row_floats + (i >> shift) * SLAB;
        const int part = i & ((1 << shift) - 1);
        tj::copy_slices(dst, b.x + k * step_stride + pc * pos_stride, b.x,
                        in, b.s0, b.ns, part, b.vec);
        if (PAIR) {
          const size_t m = ROW ? (n - 1 - k) * step_stride + pc * pos_stride
                               : k * step_stride + (n - 1 - pc) * pos_stride;
          tj::copy_slices(dst + row_floats, b.x + m, b.x, in, b.s0, b.ns,
                          part, b.vec);
        }
      }
    }
    tj::copy_commit();
  };

  const int q = threadIdx.x & 7;  // slices s0 + 4q .. s0 + 4q + 3
  stage(0, b.ring);
  for (int c = 0; c < nch; ++c) {
    tj::copy_wait();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if (c + 1 < nch) stage(c + 1, b.ring + ((c + 1) & 1) * stage_floats);
    if (!active) continue;
    const float* buf = b.ring + (c & 1) * stage_floats + 4 * q;
    const int lo = b.win[2 * c], last = b.win[2 * c + 1] - 2;
    const int steps = min(FP_K, n - c * FP_K);
    for (int kk = 0; kk < steps; ++kk) {
      const float fk = static_cast<float>(c * FP_K + kk);
      const float cs = __fmul_rn(ROW ? ctr - fk : fk - ctr, ft.y);
      const float* sb = buf + kk * COPIES * row_floats;
#pragma unroll
      for (int i = 0; i < E1_RAYS; ++i) {
        float f, w0, w1;
        taps(i, fk, cs, f, w0, w1);
        const int i0 = min(max(static_cast<int>(f) - lo, 0), last);
        const float* v = sb + i0 * SLAB;
        acc[i] = add_pair(acc[i], w0, *reinterpret_cast<const float4*>(v),
                          w1, *reinterpret_cast<const float4*>(v + SLAB));
        if (PAIR) {
          const float* m = v + row_floats;
          accm[i] = add_pair(accm[i], w0,
                             *reinterpret_cast<const float4*>(m), w1,
                             *reinterpret_cast<const float4*>(m + SLAB));
        }
      }
    }
  }
}

// plan: cuda_joseph.fp_plan's table (ng rows of cap + 2 ints, then the
// windows); a0: the first angle of the plan's angle set (Na/2 for PAIR).
// blockDim.x = 32 x the plan's largest group, at most MAXT.
template <int FORM, bool PAIR, int MAXT>
__global__ void __launch_bounds__(MAXT)
fp_variant_kernel(const float* __restrict__ x,
                  const float4* __restrict__ ftab,
                  const float4* __restrict__ btab,
                  const int* __restrict__ plan, int ng, int wstride, int cap,
                  int a0, float* __restrict__ out, int n, int nt, int na,
                  int ns, bool vec) {
  extern __shared__ float4 e1_ring4[];
  const int nbt = (nt + FP_B - 1) / FP_B;
  const int nch = (n + FP_K - 1) / FP_K;
  const int g = blockIdx.x / nbt;
  const int tile = blockIdx.x - g * nbt;
  const int* grp = plan + g * (cap + 2);  // {row_driven, count, angles...}
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool active = warp < grp[1];
  const int a = a0 + grp[2 + (active ? warp : 0)];
  const float4 ft = ftab[a], bt = btab[a];
  const int j_first = tile * FP_B + (lane >> 3);
  const E1Block blk{
      x,
      plan + ng * (cap + 2) + 2 * (static_cast<size_t>(g) * nbt + tile) * nch,
      reinterpret_cast<float*>(e1_ring4), wstride, n, nt, ns,
      static_cast<int>(blockIdx.y) * SLAB, vec};
  float4 acc[E1_RAYS], accm[E1_RAYS];
#pragma unroll
  for (int i = 0; i < E1_RAYS; ++i) {
    acc[i] = accm[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (grp[0] != 0) {
    e1_walk<FORM, PAIR, true>(blk, ft, bt, active, j_first, acc, accm);
  } else {
    e1_walk<FORM, PAIR, false>(blk, ft, bt, active, j_first, acc, accm);
  }
  if (!active) return;

  const int s = blk.s0 + 4 * (lane & 7);
  const int valid = ns - s;
#pragma unroll
  for (int i = 0; i < E1_RAYS; ++i) {
    const int j = j_first + 4 * i;
    if (j >= nt) continue;
    float4 v = acc[i];
    if (FORM == NODOT) v = make_float4(v.x, v.x, v.x, v.x);
    if (FORM == HAT5 || FORM == BF16) {
      v = make_float4(__fmul_rn(v.x, bt.z), __fmul_rn(v.y, bt.z),
                      __fmul_rn(v.z, bt.z), __fmul_rn(v.w, bt.z));
    }
    tj::store4(out + (static_cast<size_t>(a) * nt + j) * ns + s, v, valid,
               vec);
    if (PAIR) {
      tj::store4(out + (static_cast<size_t>(na - 1 - a) * nt + j) * ns + s,
                 accm[i], valid, vec);
    }
  }
}

// E2 -- replaces scripts/exp_hat_model.py:_bp_kernel (FULL, BF16, NOHAT,
// NODOT) and _bp_banded_kernel_v (the same operator with a TPU band; no
// banded split on Hopper, as K2), exp_projector_variants.py:_bp_kernel
// (FULL, W4) and exp_projector_variants2.py:_bp2_kernel (FULL with APS 2).
//
// K2's blocks and staging (joseph.cu bp_kernel; staging.cuh bp_windows and
// bp_stage): a 16 x 16 tile of pixels x 32 slices, a thread 8 pixels of one
// column x 4 slices; the angles streamed BP_G a stage through the
// double-buffered ring of BP_W bins from each (tile, angle)'s window start
// x 32 slices, zeros for bins outside [0, Nt). Per pixel and angle a thread
// computes J*, the taps j0 = floor(J*), j0 + 1 and weight<FORM>(j, J*) of
// both once for its 4 slices and reads two float4 from the ring (BF16: each
// value times invd first, in f32). Every product and sum is rounded on its
// own and the angles are added in order, so E2 equals bp_variant_ref bit
// for bit: a bin outside [0, Nt) reads a staged 0, as the plain version's.
// APS = 2 takes two angles of a stage per step and issues their four shared
// reads before the first product; the products are still added in angle
// order, so APS does not change the result. NOHAT keeps every stage and
// shared read; NODOT stages nothing and reads only the angle tables.
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

// The two staged taps of bin j0 (its window at win, starting at bin lo),
// times invd for BF16.
template <int FORM>
__device__ __forceinline__ void bp_reads(const float* win, int lo, int j0,
                                         float invd, float4& v0, float4& v1) {
  const float* v = win + (j0 - lo) * SLAB;
  v0 = *reinterpret_cast<const float4*>(v);
  v1 = *reinterpret_cast<const float4*>(v + SLAB);
  if (FORM == BF16) {
    v0 = make_float4(__fmul_rn(v0.x, invd), __fmul_rn(v0.y, invd),
                     __fmul_rn(v0.z, invd), __fmul_rn(v0.w, invd));
    v1 = make_float4(__fmul_rn(v1.x, invd), __fmul_rn(v1.y, invd),
                     __fmul_rn(v1.z, invd), __fmul_rn(v1.w, invd));
  }
}

template <int FORM, int APS>
__global__ void __launch_bounds__(BP_NT)
bp_variant_kernel(const float* __restrict__ y, const float4* __restrict__ tab,
                  float* __restrict__ out, int n, int nt, int na, int ns,
                  bool vec) {
  extern __shared__ float4 e2_smem4[];
  const int tiles_c = (n + BP_T - 1) / BP_T;
  const int r0 = blockIdx.x / tiles_c * BP_T;
  const int c0 = (blockIdx.x % tiles_c) * BP_T;
  const int s0 = blockIdx.y * SLAB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = lane & 7;                        // slices s0 + 4q ...
  const int slot = (tid >> 5) * 4 + (lane >> 3);  // 0 .. 31
  const int c = c0 + slot % BP_T;
  const int r_first = r0 + slot / BP_T;  // rows r_first + 2i
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const float xc = static_cast<float>(c) - ctr;
  float4 acc[BP_PX];
#pragma unroll
  for (int i = 0; i < BP_PX; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (FORM == NODOT) {  // the weights alone: acc + w0 + w1 per pixel
    for (int a = 0; a < na; ++a) {
      const float4 t = tab[a];
#pragma unroll
      for (int i = 0; i < BP_PX; ++i) {
        int j0;
        float w0, w1;
        bp_taps_of<FORM>(t, xc, ctr - static_cast<float>(r_first + 2 * i),
                         off, j0, w0, w1);
        acc[i].x = __fadd_rn(__fadd_rn(acc[i].x, w0), w1);
      }
    }
  } else {
    float* ring = reinterpret_cast<float*>(e2_smem4);  // [2][BP_G][BP_W][32]
    const int half = BP_G * BP_W * SLAB;               // floats per buffer
    float4* stab = e2_smem4 + half / 2;                // na table entries
    int* slo = reinterpret_cast<int*>(stab + na);      // na window starts
    tj::bp_windows(tab, na, na, r0, c0, n, nt, stab, slo);
    __syncthreads();
    const int ngroups = (na + BP_G - 1) / BP_G;
    tj::bp_stage(ring, y, slo, 0, BP_G, na, nt, ns, s0, vec);
    for (int g = 0; g < ngroups; ++g) {
      tj::copy_wait();
      __syncthreads();  // group g landed; every thread is done with g - 1
      if (g + 1 < ngroups) {
        tj::bp_stage(ring + ((g + 1) & 1) * half, y, slo, g + 1, BP_G, na,
                     nt, ns, s0, vec);
      }
      const float* buf = ring + (g & 1) * half + 4 * q;
      const int kn = min(BP_G, na - g * BP_G);
      int k = 0;
      if (APS == 2) {
        for (; k + 1 < kn; k += 2) {
          const int a = g * BP_G + k;
          const float4 t0 = stab[a], t1 = stab[a + 1];
          const float* win0 = buf + k * BP_W * SLAB;
          const float* win1 = win0 + BP_W * SLAB;
          const int lo0 = slo[a], lo1 = slo[a + 1];
#pragma unroll
          for (int i = 0; i < BP_PX; ++i) {
            const float yr = ctr - static_cast<float>(r_first + 2 * i);
            int j0, j1;
            float w00, w01, w10, w11;
            bp_taps_of<FORM>(t0, xc, yr, off, j0, w00, w01);
            bp_taps_of<FORM>(t1, xc, yr, off, j1, w10, w11);
            float4 v00, v01, v10, v11;
            bp_reads<FORM>(win0, lo0, j0, t0.z, v00, v01);
            bp_reads<FORM>(win1, lo1, j1, t1.z, v10, v11);
            acc[i] = add_pair(acc[i], w00, v00, w01, v01);
            acc[i] = add_pair(acc[i], w10, v10, w11, v11);
          }
        }
      }
      for (; k < kn; ++k) {
        const int a = g * BP_G + k;
        const float4 t = stab[a];
        const float* win = buf + k * BP_W * SLAB;
        const int lo = slo[a];
#pragma unroll
        for (int i = 0; i < BP_PX; ++i) {
          int j0;
          float w0, w1;
          bp_taps_of<FORM>(t, xc, ctr - static_cast<float>(r_first + 2 * i),
                           off, j0, w0, w1);
          float4 v0, v1;
          bp_reads<FORM>(win, lo, j0, t.z, v0, v1);
          acc[i] = add_pair(acc[i], w0, v0, w1, v1);
        }
      }
    }
  }

  if (c >= n) return;
  const int valid = ns - (s0 + 4 * q);
#pragma unroll
  for (int i = 0; i < BP_PX; ++i) {
    const int r = r_first + 2 * i;
    if (r >= n) break;
    float4 v = acc[i];
    if (FORM == NODOT) v = make_float4(v.x, v.x, v.x, v.x);
    tj::store4(out + (static_cast<size_t>(r) * n + c) * ns + s0 + 4 * q, v,
               valid, vec);
  }
}

// E1's launch: x, the tables, the plan (fp_plan's table, ng groups of at
// most cap angles, windows at most width wide), warps = the largest group.
struct FpLaunch {
  const float* x;
  const float4* ft;
  const float4* bt;
  const int* plan;
  float* out;
  int ng, width, cap, warps, a0, n, nt, na, ns;
  cudaStream_t st;
};

template <int FORM, bool PAIR, int MAXT>
int launch_fp_as(const FpLaunch& g) {
  const int limit = tj::smem_limit();
  static bool opted = false;  // once per instantiation, to the card's limit
  const int err = tj::allow_smem(fp_variant_kernel<FORM, PAIR, MAXT>, limit,
                                 &opted);
  if (err != 0) return err;
  const size_t smem = FORM == NODOT ? 0
                                    : (PAIR ? 2 : 1) * 2 * FP_K *
                                          static_cast<size_t>(g.width) *
                                          SLAB * sizeof(float);
  if (limit < 0 || smem > static_cast<size_t>(limit)) {
    return cudaErrorInvalidValue;
  }
  const bool vec = g.ns % 4 == 0 && tj::aligned16(g.x) &&
                   tj::aligned16(g.out);
  const dim3 grid(g.ng * ((g.nt + FP_B - 1) / FP_B), (g.ns + SLAB - 1) / SLAB);
  fp_variant_kernel<FORM, PAIR, MAXT><<<grid, 32 * g.warps, smem, g.st>>>(
      g.x, g.ft, g.bt, g.plan, g.ng, g.width, g.cap, g.a0, g.out, g.n, g.nt,
      g.na, g.ns, vec);
  return tj::launch_error();
}

// one instantiation per block size: 8, 16 or 32 warps at most
template <int FORM, bool PAIR>
int launch_fp(const FpLaunch& g) {
  if (g.warps <= 8) return launch_fp_as<FORM, PAIR, 256>(g);
  if (g.warps <= 16) return launch_fp_as<FORM, PAIR, 512>(g);
  return launch_fp_as<FORM, PAIR, 1024>(g);
}

struct Launch {
  const float* in;  // y
  const float4* bt;
  float* out;
  int n, nt, na, ns;
  cudaStream_t st;
};

template <int FORM, int APS>
int launch_bp(const Launch& g) {
  const int limit = tj::smem_limit();
  static bool opted = false;  // once per instantiation, to the card's limit
  const int err = tj::allow_smem(bp_variant_kernel<FORM, APS>, limit, &opted);
  if (err != 0) return err;
  const size_t smem = FORM == NODOT ? 0 : tj::bp_smem(BP_G, g.na);
  if (limit < 0 || smem > static_cast<size_t>(limit)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (g.n + BP_T - 1) / BP_T;
  const dim3 grid(tiles * tiles, (g.ns + SLAB - 1) / SLAB);
  const bool vec = g.ns % 4 == 0 && tj::aligned16(g.in) &&
                   tj::aligned16(g.out);
  bp_variant_kernel<FORM, APS><<<grid, BP_NT, smem, g.st>>>(
      g.in, g.bt, g.out, g.n, g.nt, g.na, g.ns, vec);
  return tj::launch_error();
}

}  // namespace

// E1: out (Na, Nt, Ns) from x (N, N, Ns); form a Form, pair 0/1 (PAIR with
// FULL only; Na even, the caller checks the symmetry). plan: fp_plan's
// table on the device for the whole angle set (pair 0) or for the angles
// Na/2 .. Na-1 (pair 1, member indices from 0), ng groups of at most cap
// angles (1 <= cap <= 32), windows at most width wide; warps: its largest
// group.
TJ_API int tj_exp_fp(int form, int pair, const float* x, const float* fp_tab,
                     const float* bp_tab, const int* plan, int ng, int width,
                     int cap, int warps, float* out, int n, int nt, int na,
                     int ns, void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || ng <= 0 || cap < 1 ||
      cap > 32 || warps < 1 || warps > cap || width < 2 || width > FP_W ||
      (ns + SLAB - 1) / SLAB > 65535 ||
      static_cast<long long>(ng) * ((nt + FP_B - 1) / FP_B) > INT_MAX ||
      (pair && (form != FULL || na % 2 != 0))) {
    return cudaErrorInvalidValue;
  }
  const FpLaunch g{x, reinterpret_cast<const float4*>(fp_tab),
                   reinterpret_cast<const float4*>(bp_tab), plan, out, ng,
                   width, cap, warps, pair ? na / 2 : 0, n, nt, na, ns,
                   static_cast<cudaStream_t>(stream)};
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
// 1 or 2 (2 with FULL only). Refused where the ring and the tables of na
// angles (tj::bp_smem) exceed the card's shared memory a block.
TJ_API int tj_exp_bp(int form, int aps, const float* y, const float* bp_tab,
                     float* out, int n, int nt, int na, int ns,
                     void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || n > 65535 ||
      (ns + SLAB - 1) / SLAB > 65535 || (aps != 1 && aps != 2) ||
      (aps == 2 && form != FULL)) {
    return cudaErrorInvalidValue;
  }
  const Launch g{y, reinterpret_cast<const float4*>(bp_tab), out, n, nt, na,
                 ns, static_cast<cudaStream_t>(stream)};
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
