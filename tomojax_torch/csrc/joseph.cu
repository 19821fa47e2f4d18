// Joseph projector pair for Hopper: K1 (forward projection with the FISTA
// residual epilogue), K2 (matched backprojection with the SIRT-update
// epilogue) and K10 (K2's kernel with `ab` angles a stage).
// Slice-last layouts: volume x[r][c][s] (N, N, Ns), sinogram
// y[a][j][s] (Na, Nt, Ns).
//
// Weights: the Joseph closed form W[a,j,r,c] = hat((j - J*)/D_a)/D_a with
// J* = x_c cos_a + y_r sin_a + (Nt-1)/2 and D_a = max(|cos_a|, |sin_a|)
// (tomojax/projector/joseph.py). It holds at most two nonzero taps per
// (pixel, angle) and per (bin, step), so both operators are 2-point
// gathers with no scatter and no atomics.
//
// K1 and K2 are slab-resident: a block owns 32 slices of a tile of outputs,
// copies the part of its input that the tile's taps reach into a
// double-buffered ring in shared memory (cp.async, with zeros for bins,
// positions or slices outside the operand; staging.cuh), and gathers every
// tap from there as two 16-byte reads (4 slices) per tap pair. The tap
// positions and weights are computed once per 4 slices with the arithmetic
// of joseph.cuh, so both kernels pick the same taps and add them in the
// same order as their plain versions, K8 and the kernels they replace. The
// slab is the slowest grid axis, so the blocks in flight share one slab of
// their input in L2.
#include <climits>

#include "joseph.cuh"
#include "staging.cuh"

namespace {

using tj::FP_B;
using tj::FP_G;
using tj::FP_K;
using tj::FP_W;
using tj::SLAB;
using tj::copy_commit;
using tj::copy_slices;
using tj::copy_wait;
using tj::load4;
using tj::store4;

// acc + v0 w0 + v1 w1 per slice, in the order of tj::bp_angle and
// tj::fp_ray: fmaf(v1, w1, fmaf(v0, w0, acc)).
__device__ __forceinline__ float4 tap_pair(float4 acc, float4 v0, float w0,
                                           float4 v1, float w1) {
  acc.x = fmaf(v1.x, w1, fmaf(v0.x, w0, acc.x));
  acc.y = fmaf(v1.y, w1, fmaf(v0.y, w0, acc.y));
  acc.z = fmaf(v1.z, w1, fmaf(v0.z, w0, acc.z));
  acc.w = fmaf(v1.w, w1, fmaf(v0.w, w0, acc.w));
  return acc;
}

// K1 -- replaces tomojax/projector/pallas_joseph.py:_fp_resid_banded_kernel
// and _fp_resid_kernel (epilogue _fp_resid_epilogue), and with EPI false
// _fp_banded_kernel and _fp_kernel.
//
// Each ray (angle a, bin j, slice s) walks the driving axis in step order
// with tj::fp_ray's position rounding and sum order and is scaled by 1/D.
// tab[a] = {1/denom, shear, 1/|denom|, row_driven} from the host in f64
// rounded to f32, exactly as the plain version uses them.
//
// Bound on the H100: at 256^3 x 90 one launch reads 3.0e9 taps (12 GB). The
// design keeps them out of L2: a block owns up to FP_G angles of one
// driving type (one warp each) x FP_B bins x 32 slices, 8192 rays, 8 rays x
// 4 slices per thread (the 4 slices of a thread share one position). It
// walks the driving axis FP_K steps at a time; per chunk it stages, for each
// step, the union of its rays' taps (row-driven: a window of columns of
// that row; column-driven: a window of rows of that column) x 32 slices in
// a double-buffered ring. The host plan (cuda_joseph.fp_plan) groups
// consecutive angles of one type while every window fits FP_W positions,
// and gives each (group, bin tile, chunk) its window {lo, width}: from the
// rays' corner positions (pos is monotone in j and in the step), clamped to
// the volume plus two zero positions on each side. A tap at i0 is read at
// min(max(i0, lo), lo + width - 2); only taps whose two positions both lie
// outside the volume move, onto zeros. At 256^3 x 90 the plan has 13
// groups, windows of 42 positions on average (84 at most), and each staged
// byte serves about 10 tap reads: ~1.15 GB from L2 against 12 GB of
// shared-memory reads.
//
// Tiling, chosen on an H100 at 256^3 x 90 and 128 x 512^2 x 90 against
// variants built from this source: FP_K = 2 with 3 blocks an SM (80
// registers, no spills; ~44 KB of ring a block at 256^2) beat FP_K = 4
// with 2 blocks (126 registers for the epilogue) by 3-7 %, and FP_K = 8 (one
// block an SM) lost 20-40 %.
//
// Epilogue (EPI), in registers: ax = A x, the next FISTA residual
// resid = (b - (ax + beta (ax - ax_old))) * inv_row[a, j], and each warp's
// sum of (ax - b)^2 over its angle's 32 bins x 32 slices, reduced by
// shuffles in a fixed order into partials[(a, bin tile, slab)];
// tj::sum_partials then adds the partials in a fixed order (no float
// atomics: deterministic metrics). beta is read from device memory, so the
// host never waits for it.
constexpr int FP_NT = FP_G * 32;
constexpr int FP_RAYS = FP_B / 4;
constexpr int FP_PLAN_ROW = FP_G + 2;  // {row_driven, count, angles...}
// the ring fits the 48 KB a launch gets without opting in to more
static_assert(2 * FP_K * FP_W * SLAB * sizeof(float) <= 48 * 1024,
              "K1's ring needs cudaFuncAttributeMaxDynamicSharedMemorySize");

template <bool EPI>
__global__ void __launch_bounds__(FP_NT, 3)
fp_kernel(const float* __restrict__ x, const float4* __restrict__ tab,
          const int* __restrict__ plan, int ng, int wstride,
          const float* __restrict__ b, const float* __restrict__ ax_old,
          const float* __restrict__ inv_row, const float* __restrict__ beta,
          float* __restrict__ ax, float* __restrict__ resid,
          float* __restrict__ partials, int n, int nt, int ns, bool vec) {
  extern __shared__ float4 fp_ring4[];
  float* ring = reinterpret_cast<float*>(fp_ring4);  // [2][FP_K][wstride][32]
  const int stage_floats = FP_K * wstride * SLAB;
  const int nbt = (nt + FP_B - 1) / FP_B;
  const int nch = (n + FP_K - 1) / FP_K;
  const int g = blockIdx.x / nbt;
  const int tile = blockIdx.x - g * nbt;
  const int s0 = blockIdx.y * SLAB;
  const int* grp = plan + g * FP_PLAN_ROW;
  const bool row_driven = grp[0] != 0;
  const int2* win = reinterpret_cast<const int2*>(plan + ng * FP_PLAN_ROW) +
                    (static_cast<size_t>(g) * nbt + tile) * nch;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = lane & 7;  // slices s0 + 4q .. s0 + 4q + 3
  const bool active = (tid >> 5) < grp[1];
  const int a = active ? grp[2 + (tid >> 5)] : grp[2];
  const float4 t = tab[a];  // {inv_d, shear, scale, row_driven}
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const int j_first = tile * FP_B + (lane >> 3);  // bins j_first + 4i

  // The ray's constant part: base = t_j / denom (row-driven) or
  // ctr - base (column-driven), as tj::fp_ray orders the sums.
  float u[FP_RAYS];
#pragma unroll
  for (int i = 0; i < FP_RAYS; ++i) {
    const float tdet = static_cast<float>(j_first + 4 * i) -
                       0.5f * static_cast<float>(nt - 1);
    const float base = __fmul_rn(tdet, t.x);
    u[i] = row_driven ? base : __fsub_rn(ctr, base);
  }

  // x offsets of (step, position): row-driven x[step][pos], column-driven
  // x[pos][step]
  const size_t plane = static_cast<size_t>(n) * ns;
  const size_t step_stride = row_driven ? plane : static_cast<size_t>(ns);
  const size_t pos_stride = row_driven ? static_cast<size_t>(ns) : plane;
  const int shift = vec ? 3 : 5;  // 8 copies of 16 B or 32 of 4 B per row
  auto stage = [&](int c, float* buf) {
    const int2 w = win[c];  // {lo, width}
    const int steps = min(FP_K, n - c * FP_K);
    const int items = w.y << shift;
    for (int kk = 0; kk < steps; ++kk) {
      const size_t k = static_cast<size_t>(c) * FP_K + kk;
      for (int i = tid; i < items; i += FP_NT) {
        const int p = w.x + (i >> shift);
        const bool in = p >= 0 && p < n;
        copy_slices(buf + (kk * wstride + (i >> shift)) * SLAB,
                    x + k * step_stride + (in ? p : 0) * pos_stride, x, in,
                    s0, ns, i & ((1 << shift) - 1), vec);
      }
    }
    copy_commit();
  };

  float4 acc[FP_RAYS];
#pragma unroll
  for (int i = 0; i < FP_RAYS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  stage(0, ring);
  for (int c = 0; c < nch; ++c) {
    copy_wait();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if (c + 1 < nch) stage(c + 1, ring + ((c + 1) & 1) * stage_floats);
    if (!active) continue;
    const float* buf = ring + (c & 1) * stage_floats + 4 * q;
    const int2 w = win[c];
    const int last = w.y - 2;  // relative to lo
    const int steps = min(FP_K, n - c * FP_K);
    for (int kk = 0; kk < steps; ++kk) {
      const int k = c * FP_K + kk;
      const float coord = row_driven ? ctr - static_cast<float>(k)
                                     : static_cast<float>(k) - ctr;
      const float cs = __fmul_rn(coord, t.y);
      const float* sb = buf + kk * wstride * SLAB;
#pragma unroll
      for (int i = 0; i < FP_RAYS; ++i) {
        float pos = __fadd_rn(u[i], cs);
        if (row_driven) pos = __fadd_rn(pos, ctr);
        const float f = floorf(pos);
        const float frac = pos - f;
        const int i0 = min(max(static_cast<int>(f) - w.x, 0), last);
        const float4 v0 = *reinterpret_cast<const float4*>(sb + i0 * SLAB);
        const float4 v1 =
            *reinterpret_cast<const float4*>(sb + (i0 + 1) * SLAB);
        acc[i] = tap_pair(acc[i], v0, 1.f - frac, v1, frac);
      }
    }
  }
  if (!active) return;

  const int valid = ns - (s0 + 4 * q);
  const float bt = EPI ? beta[0] : 0.f;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < FP_RAYS; ++i) {
    const int j = j_first + 4 * i;
    if (j >= nt) continue;
    const size_t o = (static_cast<size_t>(a) * nt + j) * ns + s0 + 4 * q;
    const float4 axv = make_float4(acc[i].x * t.z, acc[i].y * t.z,
                                   acc[i].z * t.z, acc[i].w * t.z);
    store4(ax + o, axv, valid, vec);
    if (!EPI) continue;
    const float ir = inv_row[static_cast<size_t>(a) * nt + j];
    const float4 bv = load4(b + o, valid, vec);
    const float4 old = load4(ax_old + o, valid, vec);
    float4 rv;
    rv.x = (bv.x - (axv.x + bt * (axv.x - old.x))) * ir;
    rv.y = (bv.y - (axv.y + bt * (axv.y - old.y))) * ir;
    rv.z = (bv.z - (axv.z + bt * (axv.z - old.z))) * ir;
    rv.w = (bv.w - (axv.w + bt * (axv.w - old.w))) * ir;
    store4(resid + o, rv, valid, vec);
    // slices at or past ns hold ax = b = 0 and add nothing
    const float r0 = axv.x - bv.x, r1 = axv.y - bv.y;
    const float r2 = axv.z - bv.z, r3 = axv.w - bv.w;
    sq += r0 * r0;
    sq += r1 * r1;
    sq += r2 * r2;
    sq += r3 * r3;
  }
  if (!EPI) return;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, m);
  if (lane == 0) {
    partials[(static_cast<size_t>(a) * nbt + tile) * gridDim.y + blockIdx.y] =
        sq;
  }
}

// K2 -- replaces tomojax/projector/pallas_joseph.py:_bp_kernel (fused and
// unfused); it also covers _bp_banded_kernel, which computes the same
// operator with another TPU tiling. K10 -- replaces _bp_kernel_ab
// (bp_pallas_sl with ab > 1): the same kernel with `ab` angles a stage over
// the angle set padded to a multiple of ab (pallas_joseph.py:727-730).
//
// Each voxel (r, c, s) adds over the angles, in angle order, the 2-point
// gather of tj::bp_taps: acc = fmaf(v1, w1, fmaf(v0, w0, acc)), the chain of
// tj::bp_angle (K8's update, whose weights are rounded alone). With
// EPI (the FISTA/SIRT update) the result is
// z = max(y_vol + inv_col[r, c] * acc, 0); without, plain A^T y.
//
// Bound on the H100: at 256^3 x 90 one launch reads 3.0e9 taps (12 GB). A
// block owns a 16 x 16 tile of pixels x 32 slices; a thread 8 pixels of one
// column x 4 slices (32 accumulators). The block streams the angles
// `stage` at a time through a double-buffered ring: per angle it stages the
// BP_W bins from lo = floor(min J*) over the tile's four corners (J* is
// monotone in x_c and y_r, so every tap of the tile lies in
// [lo, lo + (TR-1)|sin| + (TC-1)|cos| + 3) and BP_W = 24 covers it) x 32
// slices, 3 KB, bins outside [0, Nt) as zeros, so the gather has no bounds
// tests. Each thread computes a pixel's taps once per angle and reads two
// float4 from shared memory. At 256^3 x 90: ~0.57 GB staged from L2 against
// 12 GB of shared-memory reads. Tiling, chosen on an H100 at 256^3 x 90 and
// 128 x 512^2 x 90: K2's BP_G = 8 angles a stage beat 4 and 16 by 1-3 %;
// forcing 4 blocks an SM (64 registers) spilled and lost 9 %. The window
// starts and the ring's stages come from staging.cuh (bp_windows,
// bp_stage), which E2 shares.
//
// K10 walks na_pad = Na rounded up to ab: a padded angle a >= Na stages zero
// rows and has the table entry {0, 0, 0, 0} (1/D = 0, as the reference's
// padded tables), so its taps add fmaf(0, 0, acc) = acc and K10 equals K2
// bit for bit at every ab. Its ring is 2 ab BP_W 32 floats: 37 KB at
// ab = 6, 192 KB at ab = 32 (one block an SM), beside 20 bytes an angle of
// tables and window starts.
using tj::BP_G;
using tj::BP_NT;
using tj::BP_PX;
using tj::BP_T;
using tj::BP_W;
using tj::bp_smem;
constexpr int AB_MAX = 32;                  // K10's largest stage

template <bool EPI>
__global__ void __launch_bounds__(BP_NT)
bp_kernel(const float* __restrict__ y, const float4* __restrict__ tab,
          const float* __restrict__ y_vol, const float* __restrict__ inv_col,
          float* __restrict__ out, int n, int nt, int na, int na_pad,
          int stage, int ns, bool vec) {
  extern __shared__ float4 bp_smem4[];
  float* ring = reinterpret_cast<float*>(bp_smem4);  // [2][stage][BP_W][32]
  const int half = stage * BP_W * SLAB;             // floats per buffer
  float4* stab = bp_smem4 + half / 2;               // na_pad table entries
  int* slo = reinterpret_cast<int*>(stab + na_pad);  // na_pad window starts
  const int tiles_c = (n + BP_T - 1) / BP_T;
  const int r0 = blockIdx.x / tiles_c * BP_T;
  const int c0 = (blockIdx.x % tiles_c) * BP_T;
  const int s0 = blockIdx.y * SLAB;
  const int tid = threadIdx.x;
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  tj::bp_windows(tab, na, na_pad, r0, c0, n, nt, stab, slo);
  __syncthreads();

  const int lane = tid & 31;
  const int q = lane & 7;                        // slices s0 + 4q ...
  const int slot = (tid >> 5) * 4 + (lane >> 3);  // 0 .. 31
  const int c = c0 + slot % BP_T;
  const int r_first = r0 + slot / BP_T;  // rows r_first + 2i
  const float xc = static_cast<float>(c) - ctr;
  float4 acc[BP_PX];
#pragma unroll
  for (int i = 0; i < BP_PX; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int ngroups = (na_pad + stage - 1) / stage;
  tj::bp_stage(ring, y, slo, 0, stage, na, nt, ns, s0, vec);
  for (int g = 0; g < ngroups; ++g) {
    copy_wait();
    __syncthreads();  // group g landed; every thread is done with g - 1
    if (g + 1 < ngroups) {
      tj::bp_stage(ring + ((g + 1) & 1) * half, y, slo, g + 1, stage, na, nt,
                   ns, s0, vec);
    }
    const float* buf = ring + (g & 1) * half + 4 * q;
    const int kn = min(stage, na_pad - g * stage);
    for (int k = 0; k < kn; ++k) {
      const int a = g * stage + k;
      const float4 t = stab[a];
      const float* win = buf + k * BP_W * SLAB;
      const int lo = slo[a];
#pragma unroll
      for (int i = 0; i < BP_PX; ++i) {
        const float yr = ctr - static_cast<float>(r_first + 2 * i);
        const tj::BpTaps tp = tj::bp_taps(t, xc, yr, off);
        const float* v = win + (tp.j0 - lo) * SLAB;
        const float4 v0 = *reinterpret_cast<const float4*>(v);
        const float4 v1 = *reinterpret_cast<const float4*>(v + SLAB);
        acc[i] = tap_pair(acc[i], v0, tp.w0, v1, tp.w1);
      }
    }
  }

  if (c >= n) return;
  const int valid = ns - (s0 + 4 * q);
#pragma unroll
  for (int i = 0; i < BP_PX; ++i) {
    const int r = r_first + 2 * i;
    if (r >= n) break;
    const size_t o = (static_cast<size_t>(r) * n + c) * ns + s0 + 4 * q;
    float4 z = acc[i];
    if (EPI) {
      const float ic = inv_col[static_cast<size_t>(r) * n + c];
      const float4 yv = load4(y_vol + o, valid, vec);
      z.x = fmaxf(yv.x + ic * acc[i].x, 0.f);
      z.y = fmaxf(yv.y + ic * acc[i].y, 0.f);
      z.z = fmaxf(yv.z + ic * acc[i].z, 0.f);
      z.w = fmaxf(yv.w + ic * acc[i].w, 0.f);
    }
    store4(out + o, z, valid, vec);
  }
}

bool fp_shape_ok(int n, int nt, int na, int ns, int ng, int width) {
  return n > 0 && nt > 0 && na > 0 && ns > 0 && ng > 0 && ng <= na &&
         width >= 2 && width <= FP_W && (ns + SLAB - 1) / SLAB <= 65535 &&
         static_cast<long long>(ng) * ((nt + FP_B - 1) / FP_B) <= INT_MAX;
}

template <bool EPI>
int fp_launch(const float* x, const float* tab, const int* plan, int ng,
              int width, const float* b, const float* ax_old,
              const float* inv_row, const float* beta, float* ax,
              float* resid, float* partials, int n, int nt, int ns,
              cudaStream_t st) {
  const bool vec = ns % 4 == 0 && tj::aligned16(x) && tj::aligned16(ax) &&
                   tj::aligned16(b) && tj::aligned16(ax_old) &&
                   tj::aligned16(resid);
  const dim3 grid(ng * ((nt + FP_B - 1) / FP_B), (ns + SLAB - 1) / SLAB);
  const size_t smem = 2 * FP_K * static_cast<size_t>(width) * SLAB *
                      sizeof(float);
  fp_kernel<EPI><<<grid, FP_NT, smem, st>>>(
      x, reinterpret_cast<const float4*>(tab), plan, ng, width, b, ax_old,
      inv_row, beta, ax, resid, partials, n, nt, ns, vec);
  return tj::launch_error();
}

template <bool EPI>
int bp_launch_as(const float* y, const float4* tab, const float* y_vol,
                 const float* inv_col, float* out, int n, int nt, int na,
                 int ns, int stage, int na_pad, int limit, cudaStream_t st) {
  static bool opted = false;  // once per instantiation, to the card's limit
  const int err = tj::allow_smem(bp_kernel<EPI>, limit, &opted);
  if (err != 0) return err;
  const int tiles = (n + BP_T - 1) / BP_T;
  const dim3 grid(tiles * tiles, (ns + SLAB - 1) / SLAB);
  const bool vec = ns % 4 == 0 && tj::aligned16(y) && tj::aligned16(y_vol) &&
                   tj::aligned16(out);
  bp_kernel<EPI><<<grid, BP_NT, bp_smem(stage, na_pad), st>>>(
      y, tab, y_vol, inv_col, out, n, nt, na, na_pad, stage, ns, vec);
  return tj::launch_error();
}

// K2 (stage BP_G, na_pad = na) and K10 (stage ab, na_pad = na rounded up
// to ab).
int bp_launch(const float* y, const float* tab, const float* y_vol,
              const float* inv_col, float* out, int n, int nt, int na,
              int ns, int stage, int na_pad, cudaStream_t st) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || na_pad < na ||
      n > 65535 || (ns + SLAB - 1) / SLAB > 65535 ||
      (y_vol == nullptr) != (inv_col == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int limit = tj::smem_limit();
  if (limit < 0 || bp_smem(stage, na_pad) > static_cast<size_t>(limit)) {
    return cudaErrorInvalidValue;
  }
  const auto* t4 = reinterpret_cast<const float4*>(tab);
  if (y_vol != nullptr) {
    return bp_launch_as<true>(y, t4, y_vol, inv_col, out, n, nt, na, ns,
                              stage, na_pad, limit, st);
  }
  return bp_launch_as<false>(y, t4, nullptr, nullptr, out, n, nt, na, ns,
                             stage, na_pad, limit, st);
}

}  // namespace

TJ_API const char* tj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// plan: cuda_joseph.fp_plan's table on the device (ng groups, then the
// windows); width: its widest window, the ring's row stride.
TJ_API int tj_fp(const float* x, const float* tab, const int* plan, int ng,
                 int width, float* ax, int n, int nt, int na, int ns,
                 void* stream) {
  if (!fp_shape_ok(n, nt, na, ns, ng, width)) return cudaErrorInvalidValue;
  return fp_launch<false>(x, tab, plan, ng, width, nullptr, nullptr, nullptr,
                          nullptr, ax, nullptr, nullptr, n, nt, ns,
                          static_cast<cudaStream_t>(stream));
}

// One partial per (angle, bin tile of FP_B, slab of 32 slices).
TJ_API int tj_fp_resid_partials(int nt, int na, int ns) {
  return na * ((nt + FP_B - 1) / FP_B) * ((ns + SLAB - 1) / SLAB);
}

// partials: tj_fp_resid_partials(nt, na, ns) floats of scratch; ddsq: 1
// float, the fixed-order sum of the partials (||A x - b||^2).
TJ_API int tj_fp_resid(const float* x, const float* tab, const int* plan,
                       int ng, int width, const float* b,
                       const float* ax_old, const float* inv_row,
                       const float* beta, float* ax, float* resid,
                       float* partials, float* ddsq, int n, int nt, int na,
                       int ns, void* stream) {
  if (!fp_shape_ok(n, nt, na, ns, ng, width)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int err = fp_launch<true>(x, tab, plan, ng, width, b, ax_old, inv_row,
                                  beta, ax, resid, partials, n, nt, ns, st);
  if (err != 0) return err;
  return static_cast<int>(tj::sum_partials(
      partials, ddsq, tj_fp_resid_partials(nt, na, ns), st));
}

// y_vol and inv_col both null: plain A^T y; both set: the SIRT epilogue.
TJ_API int tj_bp(const float* y, const float* tab, const float* y_vol,
                 const float* inv_col, float* out, int n, int nt, int na,
                 int ns, void* stream) {
  return bp_launch(y, tab, y_vol, inv_col, out, n, nt, na, ns, BP_G, na,
                   static_cast<cudaStream_t>(stream));
}

// K10: K2's kernel with ab angles a stage (1 <= ab <= AB_MAX) over the angle
// set padded to a multiple of ab; tab holds the na real angles. Refused
// where the block's shared memory (bp_smem) exceeds the card's limit.
TJ_API int tj_bp_ab(const float* y, const float* tab, const float* y_vol,
                    const float* inv_col, float* out, int n, int nt, int na,
                    int ns, int ab, void* stream) {
  if (ab < 1 || ab > AB_MAX || na <= 0) return cudaErrorInvalidValue;
  return bp_launch(y, tab, y_vol, inv_col, out, n, nt, na, ns, ab,
                   (na + ab - 1) / ab * ab,
                   static_cast<cudaStream_t>(stream));
}

// The most dynamic shared memory one block may have on the current card
// (bytes), or -1.
TJ_API int tj_smem_limit() { return tj::smem_limit(); }
