// Joseph projector pair for Hopper: K1 (forward projection with the FISTA
// residual epilogue), K2 (matched backprojection with the SIRT-update
// epilogue) and K10 (K2's operator with the angles staged in groups).
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
// positions or slices outside the operand), and gathers every tap from
// there as two 16-byte reads (4 slices) per tap pair. The tap positions and
// weights are computed once per 4 slices with the arithmetic of joseph.cuh,
// so both kernels pick the same taps and add them in the same order as
// their plain versions, K8 and the kernels they replace. The slab is the
// slowest grid axis, so the blocks in flight share one slab of their input
// in L2.
#include <climits>

#include "joseph.cuh"

namespace {

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from src into shared dst, or zeros when !ok (src is then
// not read; `safe` is any valid address).
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       const float* safe, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(ok ? src : safe), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* safe, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(ok ? src : safe), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 32 slices [s0, s0 + 32) of the row at `src` (its slice 0) into shared
// dst[0, 32), zeros beyond ns or when !ok: part p of 8 (vec, 16 bytes; ns %
// 4 == 0 and 16-byte aligned rows) or of 32 (4 bytes, any ns).
__device__ __forceinline__ void copy_slices(float* dst, const float* src,
                                            const float* safe, bool ok,
                                            int s0, int ns, int p, bool vec) {
  if (vec) {
    const int s = s0 + 4 * p;
    copy16(dst + 4 * p, src + s, safe, ok && s < ns);
  } else {
    const int s = s0 + p;
    copy4(dst + p, src + s, safe, ok && s < ns);
  }
}

// 4 slices starting at p, of which `valid` (<= 0: none) lie below ns.
__device__ __forceinline__ float4 load4(const float* p, int valid, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (valid > 0) v = *reinterpret_cast<const float4*>(p);
  } else {
    if (valid > 0) v.x = p[0];
    if (valid > 1) v.y = p[1];
    if (valid > 2) v.z = p[2];
    if (valid > 3) v.w = p[3];
  }
  return v;
}

__device__ __forceinline__ void store4(float* p, float4 v, int valid,
                                       bool vec) {
  if (vec) {
    if (valid > 0) *reinterpret_cast<float4*>(p) = v;
  } else {
    if (valid > 0) p[0] = v.x;
    if (valid > 1) p[1] = v.y;
    if (valid > 2) p[2] = v.z;
    if (valid > 3) p[3] = v.w;
  }
}

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

constexpr int SLAB = 32;  // slices per block of K1 and K2

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
constexpr int FP_G = 8;   // angles per block, one warp each
constexpr int FP_B = 32;  // bins per block; a thread owns 8 of them
constexpr int FP_K = 2;   // driving steps per staged chunk
constexpr int FP_W = 96;  // widest staged window (cuda_joseph.FP_WINDOW)
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
// operator with another TPU tiling. The angle-blocked _bp_kernel_ab is K10
// below.
//
// Each voxel (r, c, s) adds over the angles, in angle order, the 2-point
// gather of tj::bp_taps: acc = fmaf(v1, w1, fmaf(v0, w0, acc)), the chain of
// tj::bp_angle (so K10 and K8's update, which share it, agree with K2). With
// EPI (the FISTA/SIRT update) the result is
// z = max(y_vol + inv_col[r, c] * acc, 0); without, plain A^T y.
//
// Bound on the H100: at 256^3 x 90 one launch reads 3.0e9 taps (12 GB). A
// block owns a 16 x 16 tile of pixels x 32 slices; a thread 8 pixels of one
// column x 4 slices (32 accumulators). The block streams the angles
// BP_G at a time through a double-buffered ring: per angle it stages the
// BP_W bins from lo = floor(min J*) over the tile's four corners (J* is
// monotone in x_c and y_r, so every tap of the tile lies in
// [lo, lo + (TR-1)|sin| + (TC-1)|cos| + 3) and BP_W = 24 covers it) x 32
// slices, 3 KB, bins outside [0, Nt) as zeros, so the gather has no bounds
// tests. Each thread computes a pixel's taps once per angle and reads two
// float4 from shared memory. At 256^3 x 90: ~0.57 GB staged from L2 against
// 12 GB of shared-memory reads. Tiling, chosen on an H100 at 256^3 x 90 and
// 128 x 512^2 x 90: BP_G = 8 angles a stage beat 4 and 16 by 1-3 %; forcing
// 4 blocks an SM (64 registers) spilled and lost 9 %.
constexpr int BP_T = 16;                    // tile side, rows and columns
constexpr int BP_NT = 256;                  // threads per block
constexpr int BP_PX = BP_T * BP_T / 32;     // pixels per thread (8)
constexpr int BP_G = 8;                     // angles per stage
constexpr int BP_W = 24;                    // staged bins per angle
constexpr int BP_RING = 2 * BP_G * BP_W * SLAB;  // floats
constexpr int BP_MAX_ANGLES = 3072;

template <bool EPI>
__global__ void __launch_bounds__(BP_NT)
bp_kernel(const float* __restrict__ y, const float4* __restrict__ tab,
          const float* __restrict__ y_vol, const float* __restrict__ inv_col,
          float* __restrict__ out, int n, int nt, int na, int ns, bool vec) {
  extern __shared__ float4 bp_smem4[];
  float* ring = reinterpret_cast<float*>(bp_smem4);  // [2][BP_G][BP_W][32]
  float4* stab = bp_smem4 + BP_RING / 4;             // na table entries
  int* slo = reinterpret_cast<int*>(stab + na);      // na window starts
  const int tiles_c = (n + BP_T - 1) / BP_T;
  const int r0 = blockIdx.x / tiles_c * BP_T;
  const int c0 = (blockIdx.x % tiles_c) * BP_T;
  const int s0 = blockIdx.y * SLAB;
  const int tid = threadIdx.x;
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  {
    // window starts from the tile's corners (cuda_joseph.bp_window_lo)
    const float xa = static_cast<float>(c0) - ctr;
    const float xb = static_cast<float>(c0 + BP_T - 1) - ctr;
    const float ya = ctr - static_cast<float>(r0);
    const float yb = ctr - static_cast<float>(r0 + BP_T - 1);
    for (int a = tid; a < na; a += BP_NT) {
      const float4 t = tab[a];
      stab[a] = t;
      const float lo = fminf(
          fminf(tj::bp_jstar(t, xa, ya, off), tj::bp_jstar(t, xb, ya, off)),
          fminf(tj::bp_jstar(t, xa, yb, off), tj::bp_jstar(t, xb, yb, off)));
      slo[a] = static_cast<int>(floorf(lo));
    }
  }
  __syncthreads();

  const int shift = vec ? 3 : 5;  // 8 copies of 16 B or 32 of 4 B per row
  auto stage = [&](int g, float* buf) {
    for (int i = tid; i < (BP_G * BP_W) << shift; i += BP_NT) {
      const int row = i >> shift;  // k * BP_W + bin offset
      const int k = row / BP_W;
      const int a = g * BP_G + k;
      const int j = (a < na ? slo[a] : 0) + row - k * BP_W;
      const bool in = a < na && j >= 0 && j < nt;
      copy_slices(buf + row * SLAB,
                  y + (in ? (static_cast<size_t>(a) * nt + j) * ns : 0), y,
                  in, s0, ns, i & ((1 << shift) - 1), vec);
    }
    copy_commit();
  };

  const int lane = tid & 31;
  const int q = lane & 7;                        // slices s0 + 4q ...
  const int slot = (tid >> 5) * 4 + (lane >> 3);  // 0 .. 31
  const int c = c0 + slot % BP_T;
  const int r_first = r0 + slot / BP_T;  // rows r_first + 2i
  const float xc = static_cast<float>(c) - ctr;
  float4 acc[BP_PX];
#pragma unroll
  for (int i = 0; i < BP_PX; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int ngroups = (na + BP_G - 1) / BP_G;
  stage(0, ring);
  for (int g = 0; g < ngroups; ++g) {
    copy_wait();
    __syncthreads();  // group g landed; every thread is done with g - 1
    if (g + 1 < ngroups) stage(g + 1, ring + ((g + 1) & 1) * (BP_RING / 2));
    const float* buf = ring + (g & 1) * (BP_RING / 2) + 4 * q;
    const int kn = min(BP_G, na - g * BP_G);
    for (int k = 0; k < kn; ++k) {
      const int a = g * BP_G + k;
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

// K10's block: 32 slices x 8 columns of one row
constexpr int BP_BS = 32;
constexpr int BP_BC = 8;

// K10 -- replaces tomojax/projector/pallas_joseph.py:_bp_kernel_ab
// (bp_pallas_sl with ab > 1): K2's operator and epilogue with the angles
// taken `ab` at a time, over the angle set padded to a multiple of ab
// (pallas_joseph.py:727-730). A padded angle has a zero sinogram row and a
// zero table entry {0, 0, 0, 0} (1/D = 0, as the reference's padded tables),
// so its taps add exactly 0.
//
// On the TPU `ab` was the number of angles per sequential grid step. Here
// it is the number of angles whose sinogram rows a block stages in shared
// memory before it gathers from them: the block's 8 columns of one row fall
// within BP_BC + 2 bins of each other at any angle (J* is monotone in the
// column with slope |cos| <= 1), so per angle it loads that window of bins
// for its 32 slices (coalesced, out-of-range bins as 0) and every thread
// then reads its two taps from shared memory. Each thread adds the angles
// in K2's order with K2's tap arithmetic (tj::bp_taps), so K10 equals K2 bit
// for bit.
//
// Bound on the H100: as K2, the tap gathers (3.0e9 at 256^3 x 90); staging
// turns the block's L1 sinogram reads into shared-memory reads, at the cost
// of two barriers per angle group.
constexpr int AB_W = BP_BC + 2;  // staged bins per angle
constexpr int AB_MAX = 32;       // largest ab

template <bool EPI>
__global__ void __launch_bounds__(BP_BS * BP_BC)
bp_ab_kernel(const float* __restrict__ y, const float4* __restrict__ tab,
             const float* __restrict__ y_vol,
             const float* __restrict__ inv_col, float* __restrict__ out,
             int n, int nt, int na, int na_pad, int ab, int ns) {
  extern __shared__ float4 stab[];  // na_pad table entries, then the rows
  float* rows = reinterpret_cast<float*>(stab + na_pad);  // [ab][AB_W][BS]
  __shared__ int lo[AB_MAX];  // first staged bin of each angle of the group
  constexpr int NT = BP_BS * BP_BC;
  const int tid = threadIdx.y * BP_BS + threadIdx.x;
  for (int i = tid; i < na_pad; i += NT) {
    stab[i] = i < na ? tab[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int s0 = blockIdx.x * BP_BS;
  const int c0 = blockIdx.y * BP_BC;
  const int r = blockIdx.z;
  const int s = s0 + threadIdx.x;
  const int c = c0 + threadIdx.y;
  const bool valid = s < ns && c < n;
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float yr = ctr - static_cast<float>(r);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const float xc = static_cast<float>(c) - ctr;
  const float xc_first = static_cast<float>(c0) - ctr;
  const float xc_last = static_cast<float>(min(c0 + BP_BC - 1, n - 1)) - ctr;
  const int per_angle = AB_W * BP_BS;
  __syncthreads();

  float acc = 0.f;
  for (int g = 0; g < na_pad; g += ab) {
    if (tid < ab) {
      const float4 t = stab[g + tid];
      lo[tid] = min(tj::bp_taps(t, xc_first, yr, off).j0,
                    tj::bp_taps(t, xc_last, yr, off).j0);
    }
    __syncthreads();
    for (int i = tid; i < ab * per_angle; i += NT) {
      const int k = i / per_angle;
      const int jj = (i - k * per_angle) / BP_BS;
      const int sl = i - k * per_angle - jj * BP_BS;
      const int a = g + k;
      const int j = lo[k] + jj;
      rows[i] = (a < na && j >= 0 && j < nt && s0 + sl < ns)
                    ? y[(static_cast<size_t>(a) * nt + j) * ns + s0 + sl]
                    : 0.f;
    }
    __syncthreads();
    if (valid) {
      for (int k = 0; k < ab; ++k) {
        const tj::BpTaps tp = tj::bp_taps(stab[g + k], xc, yr, off);
        const float* win =
            rows + k * per_angle + (tp.j0 - lo[k]) * BP_BS + threadIdx.x;
        acc = fmaf(win[BP_BS], tp.w1, fmaf(win[0], tp.w0, acc));
      }
    }
    __syncthreads();  // the next group overwrites lo and rows
  }
  if (!valid) return;
  const size_t o = (static_cast<size_t>(r) * n + c) * ns + s;
  if (EPI) {
    out[o] = fmaxf(y_vol[o] + inv_col[static_cast<size_t>(r) * n + c] * acc,
                   0.f);
  } else {
    out[o] = acc;
  }
}

bool fp_shape_ok(int n, int nt, int na, int ns, int ng, int width) {
  return n > 0 && nt > 0 && na > 0 && ns > 0 && ng > 0 && ng <= na &&
         width >= 2 && width <= FP_W && (ns + SLAB - 1) / SLAB <= 65535 &&
         static_cast<long long>(ng) * ((nt + FP_B - 1) / FP_B) <= INT_MAX;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0;
}

// The dynamic shared memory a launch may ask for above 48 KB, allowed once
// per kernel instantiation; returns the launch error of the attribute call.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  *done = err == cudaSuccess;
  return static_cast<int>(err);
}

constexpr size_t BP_SMEM_MAX =
    BP_RING * sizeof(float) + BP_MAX_ANGLES * (sizeof(float4) + sizeof(int));

template <bool EPI>
int fp_launch(const float* x, const float* tab, const int* plan, int ng,
              int width, const float* b, const float* ax_old,
              const float* inv_row, const float* beta, float* ax,
              float* resid, float* partials, int n, int nt, int ns,
              cudaStream_t st) {
  const bool vec = ns % 4 == 0 && aligned16(x) && aligned16(ax) &&
                   aligned16(b) && aligned16(ax_old) && aligned16(resid);
  const dim3 grid(ng * ((nt + FP_B - 1) / FP_B), (ns + SLAB - 1) / SLAB);
  const size_t smem = 2 * FP_K * static_cast<size_t>(width) * SLAB *
                      sizeof(float);
  fp_kernel<EPI><<<grid, FP_NT, smem, st>>>(
      x, reinterpret_cast<const float4*>(tab), plan, ng, width, b, ax_old,
      inv_row, beta, ax, resid, partials, n, nt, ns, vec);
  return tj::launch_error();
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
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || na > BP_MAX_ANGLES ||
      n > 65535 || (ns + SLAB - 1) / SLAB > 65535 ||
      (y_vol == nullptr) != (inv_col == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (n + BP_T - 1) / BP_T;
  const dim3 grid(tiles * tiles, (ns + SLAB - 1) / SLAB);
  const size_t smem = BP_RING * sizeof(float) +
                      static_cast<size_t>(na) * (sizeof(float4) + sizeof(int));
  const bool vec = ns % 4 == 0 && aligned16(y) && aligned16(y_vol) &&
                   aligned16(out);
  const auto* t4 = reinterpret_cast<const float4*>(tab);
  auto st = static_cast<cudaStream_t>(stream);
  static bool smem_ok[2] = {false, false};
  if (y_vol != nullptr) {
    const int err = allow_smem(bp_kernel<true>, BP_SMEM_MAX, &smem_ok[1]);
    if (err != 0) return err;
    bp_kernel<true><<<grid, BP_NT, smem, st>>>(y, t4, y_vol, inv_col, out, n,
                                               nt, na, ns, vec);
  } else {
    const int err = allow_smem(bp_kernel<false>, BP_SMEM_MAX, &smem_ok[0]);
    if (err != 0) return err;
    bp_kernel<false><<<grid, BP_NT, smem, st>>>(y, t4, nullptr, nullptr, out,
                                                n, nt, na, ns, vec);
  }
  return tj::launch_error();
}

// K10: tj_bp with the angles taken ab at a time (1 <= ab <= 32) over the
// angle set padded to a multiple of ab; tab holds the na real angles.
TJ_API int tj_bp_ab(const float* y, const float* tab, const float* y_vol,
                    const float* inv_col, float* out, int n, int nt, int na,
                    int ns, int ab, void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || ab < 1 || ab > AB_MAX ||
      n > 65535 || (n + BP_BC - 1) / BP_BC > 65535 ||
      (y_vol == nullptr) != (inv_col == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int na_pad = (na + ab - 1) / ab * ab;
  const size_t smem = static_cast<size_t>(na_pad) * sizeof(float4) +
                      static_cast<size_t>(ab) * AB_W * BP_BS * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((ns + BP_BS - 1) / BP_BS, (n + BP_BC - 1) / BP_BC, n);
  const auto* t4 = reinterpret_cast<const float4*>(tab);
  auto st = static_cast<cudaStream_t>(stream);
  if (y_vol != nullptr) {
    bp_ab_kernel<true><<<grid, dim3(BP_BS, BP_BC), smem, st>>>(
        y, t4, y_vol, inv_col, out, n, nt, na, na_pad, ab, ns);
  } else {
    bp_ab_kernel<false><<<grid, dim3(BP_BS, BP_BC), smem, st>>>(
        y, t4, nullptr, nullptr, out, n, nt, na, na_pad, ab, ns);
  }
  return tj::launch_error();
}
