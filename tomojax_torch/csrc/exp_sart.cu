// Experiment SART sweeps E3 (two launches per angle, as K8) and E4 (one
// launch per sweep), the counterparts of the TPU kernels of
// scripts/exp_sart_pipeline.py and exp_sart_ablate.py. One ordered SART
// step at angle a = order[k] (exp_hat.cuh for the modes and weights):
//   acc   = sum over the taps of w x                        (FP walk)
//   resid = (b_a - invd acc) inv_row[a]                      (Nt, Ns)
//   x     = max(x + (beta invd) inv_col_a[a] sum_taps w resid, 0)
// with the unscaled hat w of the TPU sweeps (the 1/D deferred into the two
// scalars), slice-last x (N, N, Ns), b (Na, Nt, Ns). order and beta are
// read on the device.
//
// The TPU variants only restructure this step for Mosaic (double-buffered
// W, W kept in VMEM per angle, W streamed from HBM, the volume resident in
// VMEM, the chunk loop as a grid axis); on Hopper each is one of the modes
// below, and the W tensor becomes two tables of taps and bf16 weights (8
// bytes per tap pair, built once per geometry by
// experiments/cuda_sart_variants.py:sart_tables).
//
// Bound on the H100: E3 as K8, device memory (each angle's FP reads the
// volume and its update reads and writes it, ~17 GB per sweep at 256^3 x
// 90 when nothing stays in the 50 MB L2). E4 reads each block's slab from
// L2 instead, but a volume of Ns slices gives only Ns / sb blocks: with
// 256 slices and sb = 4, 64 blocks for 132 SMs.
#include "exp_hat.cuh"

namespace {

using namespace tj::xp;

constexpr int S_BS = 32;  // slices per block (threadIdx.x)
constexpr int S_BY = 8;   // bins (FP) or columns (update) per block
constexpr int RES_THREADS = 1024;  // E4 block

struct Tables {  // TABLE_BF16 operands (null otherwise)
  const int* fp_i0;               // (Na, Nt, N) first tap of each step
  const __nv_bfloat162* fp_w;     // (Na, Nt, N) its two weights
  const int* bp_j0;               // (Na, N, N) first bin of each pixel
  const __nv_bfloat162* bp_w;     // (Na, N, N) its two weights
};

// E3 FP -- replaces the FP passes of scripts/exp_sart_pipeline.py
// _dbuf_kernel (TAPS_F32), _wvmem_kernel (TAPS_BF16; TAPS_F32 as wv_f32),
// _whbm_kernel (TABLE_BF16) and exp_sart_ablate.py _kernel (TAPS_F32,
// NOHAT, NOFP, NOUPD; rot = TAPS_F32) and _phase_kernel (TAPS_F32).
//
// One thread per (bin j, slice s) as K8's sart_fp_kernel; the residual goes
// to an (Nt, Ns) scratch plane.
template <int MODE>
__global__ void __launch_bounds__(S_BS * S_BY)
exp_sart_fp_kernel(const float* __restrict__ x,
                   const float4* __restrict__ ftab,
                   const float4* __restrict__ btab,
                   const float* __restrict__ b,
                   const float* __restrict__ inv_row,
                   const int* __restrict__ order, int k, Tables tb,
                   float* __restrict__ resid, int n, int nt, int na, int ns) {
  const int s = blockIdx.x * S_BS + threadIdx.x;
  const int j = blockIdx.y * S_BY + threadIdx.y;
  if (s >= ns || j >= nt) return;
  const int a = order[k];
  const size_t o = static_cast<size_t>(j) * ns + s;
  if (a < 0 || a >= na) {
    resid[o] = 0.f;
    return;
  }
  const size_t aj = static_cast<size_t>(a) * nt + j;
  const float4 bt = btab[a];
  const float acc = sart_fp_ray<MODE>(
      x, ftab[a], bt, MODE == TABLE_BF16 ? tb.fp_i0 + aj * n : nullptr,
      MODE == TABLE_BF16 ? tb.fp_w + aj * n : nullptr, n, nt, ns, j, s);
  resid[o] = sart_resid<MODE>(b[aj * ns + s], acc, bt.z, inv_row[aj]);
}

// One voxel's clamped update from its pixel's update sum.
__device__ __forceinline__ float sart_step(float xv, float beta, float invd,
                                           float inv_col, float upd) {
  const float scale = __fmul_rn(__fmul_rn(beta, invd), inv_col);
  return fmaxf(__fadd_rn(xv, __fmul_rn(scale, upd)), 0.f);
}

// E3 update -- the update passes of the same kernels: one thread per voxel
// as K8's sart_update_kernel, reading the scratch plane.
template <int MODE>
__global__ void __launch_bounds__(S_BS * S_BY)
exp_sart_update_kernel(const float* src, float* dst,  // alias after step 0
                       const float* __restrict__ resid,
                       const float4* __restrict__ btab,
                       const float* __restrict__ inv_col_a,
                       const float* __restrict__ beta,
                       const int* __restrict__ order, int k, Tables tb, int n,
                       int nt, int na, int ns) {
  const int s = blockIdx.x * S_BS + threadIdx.x;
  const int c = blockIdx.y * S_BY + threadIdx.y;
  const int r = blockIdx.z;
  if (s >= ns || c >= n) return;
  const size_t o = (static_cast<size_t>(r) * n + c) * ns + s;
  const int a = order[k];
  if (a < 0 || a >= na) {
    dst[o] = src[o];
    return;
  }
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const size_t pix = (static_cast<size_t>(a) * n + r) * n + c;
  const float4 bt = btab[a];
  const float upd = sart_bp_voxel<MODE>(
      resid + s, ns, bt, MODE == TABLE_BF16 ? tb.bp_j0 + pix : nullptr,
      MODE == TABLE_BF16 ? tb.bp_w + pix : nullptr,
      static_cast<float>(c) - ctr, ctr - static_cast<float>(r), off, nt);
  dst[o] = sart_step(src[o], beta[0], bt.z, inv_col_a[pix], upd);
}

// E4 -- replaces scripts/exp_sart_pipeline.py:_resident_kernel (res:
// TAPS_BF16, reshbm: TABLE_BF16; TAPS_F32 for comparison with E3 and K8).
//
// One launch per sweep. SART's slices are independent, so block b owns
// slices [b sb, (b+1) sb) for every angle and no grid-wide barrier is
// needed: it copies its slab of x into out, then per angle walks the FP of
// its Nt x sb rays into a residual in shared memory, waits at a block
// barrier, updates its N x N x sb voxels in place and waits again. The slab
// (N^2 sb floats) is re-read from L2 between the passes; a 256^3 volume
// (64 MiB) fits neither one SM's shared memory nor the 50 MB L2 whole. A
// block has 1024 threads, the most a block may have, to keep many of the
// latency-bound walks in flight. It computes E3's step in E3's arithmetic,
// so E4 equals E3 of its mode bit for bit.
template <int MODE>
__global__ void __launch_bounds__(RES_THREADS)
exp_sart_resident_kernel(const float* __restrict__ x,
                         const float4* __restrict__ ftab,
                         const float4* __restrict__ btab,
                         const float* __restrict__ b,
                         const float* __restrict__ inv_row,
                         const float* __restrict__ inv_col_a,
                         const float* __restrict__ beta,
                         const int* __restrict__ order, int steps, Tables tb,
                         float* out, int n, int nt, int na, int ns, int sb) {
  extern __shared__ float res[];  // [Nt][nsl]
  const int s0 = blockIdx.x * sb;
  const int nsl = min(sb, ns - s0);
  const int tid = threadIdx.x;
  const int nvox = n * n * nsl;
  for (int v = tid; v < nvox; v += RES_THREADS) {
    const size_t o = static_cast<size_t>(v / nsl) * ns + s0 + v % nsl;
    out[o] = x[o];
  }
  __syncthreads();
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float off = 0.5f * static_cast<float>(nt - 1);
  for (int k = 0; k < steps; ++k) {
    const int a = order[k];
    if (a < 0 || a >= na) continue;  // the same for the whole block
    const float4 ft = ftab[a], bt = btab[a];
    for (int i = tid; i < nt * nsl; i += RES_THREADS) {
      const int j = i / nsl, sl = i - j * nsl;
      const size_t aj = static_cast<size_t>(a) * nt + j;
      const float acc = sart_fp_ray<MODE>(
          out, ft, bt, MODE == TABLE_BF16 ? tb.fp_i0 + aj * n : nullptr,
          MODE == TABLE_BF16 ? tb.fp_w + aj * n : nullptr, n, nt, ns, j,
          s0 + sl);
      res[i] = sart_resid<MODE>(b[aj * ns + s0 + sl], acc, bt.z,
                                inv_row[aj]);
    }
    __syncthreads();
    const float bb = beta[0];
    for (int v = tid; v < nvox; v += RES_THREADS) {
      const int p = v / nsl, sl = v - p * nsl;
      const int r = p / n, c = p - r * n;
      const size_t pix = static_cast<size_t>(a) * n * n + p;
      const float upd = sart_bp_voxel<MODE>(
          res + sl, nsl, bt, MODE == TABLE_BF16 ? tb.bp_j0 + pix : nullptr,
          MODE == TABLE_BF16 ? tb.bp_w + pix : nullptr,
          static_cast<float>(c) - ctr, ctr - static_cast<float>(r), off, nt);
      const size_t o = static_cast<size_t>(p) * ns + s0 + sl;
      out[o] = sart_step(out[o], bb, bt.z, inv_col_a[pix], upd);
    }
    __syncthreads();
  }
}

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

template <int MODE>
int run_sweep(const SweepArgs& g, float* resid) {
  const dim3 block(S_BS, S_BY);
  const dim3 fp_grid((g.ns + S_BS - 1) / S_BS, (g.nt + S_BY - 1) / S_BY);
  const dim3 up_grid((g.ns + S_BS - 1) / S_BS, (g.n + S_BY - 1) / S_BY, g.n);
  if (MODE == NOUPD) {  // x unchanged: out = x, the FP passes read x
    const cudaError_t e = cudaMemcpyAsync(
        g.out, g.x, sizeof(float) * g.n * g.n * g.ns,
        cudaMemcpyDeviceToDevice, g.st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  for (int k = 0; k < g.steps; ++k) {
    const float* src = (k == 0 || MODE == NOUPD) ? g.x : g.out;
    exp_sart_fp_kernel<MODE><<<fp_grid, block, 0, g.st>>>(
        src, g.ft, g.bt, g.b, g.inv_row, g.order, k, g.tb, resid, g.n, g.nt,
        g.na, g.ns);
    int err = tj::launch_error();
    if (err != 0) return err;
    if (MODE == NOUPD) continue;
    exp_sart_update_kernel<MODE><<<up_grid, block, 0, g.st>>>(
        src, g.out, resid, g.bt, g.inv_col_a, g.beta, g.order, k, g.tb, g.n,
        g.nt, g.na, g.ns);
    err = tj::launch_error();
    if (err != 0) return err;
  }
  return 0;
}

template <int MODE>
int run_resident(const SweepArgs& g, int sb) {
  const size_t smem = sizeof(float) * g.nt * sb;
  exp_sart_resident_kernel<MODE>
      <<<(g.ns + sb - 1) / sb, RES_THREADS, smem, g.st>>>(
          g.x, g.ft, g.bt, g.b, g.inv_row, g.inv_col_a, g.beta, g.order,
          g.steps, g.tb, g.out, g.n, g.nt, g.na, g.ns, sb);
  return tj::launch_error();
}

bool args_ok(const SweepArgs& g, int mode) {
  return g.n > 0 && g.nt > 0 && g.na > 0 && g.ns > 0 && g.steps > 0 &&
         g.n <= 65535 && (g.nt + S_BY - 1) / S_BY <= 65535 &&
         (g.n + S_BY - 1) / S_BY <= 65535 &&
         (mode != TABLE_BF16 || (g.tb.fp_i0 && g.tb.fp_w && g.tb.bp_j0 &&
                                 g.tb.bp_w));
}

SweepArgs make_args(const float* x, const float* fp_tab, const float* bp_tab,
                    const float* b, const float* inv_row,
                    const float* inv_col_a, const float* beta,
                    const int* order, int steps, float* out,
                    const int* fp_i0, const void* fp_w, const int* bp_j0,
                    const void* bp_w, int n, int nt, int na, int ns,
                    void* stream) {
  return {x, reinterpret_cast<const float4*>(fp_tab),
          reinterpret_cast<const float4*>(bp_tab), b, inv_row, inv_col_a,
          beta, order, steps,
          {fp_i0, static_cast<const __nv_bfloat162*>(fp_w), bp_j0,
           static_cast<const __nv_bfloat162*>(bp_w)},
          out, n, nt, na, ns, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// E3: one sweep over order[0 .. steps) in `mode` (a Mode); x (N, N, Ns)
// input, out (N, N, Ns) result (may not alias x); fp_tab / bp_tab the
// (Na, 4) tables of cuda_joseph.angle_tables; b (Na, Nt, Ns); inv_row
// (Na, Nt); inv_col_a (Na, N, N); beta 1 float and order `steps` ints on
// the device; resid (Nt, Ns) floats of scratch; the four tables for
// TABLE_BF16, else null.
TJ_API int tj_exp_sart_sweep(int mode, const float* x, const float* fp_tab,
                             const float* bp_tab, const float* b,
                             const float* inv_row, const float* inv_col_a,
                             const float* beta, const int* order, int steps,
                             float* resid, float* out, const int* fp_i0,
                             const void* fp_w, const int* bp_j0,
                             const void* bp_w, int n, int nt, int na, int ns,
                             void* stream) {
  const SweepArgs g = make_args(x, fp_tab, bp_tab, b, inv_row, inv_col_a,
                                beta, order, steps, out, fp_i0, fp_w, bp_j0,
                                bp_w, n, nt, na, ns, stream);
  if (!args_ok(g, mode)) return cudaErrorInvalidValue;
  switch (mode) {
    case TAPS_F32: return run_sweep<TAPS_F32>(g, resid);
    case TAPS_BF16: return run_sweep<TAPS_BF16>(g, resid);
    case TABLE_BF16: return run_sweep<TABLE_BF16>(g, resid);
    case S_NOHAT: return run_sweep<S_NOHAT>(g, resid);
    case NOFP: return run_sweep<NOFP>(g, resid);
    case NOUPD: return run_sweep<NOUPD>(g, resid);
    default: return cudaErrorInvalidValue;
  }
}

// E4: the same sweep in one launch, sb slices per block (Nt sb floats of
// shared memory, at most 48 KB); mode TAPS_F32, TAPS_BF16 or TABLE_BF16.
TJ_API int tj_exp_sart_resident(int mode, const float* x,
                                const float* fp_tab, const float* bp_tab,
                                const float* b, const float* inv_row,
                                const float* inv_col_a, const float* beta,
                                const int* order, int steps, float* out,
                                const int* fp_i0, const void* fp_w,
                                const int* bp_j0, const void* bp_w, int n,
                                int nt, int na, int ns, int sb,
                                void* stream) {
  const SweepArgs g = make_args(x, fp_tab, bp_tab, b, inv_row, inv_col_a,
                                beta, order, steps, out, fp_i0, fp_w, bp_j0,
                                bp_w, n, nt, na, ns, stream);
  if (!args_ok(g, mode) || sb < 1 ||
      sizeof(float) * static_cast<size_t>(nt) * sb > 48 * 1024 ||
      static_cast<size_t>(n) * n * sb > (1u << 30)) {
    return cudaErrorInvalidValue;
  }
  switch (mode) {
    case TAPS_F32: return run_resident<TAPS_F32>(g, sb);
    case TAPS_BF16: return run_resident<TAPS_BF16>(g, sb);
    case TABLE_BF16: return run_resident<TABLE_BF16>(g, sb);
    default: return cudaErrorInvalidValue;
  }
}
