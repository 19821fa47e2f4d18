// Experiment SART sweep E3, the counterpart of the TPU kernels of
// scripts/exp_sart_pipeline.py and exp_sart_ablate.py, and the instrument
// that splits K8's step. One ordered SART step at angle a = order[k]
// (exp_hat.cuh for the modes and weights):
//   acc   = sum over the taps of w x                        (FP walk)
//   resid = (b_a - invd acc) inv_row[a]                      (Nt, Ns)
//   x     = max(x + (beta invd) inv_col_a[a] sum_taps w resid, 0)
// with the unscaled hat w of the TPU sweeps (the 1/D deferred into the two
// scalars), slice-last x (N, N, Ns), b (Na, Nt, Ns). order and beta are
// read on the device.
//
// The TPU variants only restructure this step for Mosaic (double-buffered
// W, W kept in VMEM per angle, W streamed from HBM, the volume resident in
// VMEM, the chunk loop as a grid axis); on Hopper each is one of the modes,
// and the W tensor becomes two tables of taps and bf16 weights (8 bytes per
// tap pair, built once per geometry by
// experiments/cuda_sart_variants.py:sart_tables).
//
// E3 takes two routes, chosen by the shape alone (cuda_sart_variants.
// e3_route); K8 has a second resident shape, (16, 2), that E3 has not:
//   resident   (N <= 288 at Nt = N) K8's cluster-resident sweep of
//              sart_resident.cuh at K8's first shape, 8 blocks a cluster and
//              4 slices a pixel, in the mode's arithmetic (exp_sart.cuh
//              SartTaps): one launch a sweep. So TAPS_F32 - NOHAT is the
//              hat's share of K8's step, TAPS_F32 - NOFP the FP's,
//              TAPS_F32 - NOUPD the update's, TAPS_BF16 - TAPS_F32 what bf16
//              operands cost and TABLE_BF16 - TAPS_BF16 what tables cost.
//              Bound as K8's: the FP's and the update's shared-memory reads
//              and a cluster barrier a step; device memory sees the volume
//              once a sweep (and the tables, 94.4 MB at 256^3 x 90).
//   streaming  (above: 512^2 for one) the streaming route's two launches,
//              exp_sart_fp_kernel and exp_sart_update_kernel below; bound by
//              device memory (the volume read by the FP and read and written
//              by the update at every step, ~17 GB a sweep at 256^3 x 90
//              when nothing stays in the 50 MB L2).
// E4 (exp_sart_shapes.cu) is the resident route at other cluster shapes.
#include "exp_sart.cuh"

namespace {

using namespace tj::xp;

constexpr int S_BS = 32;  // slices per block (threadIdx.x)
constexpr int S_BY = 8;   // bins (FP) or columns (update) per block
constexpr int E_BLOCKS = 8;  // the resident route's cluster: K8's first
constexpr int E_SLICES = 4;

// E3 replaces scripts/exp_sart_pipeline.py _dbuf_kernel (TAPS_F32),
// _wvmem_kernel (TAPS_BF16; TAPS_F32 as wv_f32), _whbm_kernel (TABLE_BF16)
// and exp_sart_ablate.py _kernel (TAPS_F32, NOHAT, NOFP, NOUPD; rot =
// TAPS_F32) and _phase_kernel (TAPS_F32), on either route.
//
// Streaming FP: one thread per (bin j, slice s) as K8's sart_fp_kernel; the
// residual goes to an (Nt, Ns) scratch plane.
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

// Streaming update: one thread per voxel as K8's sart_update_kernel,
// reading the scratch plane.
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

template <int MODE, bool PROF>
int run_resident(const SweepArgs& g, long long* prof) {
  return tj::sr::resident_sweep<SartTaps<MODE>, E_BLOCKS, E_SLICES, PROF>(
      g.x, g.ft, g.bt, g.b, g.inv_row, g.inv_col_a, g.beta, g.order,
      g.steps, g.out, g.n, g.nt, g.na, g.ns, prof, g.tb, g.st);
}

template <bool PROF>
int resident_mode(int mode, const SweepArgs& g, long long* prof) {
  switch (mode) {
    case TAPS_F32: return run_resident<TAPS_F32, PROF>(g, prof);
    case TAPS_BF16: return run_resident<TAPS_BF16, PROF>(g, prof);
    case TABLE_BF16: return run_resident<TABLE_BF16, PROF>(g, prof);
    case S_NOHAT: return run_resident<S_NOHAT, PROF>(g, prof);
    case NOFP: return run_resident<NOFP, PROF>(g, prof);
    case NOUPD: return run_resident<NOUPD, PROF>(g, prof);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
int clusters_of(int n, int nt, int ns, int* clusters) {
  return tj::sr::active_clusters<SartTaps<MODE>, E_BLOCKS, E_SLICES>(
      n, nt, ns, clusters);
}

}  // namespace

int tj::xp::e3_active_clusters(int mode, int n, int nt, int ns,
                               int* clusters) {
  switch (mode) {
    case TAPS_F32: return clusters_of<TAPS_F32>(n, nt, ns, clusters);
    case TAPS_BF16: return clusters_of<TAPS_BF16>(n, nt, ns, clusters);
    case TABLE_BF16: return clusters_of<TABLE_BF16>(n, nt, ns, clusters);
    case S_NOHAT: return clusters_of<S_NOHAT>(n, nt, ns, clusters);
    case NOFP: return clusters_of<NOFP>(n, nt, ns, clusters);
    case NOUPD: return clusters_of<NOUPD>(n, nt, ns, clusters);
    default: return cudaErrorInvalidValue;
  }
}

int tj::xp::e3_resident(int mode, const SweepArgs& g, long long* prof) {
  return prof == nullptr ? resident_mode<false>(mode, g, nullptr)
                         : resident_mode<true>(mode, g, prof);
}

// E3: one sweep over order[0 .. steps) in `mode` (a Mode) on E3's route at
// this shape (resident where (8, 4) fits); x (N, N, Ns) input, out (N, N,
// Ns) result (may not alias x); fp_tab / bp_tab the (Na, 4) tables of
// cuda_joseph.angle_tables; b (Na, Nt, Ns); inv_row (Na, Nt); inv_col_a
// (Na, N, N); beta 1 float and order `steps` ints on the device; resid
// (Nt, Ns) floats of scratch for the streaming route (may be null on the
// resident one); the four tables for TABLE_BF16, else null. A launch that
// fails returns its error and never takes the other route.
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
  if (tj::sr::resident_fits(n, nt, E_BLOCKS, E_SLICES)) {
    return tj::xp::e3_resident(mode, g, nullptr);
  }
  if (resid == nullptr) return cudaErrorInvalidValue;
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

// E3's resident route with its phases timed, as tj_sart_resident_phases
// times K8's: prof holds, per block (8 a cluster, a cluster per 4 slices),
// {row-driven, column-driven} x {copy issue, FP, copy wait + cluster
// barrier, residual, update, steps} int64s. Refused where E3 streams.
TJ_API int tj_exp_sart_resident_phases(
    int mode, const float* x, const float* fp_tab, const float* bp_tab,
    const float* b, const float* inv_row, const float* inv_col_a,
    const float* beta, const int* order, int steps, float* out,
    const int* fp_i0, const void* fp_w, const int* bp_j0, const void* bp_w,
    int n, int nt, int na, int ns, long long* prof, void* stream) {
  const SweepArgs g = make_args(x, fp_tab, bp_tab, b, inv_row, inv_col_a,
                                beta, order, steps, out, fp_i0, fp_w, bp_j0,
                                bp_w, n, nt, na, ns, stream);
  if (!args_ok(g, mode) || prof == nullptr ||
      !tj::sr::resident_fits(n, nt, E_BLOCKS, E_SLICES)) {
    return cudaErrorInvalidValue;
  }
  return tj::xp::e3_resident(mode, g, prof);
}
