// K8 -- replaces tomojax/solvers/pallas_sart.py:_sart_resident_kernel and
// _sart_kernel: ordered SART (block-Kaczmarz over angles), the semantics of
// the XLA branch of tomojax/solvers/iterative.py:sart_sweep. For each step
// k with angle a = order[k]:
//   resid = (b_a - A_a x) * inv_row[a]                  (Nt, Ns)
//   x     = max(x + beta * inv_col_a[a] * A_a^T resid, 0)
// with A_a the Joseph operator of one angle (at most two taps per pixel and
// per ray), slice-last layouts: x (N, N, Ns), b (Na, Nt, Ns).
//
// The TPU kernels kept the whole volume in VMEM and streamed a ~2.9 GB bf16
// precomputed W through the MXU. On Hopper A_a is a 2-tap gather, so W is
// not stored: each step is two launches on the caller's stream,
//   sart_fp_kernel      one thread per (bin, slice): the driving-axis walk
//                       of K1 (tj::fp_ray) and the residual into a
//                       (Nt, Ns) scratch plane;
//   sart_update_kernel  one thread per voxel: K2's one-angle gather
//                       (tj::bp_angle) from that plane and the clamped
//                       update, in place (each voxel only by its thread).
// The sweep is 2 K launches issued by one host call; order and beta are read
// on the device (order[k] inside both kernels, beta through a pointer), so
// a solver loop queues sweeps without waiting for the host. The first
// step reads the input volume and writes the output, so the input is left
// as it was. An order entry outside [0, Na) leaves x unchanged (no read out
// of bounds).
//
// Bound on the H100: device memory. Per step the FP reads the volume and
// the update reads and writes it: 3 x 64 MiB at 256^3, x 90 angles ~ 17 GB
// per sweep when nothing stays in the 50 MB L2 (the volume is 64 MiB).
// Keeping slice blocks resident across angles is left for later.
#include "joseph.cuh"

namespace {

constexpr int S_BS = 32;  // slices per block (threadIdx.x)
constexpr int S_BY = 8;   // bins (FP) or columns (update) per block
constexpr int S_NT = S_BS * S_BY;

__global__ void __launch_bounds__(S_NT)
sart_fp_kernel(const float* __restrict__ x, const float4* __restrict__ tab,
               const float* __restrict__ b, const float* __restrict__ inv_row,
               const int* __restrict__ order, int k,
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
  const float4 t = tab[a];  // {inv_d, shear, scale, row_driven}
  const float ax = tj::fp_ray(x, t, n, nt, ns, j, s) * t.z;
  const size_t ab = static_cast<size_t>(a) * nt + j;
  resid[o] = __fmul_rn(__fsub_rn(b[ab * ns + s], ax), inv_row[ab]);
}

__global__ void __launch_bounds__(S_NT)
sart_update_kernel(const float* src, float* dst,  // alias after step 0
                   const float* __restrict__ resid,
                   const float4* __restrict__ tab,
                   const float* __restrict__ inv_col_a,
                   const float* __restrict__ beta,
                   const int* __restrict__ order, int k, int n, int nt,
                   int na, int ns) {
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
  const float xc = static_cast<float>(c) - ctr;
  const float yr = ctr - static_cast<float>(r);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const float upd = tj::bp_angle(resid + s, tab[a], xc, yr, off, nt, ns, 0.f);
  const float scale =
      __fmul_rn(beta[0], inv_col_a[(static_cast<size_t>(a) * n + r) * n + c]);
  dst[o] = fmaxf(__fadd_rn(src[o], __fmul_rn(scale, upd)), 0.f);
}

}  // namespace

// x (N, N, Ns) input, out (N, N, Ns) result (may not alias x); fp_tab and
// bp_tab the (Na, 4) angle tables of cuda_joseph.angle_tables; b
// (Na, Nt, Ns); inv_row (Na, Nt); inv_col_a (Na, N, N); beta 1 float and
// order `steps` ints on the device; resid (Nt, Ns) floats of scratch.
TJ_API int tj_sart_sweep(const float* x, const float* fp_tab,
                         const float* bp_tab, const float* b,
                         const float* inv_row, const float* inv_col_a,
                         const float* beta, const int* order, int steps,
                         float* resid, float* out, int n, int nt, int na,
                         int ns, void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || steps <= 0 || n > 65535 ||
      (nt + S_BY - 1) / S_BY > 65535 || (n + S_BY - 1) / S_BY > 65535) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* ft = reinterpret_cast<const float4*>(fp_tab);
  const auto* bt = reinterpret_cast<const float4*>(bp_tab);
  const dim3 block(S_BS, S_BY);
  const dim3 fp_grid((ns + S_BS - 1) / S_BS, (nt + S_BY - 1) / S_BY);
  const dim3 up_grid((ns + S_BS - 1) / S_BS, (n + S_BY - 1) / S_BY, n);
  for (int k = 0; k < steps; ++k) {
    const float* src = k == 0 ? x : out;
    sart_fp_kernel<<<fp_grid, block, 0, st>>>(src, ft, b, inv_row, order, k,
                                              resid, n, nt, na, ns);
    int err = tj::launch_error();
    if (err != 0) return err;
    sart_update_kernel<<<up_grid, block, 0, st>>>(
        src, out, resid, bt, inv_col_a, beta, order, k, n, nt, na, ns);
    err = tj::launch_error();
    if (err != 0) return err;
  }
  return 0;
}
