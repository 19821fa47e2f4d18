// K8 -- replaces tomojax/solvers/pallas_sart.py:_sart_resident_kernel and
// _sart_kernel: ordered SART (block-Kaczmarz over angles), the semantics of
// the XLA branch of tomojax/solvers/iterative.py:sart_sweep. For each step
// k with angle a = order[k]:
//   resid = (b_a - A_a x) * inv_row[a]                  (Nt, Ns)
//   x     = max(x + beta * inv_col_a[a] * A_a^T resid, 0)
// with A_a the Joseph operator of one angle (at most two taps per pixel and
// per ray), slice-last layouts: x (N, N, Ns), b (Na, Nt, Ns). order and beta
// are read on the device, so a solver loop queues sweeps without waiting
// for the host; an order entry outside [0, Na) leaves x unchanged (no read
// out of bounds); the input is left as it was. One host call is one sweep.
//
// Two routes, chosen by the shape alone (tj::sr::resident_smem over
// R_SHAPES; cuda_sart.sart_shape mirrors it):
//
// Resident (a block's share fits the card's 227 KB at one of K8's cluster
// shapes): sart_resident.cuh's cluster-resident sweep at the first shape of
// R_SHAPES that fits, (8, 4) = 8 blocks (bands of rows) a cluster and 4
// slices (a float4 a pixel) up to N = 288 at Nt = N (130 KB of band a block
// at N = 256), then (16, 2) = 16 blocks (a non-portable cluster) and 2
// slices (a float2 a pixel) up to N = 528 (216,064 B a block at N = 512),
// then (16, 1) in the spilling layout (sart_resident.cuh: inv_col_a read
// from device memory, the band rows past held_rows kept in a device scratch
// that L2 holds, a row-driven angle's rays walked R_CHAINS together, the
// residual by reduce-scatter) while at most a quarter of a band spills: 13
// of 64 rows a block at N = 1024, up to N = 1052 at Nt = N. All
// in K8's arithmetic (K8Taps): tj::fp_ray's positions and
// fmaf chain over the taps of each band, the partials added in rank order,
// scaled by 1/D into (b - ax) inv_row, and K8's update chain (tj::bp_angle's
// taps and fmaf pair, then max(x + beta inv_col_a upd, 0) with the same
// rounding) on the local plane, in place. b[a], inv_row[a] and the band's
// rows of inv_col_a[a] (32 KB at N = 256; 23.6 MB in all, shared by every
// cluster in L2) are copied with cp.async while the FP runs (not on the
// spilling layout). Only the FP's
// sum order differs from the streaming route and the plain version (the
// ray summed as band partials added in rank order), so the resident result
// is not bit-equal to them; the update is the streaming route's to the
// bit. The PROF instantiation times the phases (tj_sart_resident_phases).
// The experiment sweeps E3/E4 (exp_sart.cu) run the same template in the
// experiment modes, to split this route's time.
//
// Streaming (N above 1052 at Nt = N): each step is two launches on the
// caller's stream,
//   sart_fp_kernel      one thread per (bin, slice): the driving-axis walk
//                       of K1 (tj::fp_ray) and the residual into a
//                       (Nt, Ns) scratch plane;
//   sart_update_kernel  one thread per voxel: K2's one-angle gather
//                       (tj::bp_angle) from that plane and the clamped
//                       update, in place (each voxel only by its thread).
// Both routes' updates round each weight's operations alone, as the plain
// version does (tj::bp_taps<true>): a pixel whose one in-range tap nearly
// vanishes gets a large inv_col_a, which magnified the contracted FMA's
// difference past the one-step bound at 512^2.
//
// Bound on the H100: the streaming route moves the volume three times a
// step (3 x 64 MiB at 256^3, x 90 angles ~ 17 GB a sweep: 5.2 ms at the
// 3.35 TB/s of device memory). The resident route reads the volume and
// writes it once a sweep; its time is the FP's and the update's
// shared-memory reads (~12 + 12 GB a sweep at 256^3 x 90) and a cluster
// barrier a step.
#include "joseph.cuh"
#include "sart_resident.cuh"

namespace {

// ------------------------------------------------------------ streaming

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

int streaming_sweep(const float* x, const float4* ft, const float4* bt,
                    const float* b, const float* inv_row,
                    const float* inv_col_a, const float* beta,
                    const int* order, int steps, float* resid, float* out,
                    int n, int nt, int na, int ns, cudaStream_t st) {
  if (resid == nullptr || n > 65535 || (nt + S_BY - 1) / S_BY > 65535 ||
      (n + S_BY - 1) / S_BY > 65535) {
    return cudaErrorInvalidValue;
  }
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

// ------------------------------------------------------------- resident

using tj::sr::Vec;

// K8's arithmetic on sart_resident.cuh's sweep: tj::fp_ray's positions and
// fmaf pair from 1 - frac, the residual scaled by 1/|denom|, the update's
// taps rounded as the plain version's (tj::bp_taps<true>) and its fmaf
// pair, x + beta inv_col_a upd clamped at 0.
struct K8Taps {
  struct Params {};
  static constexpr bool FP = true, UPDATE = true;

  struct Ray {
    __device__ __forceinline__ Ray(const Params&, const float4*, int, int,
                                   int, int) {}
    template <bool ROW>
    __device__ __forceinline__ tj::sr::Tap tap(int, float pos) const {
      const float f = floorf(pos);
      const float frac = pos - f;
      return {static_cast<int>(f), 1.f - frac, frac};
    }
    // acc + v0 (1 - frac) + v1 frac per slice, tj::fp_ray's fmaf pair
    template <int SB>
    __device__ __forceinline__ void add(Vec<SB>& acc, Vec<SB> v0, Vec<SB> v1,
                                        const tj::sr::Tap& t) const {
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        float& a = tj::sr::lanes<SB>(acc)[i];
        a = fmaf(tj::sr::lanes<SB>(v1)[i], t.w1,
                 fmaf(tj::sr::lanes<SB>(v0)[i], t.w0, a));
      }
    }
  };

  static __device__ __forceinline__ float resid(float s, float b, float ir,
                                                float4 ft, float4) {
    return __fmul_rn(__fsub_rn(b, __fmul_rn(s, ft.z)), ir);
  }
  static __device__ __forceinline__ tj::BpTaps bp(const Params&, float4 bt,
                                                  int, int, int, float xc,
                                                  float yr, float off, int) {
    return tj::bp_taps<true>(bt, xc, yr, off);
  }
  static __device__ __forceinline__ float upd(float r0, float r1,
                                              const tj::BpTaps& t) {
    return fmaf(r1, t.w1, fmaf(r0, t.w0, 0.f));
  }
  static __device__ __forceinline__ float scale(float beta, float4,
                                                float icol) {
    return __fmul_rn(beta, icol);
  }
};

// K8's cluster shapes, {blocks (bands) a cluster, slices a pixel, the
// spilling layout}, in the order the route tries them: the first that fits
// runs. (8, 4) for N <= 288 at Nt = N; (16, 2), whose bands have half the
// rows and pixels half the slices, for 289 <= N <= 528; (16, 1) spilling
// for 529 <= N <= 1052 (no row spills up to N = 918); streaming above.
constexpr int R_SHAPES[3][3] = {{8, 4, 0}, {16, 2, 0}, {16, 1, 1}};
constexpr int R_NSHAPES = sizeof(R_SHAPES) / sizeof(R_SHAPES[0]);
static_assert(R_NSHAPES == 3, "resident_sweep and tj_sart_active_clusters "
                              "dispatch on every shape");
// the spilling shape's FP: the rays of a row-driven angle a thread walks
// together (2 Nt / R_NT = 4 rounds of (bin, phase) items at Nt = 1024)
constexpr int R_CHAINS = 4;

// 1 + the index in R_SHAPES of the shape the resident route takes at this
// shape, or 0 where none fits (the streaming route).
int resident_shape(int n, int nt) {
  for (int i = 0; i < R_NSHAPES; ++i) {
    if (tj::sr::resident_fits(n, nt, R_SHAPES[i][0], R_SHAPES[i][1],
                              R_SHAPES[i][2] != 0)) {
      return i + 1;
    }
  }
  return 0;
}

// The band rows a block of the route at this shape keeps in device memory
// (the spilling shape's spill_rows; 0 on the others and streaming).
int route_spill_rows(int n, int nt) {
  const int shape = resident_shape(n, nt);
  if (shape == 0 || R_SHAPES[shape - 1][2] == 0) return 0;
  return tj::sr::spill_rows(n, nt, R_SHAPES[shape - 1][0],
                            R_SHAPES[shape - 1][1]);
}

// CHAINS: the rays of a row-driven angle the spilling shape walks together
// (1: one after another, for tj_sart_resident_phases' comparison).
template <bool PROF, int CHAINS = R_CHAINS>
int resident_sweep(int shape, const float* x, const float4* ft,
                   const float4* bt, const float* b, const float* inv_row,
                   const float* inv_col_a, const float* beta,
                   const int* order, int steps, float* out, int n, int nt,
                   int na, int ns, long long* prof, float* spill,
                   cudaStream_t st) {
  switch (shape) {
    case 1:
      return tj::sr::resident_sweep<K8Taps, R_SHAPES[0][0], R_SHAPES[0][1],
                                    PROF>(x, ft, bt, b, inv_row, inv_col_a,
                                          beta, order, steps, out, n, nt, na,
                                          ns, prof, K8Taps::Params{}, st);
    case 2:
      return tj::sr::resident_sweep<K8Taps, R_SHAPES[1][0], R_SHAPES[1][1],
                                    PROF>(x, ft, bt, b, inv_row, inv_col_a,
                                          beta, order, steps, out, n, nt, na,
                                          ns, prof, K8Taps::Params{}, st);
    case 3:
      return tj::sr::resident_sweep<K8Taps, R_SHAPES[2][0], R_SHAPES[2][1],
                                    PROF, true, CHAINS>(
          x, ft, bt, b, inv_row, inv_col_a, beta, order, steps, out, n, nt,
          na, ns, prof, K8Taps::Params{}, st, spill);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (N, N, Ns) input, out (N, N, Ns) result (may not alias x); fp_tab and
// bp_tab the (Na, 4) angle tables of cuda_joseph.angle_tables; b
// (Na, Nt, Ns); inv_row (Na, Nt); inv_col_a (Na, N, N); beta 1 float and
// order `steps` ints on the device; scratch: the streaming route's (Nt, Ns)
// residual plane, the spilling shape's (Ns, 16, tj_sart_spill_rows, N)
// band rows, null (unused) where the route needs neither. The route is
// tj_sart_route(n, nt); a launch that fails returns its error and never
// takes the other route.
TJ_API int tj_sart_sweep(const float* x, const float* fp_tab,
                         const float* bp_tab, const float* b,
                         const float* inv_row, const float* inv_col_a,
                         const float* beta, const int* order, int steps,
                         float* scratch, float* out, int n, int nt, int na,
                         int ns, void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || steps <= 0) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* ft = reinterpret_cast<const float4*>(fp_tab);
  const auto* bt = reinterpret_cast<const float4*>(bp_tab);
  const int shape = resident_shape(n, nt);
  if (shape == 0) {
    return streaming_sweep(x, ft, bt, b, inv_row, inv_col_a, beta, order,
                           steps, scratch, out, n, nt, na, ns, st);
  }
  return resident_sweep<false>(shape, x, ft, bt, b, inv_row, inv_col_a,
                               beta, order, steps, out, n, nt, na, ns,
                               nullptr, scratch, st);
}

// tj_sart_sweep's resident route with its phases timed, at the shape
// tj_sart_route names: prof holds, per block (blocks a cluster, a cluster
// per slices a pixel), {row-driven, column-driven} x {copy issue, FP, copy
// wait + cluster barrier, residual, update, steps} int64s (clock64 cycles
// of thread 0; the FP ends at a block barrier of its own); scratch as
// tj_sart_sweep's. serial_fp != 0: the spilling shape's FP walks the rays
// of a row-driven angle one after another (the other shapes always do).
TJ_API int tj_sart_resident_phases(const float* x, const float* fp_tab,
                                   const float* bp_tab, const float* b,
                                   const float* inv_row,
                                   const float* inv_col_a, const float* beta,
                                   const int* order, int steps,
                                   float* scratch, float* out, int n, int nt,
                                   int na, int ns, long long* prof,
                                   int serial_fp, void* stream) {
  const int shape = n > 0 && nt > 0 ? resident_shape(n, nt) : 0;
  if (na <= 0 || ns <= 0 || steps <= 0 || shape == 0) {
    return cudaErrorInvalidValue;
  }
  const auto* ft = reinterpret_cast<const float4*>(fp_tab);
  const auto* bt = reinterpret_cast<const float4*>(bp_tab);
  auto st = static_cast<cudaStream_t>(stream);
  if (serial_fp != 0) {
    return resident_sweep<true, 1>(shape, x, ft, bt, b, inv_row, inv_col_a,
                                   beta, order, steps, out, n, nt, na, ns,
                                   prof, scratch, st);
  }
  return resident_sweep<true>(shape, x, ft, bt, b, inv_row, inv_col_a, beta,
                              order, steps, out, n, nt, na, ns, prof,
                              scratch, st);
}

// The route tj_sart_sweep takes at this shape: 1 + the index in R_SHAPES
// of its resident cluster shape, or 0 for the streaming route.
TJ_API int tj_sart_route(int n, int nt) {
  return n > 0 && nt > 0 ? resident_shape(n, nt) : 0;
}

// The band rows a block of the route at this shape keeps in device memory:
// the spilling shape's, 0 on the other shapes and on the streaming route.
TJ_API int tj_sart_spill_rows(int n, int nt) {
  return n > 0 && nt > 0 ? route_spill_rows(n, nt) : 0;
}

// *clusters: how many clusters of the resident route the card holds at
// once (cudaOccupancyMaxActiveClusters) for a launch at this shape, at the
// cluster shape tj_sart_route names.
TJ_API int tj_sart_active_clusters(int n, int nt, int ns, int* clusters) {
  const int shape = n > 0 && nt > 0 ? resident_shape(n, nt) : 0;
  if (ns <= 0) return cudaErrorInvalidValue;
  switch (shape) {
    case 1:
      return tj::sr::active_clusters<K8Taps, R_SHAPES[0][0], R_SHAPES[0][1]>(
          n, nt, ns, clusters);
    case 2:
      return tj::sr::active_clusters<K8Taps, R_SHAPES[1][0], R_SHAPES[1][1]>(
          n, nt, ns, clusters);
    case 3:
      return tj::sr::active_clusters<K8Taps, R_SHAPES[2][0], R_SHAPES[2][1],
                                     true, R_CHAINS>(n, nt, ns, clusters);
    default:
      return cudaErrorInvalidValue;
  }
}
