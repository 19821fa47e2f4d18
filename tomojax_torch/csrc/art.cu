// A1 -- the ART (row-action Kaczmarz) sweep of
// tomojax/solvers/iterative.py:art_sweep. The reference runs it as an XLA
// lax.scan of one ray a step, not as a Pallas kernel; in plain PyTorch a
// ray costs about 20 launches (460,000 a sweep at 256^2 x 90), so the port
// runs the whole sweep in one launch. For k = 0, 1, ... with ray
// r = order[k] (angle a = r / Nt, bin j = r % Nt), for every slice s:
//   pos_m  = t_j / c + (ctr - m)(-s / c) + ctr    row-driven, or
//            ctr - t_j / s + (m - ctr)(c / s)     column-driven,
//   w0, w1 = the two hat taps of step m, scaled by 1/max(|c| or |s|, 1e-8),
//            out-of-range taps weighted 0 and their index clipped,
//   dot    = sum_m (x[p0] w0 + x[p1] w1),  nsq = sum_m (w0^2 + w1^2),
//   coeff  = beta (b[a, j, s] - dot) / max(nsq, 1e-12),
//   x[p0] += coeff w0, then x[p1] += coeff w1,
// with p = (m, i) for row-driven rays (step m walks row m) and (i, m) for
// column-driven ones (column m). Slice-last layouts: x (N, N, Ns),
// b (Na, Nt, Ns). The arithmetic of the positions, the weights and the
// updates is rounded as the plain version (cuda_art.art_sweep_sl_ref)
// rounds it, one operation at a time (__f*_rn: no FMA contraction); only
// the order of the dot's and nsq's sums differs from it.
//
// Why no atomics: slices are independent, so a block owns SL consecutive
// slices and walks every ray of the order itself. Within a ray, step m
// touches only row m (row-driven) or column m (column-driven), and each
// step belongs to one thread (step group g takes m = g, g + G, ...): no two
// threads write one pixel of a slice in a ray. The two taps of a step share
// a pixel only where one was clipped (weight 0); its thread then adds both
// in the reference's order. From one ray to the next a pixel keeps its
// owner while the driving axis stays the same; where it changes the block
// waits at a barrier before the next ray's reads. dot and nsq are summed in
// a fixed order (a thread's steps in order, a butterfly over the step lanes
// of a warp, then the warps in order), so two sweeps agree bit for bit.
//
// Layout: threadIdx.x is the slice lane (SL = 1, 2, 4, 8 or 16 slices,
// SL * 4 contiguous bytes a pixel), threadIdx.y the step group; a warp
// holds 32 / SL step groups, a block 32 ceil(N / (32 / SL * A_K)) threads
// (at most A_MAXW warps) with at most A_K steps a thread, whose taps and
// values stay in registers from the dot to the update. The order and the
// angle table are read on the device, the next ray's table row and b one
// ray ahead; an order entry outside [0, Na Nt) leaves x as it was.
//
// Bound on the H100: the sweep is one dependent chain of Na Nt rays (23,040
// at 256^2 x 90), each a read of 2N pixels, a block reduction with one
// barrier, and a write of 2N pixels, per slice: 16 N Ns bytes a ray, 24.2
// GB a sweep at 256^3 x 90 if every ray's pixels came from device memory
// (7.2 ms at 3.35 TB/s); the function itself moves x once each way
// (0.05 ms) and does 12 GFLOP (0.18 ms). Consecutive rays of one angle
// share most pixels, so the chain's latency (the reads after the previous
// ray's writes, the barrier, the reduction), not bytes, sets the pace:
// about 2.6 us a ray, 59 ms a sweep at 8 slices a block (chip_smoke.py).
#include "common.cuh"

namespace {

constexpr int A_K = 8;       // steps a thread at most
constexpr int A_MAXW = 16;   // warps a block at most (128 registers a
                             // thread: the taps and values of A_K steps)

struct Tap {
  int p0, p1;   // pixel indices (row * N + column) of the two taps
  float w0, w1;
};

// Step m of a ray: the reference's float32 arithmetic, one rounding an
// operation in its order. t1 = t_j / c' and sh = (-s) / c' (row-driven) or
// t1 = t_j / s' and sh = c / s' (column-driven), c' and s' the cosine and
// sine with magnitudes below 1e-8 replaced by 1.
__device__ __forceinline__ Tap ray_tap(bool rd, float t1, float sh,
                                       float scale, float ctr, int m,
                                       int n) {
  const float fm = static_cast<float>(m);
  const float pos =
      rd ? __fadd_rn(__fadd_rn(t1, __fmul_rn(__fsub_rn(ctr, fm), sh)), ctr)
         : __fadd_rn(__fsub_rn(ctr, t1), __fmul_rn(__fsub_rn(fm, ctr), sh));
  const float f = floorf(pos);
  const float frac = __fsub_rn(pos, f);
  const int i0 = static_cast<int>(f);
  const int i1 = i0 + 1;
  Tap t;
  t.w0 = __fmul_rn((i0 >= 0 && i0 < n) ? __fsub_rn(1.f, frac) : 0.f, scale);
  t.w1 = __fmul_rn((i1 >= 0 && i1 < n) ? frac : 0.f, scale);
  const int c0 = min(max(i0, 0), n - 1);
  const int c1 = min(max(i1, 0), n - 1);
  t.p0 = rd ? m * n + c0 : c0 * n + m;
  t.p1 = rd ? m * n + c1 : c1 * n + m;
  return t;
}

// The ray a block takes next: its index (-1 when outside [0, rays)), its
// angle's table row and this thread's b. Loaded one ray ahead, so that the
// loads from device memory overlap the current ray.
struct Ray {
  int r;
  float4 ang;
  float bv;
};

__device__ __forceinline__ Ray fetch_ray(int r, const float4* tab,
                                         const float* b, int nt, int rays,
                                         int ns, int s, bool live) {
  Ray ray;
  ray.r = (r >= 0 && r < rays) ? r : -1;
  ray.ang = make_float4(0.f, 0.f, 0.f, 0.f);
  ray.bv = 0.f;
  if (ray.r >= 0) {
    ray.ang = tab[r / nt];
    if (live) ray.bv = b[static_cast<size_t>(r) * ns + s];
  }
  return ray;
}

// x updated in place (the wrapper passes a copy); tab (Na) float4 {cos,
// sin, row_driven, 0} in float32; order `count` rays.
template <int SL>
__global__ void __launch_bounds__(A_MAXW * 32)
art_sweep_kernel(float* __restrict__ x, const float* __restrict__ b,
                 const float4* __restrict__ tab,
                 const int* __restrict__ order, int count, float beta,
                 int n, int nt, int na, int ns) {
  constexpr int Q = 32 / SL;  // step groups a warp
  __shared__ float part[2][A_MAXW][SL];
  __shared__ float npart[2][A_MAXW];
  const int lane = threadIdx.x;  // slice lane
  const int g = threadIdx.y;     // step group
  const int G = blockDim.y;
  const int warp = (g * SL + lane) >> 5;
  const int nwarps = (G * SL) >> 5;
  const int s = blockIdx.x * SL + lane;
  const bool live = s < ns;
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float toff = 0.5f * static_cast<float>(nt - 1);
  const int rays = na * nt;
  int prev_rd = -1, buf = 0;
  Ray next = fetch_ray(order[0], tab, b, nt, rays, ns, s, live);
  for (int k = 0; k < count; ++k) {
    const Ray ray = next;
    const int r_next = k + 1 < count ? order[k + 1] : -1;
    if (ray.r < 0) {  // uniform over the block
      next = fetch_ray(r_next, tab, b, nt, rays, ns, s, live);
      continue;
    }
    const int a = ray.r / nt;
    const int j = ray.r - a * nt;
    const float4 ang = ray.ang;
    const bool rd = ang.z != 0.f;
    if (prev_rd >= 0 && static_cast<int>(rd) != prev_rd) __syncthreads();
    prev_rd = rd;
    const float tj = __fsub_rn(static_cast<float>(j), toff);
    const float cs = fabsf(ang.x) < 1e-8f ? 1.f : ang.x;
    const float ss = fabsf(ang.y) < 1e-8f ? 1.f : ang.y;
    const float t1 = rd ? __fdiv_rn(tj, cs) : __fdiv_rn(tj, ss);
    const float sh = rd ? __fdiv_rn(-ang.y, cs) : __fdiv_rn(ang.x, ss);
    const float scale =
        __fdiv_rn(1.f, fmaxf(fabsf(rd ? ang.x : ang.y), 1e-8f));

    Tap tp[A_K];
    float v0[A_K], v1[A_K];
#pragma unroll
    for (int q = 0; q < A_K; ++q) {
      const int m = g + q * G;
      v0[q] = v1[q] = 0.f;
      tp[q] = ray_tap(rd, t1, sh, scale, ctr, m < n ? m : 0, n);
      if (m < n && live) {
        v0[q] = x[static_cast<size_t>(tp[q].p0) * ns + s];
        v1[q] = x[static_cast<size_t>(tp[q].p1) * ns + s];
      }
    }
    float dot = 0.f, nsq = 0.f;
#pragma unroll
    for (int q = 0; q < A_K; ++q) {
      if (g + q * G < n) {
        dot = __fadd_rn(dot, __fadd_rn(__fmul_rn(v0[q], tp[q].w0),
                                       __fmul_rn(v1[q], tp[q].w1)));
        nsq = __fadd_rn(nsq, __fadd_rn(__fmul_rn(tp[q].w0, tp[q].w0),
                                       __fmul_rn(tp[q].w1, tp[q].w1)));
      }
    }
    // butterfly over the Q step lanes of the warp (lanes lane + SL q):
    // every lane ends with the same sum
#pragma unroll
    for (int o = SL; o < 32; o <<= 1) {
      dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, o));
      nsq = __fadd_rn(nsq, __shfl_xor_sync(0xffffffffu, nsq, o));
    }
    if (g % Q == 0) {  // step lane 0 of the warp
      part[buf][warp][lane] = dot;
      if (lane == 0) npart[buf][warp] = nsq;
    }
    __syncthreads();
    next = fetch_ray(r_next, tab, b, nt, rays, ns, s, live);
    dot = part[buf][0][lane];
    nsq = npart[buf][0];
    for (int w = 1; w < nwarps; ++w) {
      dot = __fadd_rn(dot, part[buf][w][lane]);
      nsq = __fadd_rn(nsq, npart[buf][w]);
    }
    buf ^= 1;
    const float coeff = __fdiv_rn(__fmul_rn(beta, __fsub_rn(ray.bv, dot)),
                                  fmaxf(nsq, 1e-12f));
    if (!live) continue;
#pragma unroll
    for (int q = 0; q < A_K; ++q) {
      if (g + q * G >= n) continue;
      const float n0 = __fadd_rn(v0[q], __fmul_rn(coeff, tp[q].w0));
      if (tp[q].p1 == tp[q].p0) {
        x[static_cast<size_t>(tp[q].p0) * ns + s] =
            __fadd_rn(n0, __fmul_rn(coeff, tp[q].w1));
      } else {
        x[static_cast<size_t>(tp[q].p0) * ns + s] = n0;
        x[static_cast<size_t>(tp[q].p1) * ns + s] =
            __fadd_rn(v1[q], __fmul_rn(coeff, tp[q].w1));
      }
    }
  }
}

template <int SL>
int launch(float* x, const float* b, const float4* tab, const int* order,
           int count, float beta, int n, int nt, int na, int ns,
           cudaStream_t st) {
  constexpr int Q = 32 / SL;
  const int warps = (n + Q * A_K - 1) / (Q * A_K);
  if (warps > A_MAXW) return cudaErrorInvalidValue;
  const dim3 block(SL, Q * warps);
  const dim3 grid((ns + SL - 1) / SL);
  art_sweep_kernel<SL><<<grid, block, 0, st>>>(x, b, tab, order, count,
                                               beta, n, nt, na, ns);
  return tj::launch_error();
}

}  // namespace

// The largest N a sweep with `slices` slices a block takes (0: no such
// instantiation): A_MAXW warps of 32 / slices step groups, A_K steps each.
TJ_API int tj_art_max_n(int slices) {
  if (slices != 1 && slices != 2 && slices != 4 && slices != 8 &&
      slices != 16) {
    return 0;
  }
  return A_MAXW * (32 / slices) * A_K;
}

// One ART sweep in place on x (N, N, Ns): b (Na, Nt, Ns); tab (Na, 4)
// floats {cos, sin, row_driven, 0}; order `count` rays on the device;
// slices 1, 2, 4, 8 or 16 a block.
TJ_API int tj_art_sweep(float* x, const float* b, const float* tab,
                        const int* order, int count, float beta, int n,
                        int nt, int na, int ns, int slices, void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || count <= 0 ||
      n > tj_art_max_n(slices)) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* t = reinterpret_cast<const float4*>(tab);
  switch (slices) {
    case 1:
      return launch<1>(x, b, t, order, count, beta, n, nt, na, ns, st);
    case 2:
      return launch<2>(x, b, t, order, count, beta, n, nt, na, ns, st);
    case 4:
      return launch<4>(x, b, t, order, count, beta, n, nt, na, ns, st);
    case 8:
      return launch<8>(x, b, t, order, count, beta, n, nt, na, ns, st);
    default:
      return launch<16>(x, b, t, order, count, beta, n, nt, na, ns, st);
  }
}
