// A1 -- the ART (row-action Kaczmarz) sweep of
// tomojax/solvers/iterative.py:art_sweep. The reference runs it as an XLA
// lax.scan of one ray a step, not as a Pallas kernel; in plain PyTorch a
// ray costs about 20 launches (460,000 a sweep at 256^2 x 90), so the port
// runs the whole sweep in one launch. For k = 0, 1, ... with ray
// r = order[k] (angle a = r / Nt, bin j = r % Nt), for every slice s:
//   pos_m  = t_j / c + (ctr - m) sh + ctr,  sh = -s / c   row-driven, or
//            ctr - t_j / s + (m - ctr) sh,  sh = c / s    column-driven,
//   w0, w1 = the two hat taps of step m, scaled by 1/max(|c| or |s|, 1e-8),
//            out-of-range taps weighted 0 and their index clipped,
//   dot    = sum_m (x[p0] w0 + x[p1] w1),  nsq = sum_m (w0^2 + w1^2),
//   coeff  = beta (b[a, j, s] - dot) / max(nsq, 1e-12),
//   x[p0] += coeff w0, then x[p1] += coeff w1,
// with p = (m, i) for row-driven rays (step m walks row m) and (i, m) for
// column-driven ones (column m). Slice-last layouts: x (N, N, Ns),
// b (Na, Nt, Ns). The arithmetic of the positions, the weights and the
// updates is rounded as the plain version (cuda_art.art_sweep_sl_ref)
// rounds it, one operation at a time (__f*_rn: no FMA contraction); the
// angle's divisor, sh and scale come from cuda_art.art_table, which the
// plain version computes its taps from. Only the order of the dot's and
// nsq's sums differs from it.
//
// Why no atomics: slices are independent, so a block owns SL consecutive
// slices and walks every ray of the order itself. Within a ray, step m
// touches only row m (row-driven) or column m (column-driven), and each
// step belongs to one step group (g takes m = g, g + G, ...): no two
// threads write one pixel of a slice in a ray. The two taps of a step share
// a pixel only where one was clipped (weight 0); its thread then adds both
// in the reference's order. From one ray to the next a pixel keeps its
// owner while the driving axis stays the same; where it changes the block
// waits at a barrier before the next ray's reads. dot and nsq are summed in
// a fixed order (a thread's steps as a tree, a butterfly over the step
// groups of a warp, then the warps in order), so two sweeps agree bit for
// bit.
//
// Layout (art.cuh Cfg): a thread holds VS = min(SL, 4) slices of a pixel
// as one vector (L = SL / VS threads a step group, threadIdx.x);
// threadIdx.y is the step group; a warp holds Q = 32 / L step groups, a
// block as many warps as N needs at KS steps a thread (1 up to 4 slices a
// block, else 2; at most W warps; above that 4, or 8 at one slice a
// block). 2 slices a block (cuda_art.ART_SLICES) is the fastest at 256^3.
//
// The schedule (carry and prefetch). Where ray r + 1 of the order keeps
// r's driving axis (the next bin of the angle, or any ray of that axis),
// step m of both rays belongs to the same thread, and r writes only its own
// two pixels of row (column) m. So each thread computes r + 1's taps and
// loads those of its pixels that r does not write before r's stores; after
// r's update it takes the others (the pixels r + 1 shares with r, clipped
// taps included) from its registers, and a pixel that r + 1 keeps is not
// stored by r but by the ray that lets it go. A ray that changes the axis,
// or follows an out-of-range entry, fetches its pixels after r's stores
// (on a change of axis after a barrier). The order, b and each ray's row of
// cuda_art.art_table are staged A_R rays ahead into rings in shared memory
// with cp.async (the order entry 2 A_R ahead), and the pixels of ray r +
// A_D that r + A_D - 1 did not take are prefetched into L2. The next ray's
// loads are issued after the ray's shuffles and its partials' stores, the
// prefetch after the partials' loads, so that those shared-memory and
// shuffle operations do not queue behind them. An order entry outside [0,
// Na Nt) leaves x as it was.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): the
// function moves x once each way (0.05 ms at 256^3 x 90) and does 12 GFLOP
// (0.18 ms); rereading each ray's 2N pixels from device memory would take
// 7.2 ms. The sweep is one dependent chain of Na Nt rays a block. Loading
// every ray's pixels after the previous ray's stores (8 slices a block) took
// 2.57 us a ray, 59.2 ms a sweep; split by variants of that kernel: the
// loads 1390 cycles a ray, the block sum 1055, the stores 1479 (each ray's
// loads waited for the last ray's stores). This design takes 1.05 us a ray,
// 24.1 ms a sweep angle-major and 36.7 in a random order (2 slices a block).
// What binds it now is the chain itself: without any traffic of x (the CHAIN
// variant) a ray takes 0.62 us, 14.3 ms a sweep; by clock64 phase about
// 2,060 cycles a ray, the dot and the butterfly about 350, the block sum
// about 380, the coefficient and the update about 460, the staging, the next
// ray's taps and loads and the prefetch about 790 together. The rest is the
// memory pipeline, which every step's scattered access costs a line of:
// about 3.5 N lines a ray a block (the loads, the stores and the prefetch,
// 1.15 N each), whatever the slices a block. Splitting a ray's steps across
// the SMs of a cluster would cut the lines an SM but add a cluster barrier
// and remote partials to every ray (K8's step pays about 2,200 cycles for
// its partials, PERF.md).

#include "art.cuh"

using namespace tj_art;

// The largest N a sweep with `slices` slices a block takes (0: no such
// instantiation).
TJ_API int tj_art_max_n(int slices) { return max_n(slices); }

// One ART sweep in place on x (N, N, Ns): b (Na, Nt, Ns); rtab (Na Nt, 4)
// floats {t1, sh, scale, row_driven} per ray (cuda_art.art_table); order
// `count` rays on the device; slices 1, 2, 4, 8 or 16 a block.
TJ_API int tj_art_sweep(float* x, const float* b, const float* rtab,
                        const int* order, int count, float beta, int n,
                        int rays, int ns, int slices, void* stream) {
  if (!valid(rtab, count, n, rays, ns, slices)) return cudaErrorInvalidValue;
  return launch_sl<FULL>(slices, x, b, reinterpret_cast<const float4*>(rtab),
                         order, count, beta, n, rays, ns, nullptr,
                         static_cast<cudaStream_t>(stream));
}
