// Experiment SART sweep E4, the counterpart of the TPU kernel
// scripts/exp_sart_pipeline.py:_resident_kernel (res: TAPS_BF16, reshbm:
// TABLE_BF16; TAPS_F32 beside K8): the cluster-resident sweep of
// sart_resident.cuh in the experiment modes (exp_sart.cuh SartTaps), at a
// chosen cluster shape (blocks, sb): 8 or 16 blocks (bands of rows) a
// cluster, 1, 2 or 4 slices a pixel (float, float2, float4). E4 is the
// shape instrument beside E3 (exp_sart.cu), which runs K8's (8, 4):
//   * fewer slices a cluster give more clusters (Ns / sb) for the card's
//     132 SMs and less shared memory a block (two blocks an SM where the
//     registers allow), at the cost of more walks per voxel;
//   * 16 blocks halve a band's rows, and so the column-driven chains (139
//     steps at 76 degrees and N = 256 for 8 blocks), and make 512^2
//     resident at sb = 1 and 2 (216,064 B a block at (16, 2)); a cluster of
//     16 is non-portable (allowed per kernel, at most one a GPC).
// A shape whose block does not fit the card's 227 KB, or a cluster the card
// refuses, fails the launch: E4 never runs another shape or route in its
// place. Each bound as K8's: shared-memory reads of the FP and the update
// and a cluster barrier a step.
#include "exp_sart.cuh"

namespace {

using namespace tj::xp;

template <int MODE, int BLOCKS, int SB>
int run_shape(const SweepArgs& g) {
  return tj::sr::resident_sweep<SartTaps<MODE>, BLOCKS, SB, false>(
      g.x, g.ft, g.bt, g.b, g.inv_row, g.inv_col_a, g.beta, g.order,
      g.steps, g.out, g.n, g.nt, g.na, g.ns, nullptr, g.tb, g.st);
}

template <int MODE>
int run_mode(const SweepArgs& g, int blocks, int sb) {
  if (blocks == 8 && sb == 4) return e3_resident(MODE, g, nullptr);
  if (blocks == 8 && sb == 2) return run_shape<MODE, 8, 2>(g);
  if (blocks == 8 && sb == 1) return run_shape<MODE, 8, 1>(g);
  if (blocks == 16 && sb == 4) return run_shape<MODE, 16, 4>(g);
  if (blocks == 16 && sb == 2) return run_shape<MODE, 16, 2>(g);
  if (blocks == 16 && sb == 1) return run_shape<MODE, 16, 1>(g);
  return cudaErrorInvalidValue;
}

template <int MODE, int BLOCKS, int SB>
int clusters_shape(int n, int nt, int ns, int* clusters) {
  return tj::sr::active_clusters<SartTaps<MODE>, BLOCKS, SB>(n, nt, ns,
                                                             clusters);
}

template <int MODE>
int clusters_mode(int n, int nt, int ns, int blocks, int sb, int* clusters) {
  if (blocks == 8 && sb == 4) {
    return e3_active_clusters(MODE, n, nt, ns, clusters);
  }
  if (blocks == 8 && sb == 2) {
    return clusters_shape<MODE, 8, 2>(n, nt, ns, clusters);
  }
  if (blocks == 8 && sb == 1) {
    return clusters_shape<MODE, 8, 1>(n, nt, ns, clusters);
  }
  if (blocks == 16 && sb == 4) {
    return clusters_shape<MODE, 16, 4>(n, nt, ns, clusters);
  }
  if (blocks == 16 && sb == 2) {
    return clusters_shape<MODE, 16, 2>(n, nt, ns, clusters);
  }
  if (blocks == 16 && sb == 1) {
    return clusters_shape<MODE, 16, 1>(n, nt, ns, clusters);
  }
  return cudaErrorInvalidValue;
}

bool shape_ok(int n, int nt, int ns, int blocks, int sb) {
  return n > 0 && nt > 0 && ns > 0 && (blocks == 8 || blocks == 16) &&
         (sb == 1 || sb == 2 || sb == 4) &&
         tj::sr::resident_fits(n, nt, blocks, sb);
}

}  // namespace

// E4: one sweep as tj_exp_sart_sweep's (its operands; no scratch) in one
// launch at cluster shape (blocks, sb) in mode TAPS_F32, TAPS_BF16 or
// TABLE_BF16. A shape outside {8, 16} x {1, 2, 4}, or whose block does not
// fit the card's shared memory, returns cudaErrorInvalidValue.
TJ_API int tj_exp_sart_resident(int mode, const float* x,
                                const float* fp_tab, const float* bp_tab,
                                const float* b, const float* inv_row,
                                const float* inv_col_a, const float* beta,
                                const int* order, int steps, float* out,
                                const int* fp_i0, const void* fp_w,
                                const int* bp_j0, const void* bp_w, int n,
                                int nt, int na, int ns, int blocks, int sb,
                                void* stream) {
  const SweepArgs g{x, reinterpret_cast<const float4*>(fp_tab),
                    reinterpret_cast<const float4*>(bp_tab), b, inv_row,
                    inv_col_a, beta, order, steps,
                    {fp_i0, static_cast<const __nv_bfloat162*>(fp_w), bp_j0,
                     static_cast<const __nv_bfloat162*>(bp_w)},
                    out, n, nt, na, ns, static_cast<cudaStream_t>(stream)};
  if (na <= 0 || steps <= 0 || !shape_ok(n, nt, ns, blocks, sb) ||
      (mode == TABLE_BF16 && !(fp_i0 && fp_w && bp_j0 && bp_w))) {
    return cudaErrorInvalidValue;
  }
  switch (mode) {
    case TAPS_F32: return run_mode<TAPS_F32>(g, blocks, sb);
    case TAPS_BF16: return run_mode<TAPS_BF16>(g, blocks, sb);
    case TABLE_BF16: return run_mode<TABLE_BF16>(g, blocks, sb);
    default: return cudaErrorInvalidValue;
  }
}

// *clusters: how many clusters of the E3 (blocks 8, sb 4: any mode) or E4
// launch the card holds at once (cudaOccupancyMaxActiveClusters) at this
// shape; 0 means the card cannot launch it.
TJ_API int tj_exp_sart_active_clusters(int mode, int n, int nt, int ns,
                                       int blocks, int sb, int* clusters) {
  if (!shape_ok(n, nt, ns, blocks, sb)) return cudaErrorInvalidValue;
  if (blocks == 8 && sb == 4) {
    return e3_active_clusters(mode, n, nt, ns, clusters);
  }
  switch (mode) {
    case TAPS_F32:
      return clusters_mode<TAPS_F32>(n, nt, ns, blocks, sb, clusters);
    case TAPS_BF16:
      return clusters_mode<TAPS_BF16>(n, nt, ns, blocks, sb, clusters);
    case TABLE_BF16:
      return clusters_mode<TABLE_BF16>(n, nt, ns, blocks, sb, clusters);
    default: return cudaErrorInvalidValue;
  }
}
