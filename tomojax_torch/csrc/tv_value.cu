// K5 -- replaces tomojax/tv/pallas_tv_value.py:_tv_value_kernel.
//
// Isotropic TV value with periodic wrap on all three axes,
//   sum sqrt(1e-6 + (x - x[i0+1])^2 + (x - x[i1+1])^2 + (x - x[i2+1])^2),
// of a contiguous (n0, n1, n2) f32 volume (the FISTA metric), or summed over
// the elements of a (nel, n0, n1, n2) stack in one launch, as the Pallas
// kernel's grid takes them. On a slab of a z-sharded volume (HALO) the
// axis-2 neighbour of the last slice is the right rank's first slice, a
// (n0, n1) halo plane, instead of the in-slab wrap; the caller all-reduces
// the slab's sum.
//
// Bound on the H100: one streaming pass (64 MiB at 256^3). The kernel
// marches along axis 0 (tv_march.cuh) as K7 does, but V_STEP planes a
// barrier: each plane of x is staged once with its periodic halo, whole
// steps ahead and all of it asynchronously (16-byte copies where n2 % 4 ==
// 0 and 4-byte copies of the cells they do not bring: the wrap or the halo
// plane's column, every cell otherwise), so no thread waits for a load of
// its own; each voxel's term reads its +1 neighbours from the staged
// planes. The term is K7's denominator D (tj::denom), so it equals the
// plain version's term bit for bit. Each thread adds its terms in a
// register in plane order, each block adds its threads once at the end of
// its chunk (tj::march_block_sum) into one partial, and tj::sum_partials
// adds the partials in a fixed order: no float atomics, so repeated runs
// give identical metrics.
#include "tv_march.cuh"

namespace {

using tj::TV_NT;
using tj::TV_T2;
constexpr int SUM_NT = 1024;
// One term a voxel is little work for a barrier, so a march step takes
// V_STEP planes: the planes of V_GROUPS steps share a ring, one step's in
// use, the next step's first plane read too, the rest in flight.
constexpr int V_STEP = 4;
constexpr int V_GROUPS = 4;
constexpr int V_RING = V_STEP * V_GROUPS;
static_assert(tj::TV_C % V_STEP == 0, "a chunk is whole steps");
static_assert(V_GROUPS >= 3, "a step in use, the next one read");

// Start a 4-byte copy of box cell `s` of the plane at x + plane_off (hi +
// halo_off: the halo plane's row 0 of that plane) into `dst`; zeros where
// the cell reads nothing.
__device__ __forceinline__ void copy_cell(float* dst, const tj::BoxCell& s,
                                          const float* x, const float* hi,
                                          size_t plane_off, size_t halo_off) {
  const bool vol = s.src == tj::BOX_VOL;
  const bool in = vol || (s.src == tj::BOX_HI && hi != nullptr);
  const float* src = vol ? x + plane_off + s.off
                     : in ? hi + halo_off + s.off : x;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tj::tv_smem(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

// x: nel elements of (n0, n1, n2); hi: their (n0, n1) planes above slice
// n2 - 1 (HALO only). The grid's z takes `chunks` chunks an element.
template <bool HALO, bool VEC>
__global__ void __launch_bounds__(TV_NT, tj::TV_MIN_BLOCKS)
tv_value_kernel(const float* __restrict__ x, const float* __restrict__ hi,
                float* __restrict__ partials, int n0, int n1, int n2,
                int chunks) {
  using B = tj::TvBox<float>;
  using S = tj::PlaneSlot<float, 0>;
  __shared__ __align__(16) unsigned char ring[V_RING * S::BYTES];
  __shared__ float warps[TV_NT / 32];
  const int tx = threadIdx.x % TV_T2, ty = threadIdx.x / TV_T2;
  const int c0 = blockIdx.x * TV_T2, r0 = blockIdx.y * tj::TV_T1;
  const int e = blockIdx.z / chunks;
  const int i_s = (blockIdx.z - e * chunks) * tj::TV_C;
  const int i_e = min(n0, i_s + tj::TV_C);
  const int c = c0 + tx;
  const size_t plane = static_cast<size_t>(n1) * n2;
  x += static_cast<size_t>(e) * n0 * plane;
  if (HALO) hi += static_cast<size_t>(e) * n0 * n1;
  // the cells the 16-byte copies do not bring (VEC: the column after the
  // tile, the wrap or the halo plane; the column before it is never read)
  using Cells = tj::CellSet<VEC, true, HALO>;
  Cells cells;
  cells.init(r0, c0, n1, n2);
  if (VEC) cells.live[0] = cells.live[0] && !cells.lo_side;
  // ring slot k: plane i_s + V_STEP j + q of step j sits in slot
  // (j % V_GROUPS) V_STEP + q
  auto buf = [&](int k) {
    return reinterpret_cast<float*>(ring + k * S::BYTES);
  };
  tj::PlaneCopy cps[S::COPIES];
#pragma unroll
  for (int j = 0; j < S::COPIES; ++j) {
    cps[j] = tj::plane_copy<float, 0, true>(threadIdx.x + j * TV_NT, r0, c0,
                                            n1, n2, c0 == 0,
                                            n2 <= c0 + TV_T2);
  }
  const void* const ops[1] = {x};
  // the planes of step j (n0 wraps to 0), one copy group; planes past the
  // chunk's last + 1 are not needed
  auto stage_step = [&](int j) {
#pragma unroll
    for (int q = 0; q < V_STEP; ++q) {
      const int p = i_s + j * V_STEP + q;
      if (p > i_e) break;
      const size_t at = (p >= n0 ? p - n0 : p) * plane;
      const size_t hat = (p >= n0 ? p - n0 : p) * static_cast<size_t>(n1);
      unsigned char* dst = ring + (j % V_GROUPS * V_STEP + q) * S::BYTES;
      if (VEC) tj::copy_plane<float, 0>(dst, cps, ops, at, true, -1);
#pragma unroll
      for (int s = 0; s < Cells::N; ++s) {
        if (cells.live[s]) {
          copy_cell(reinterpret_cast<float*>(dst) +
                        B::at(cells.cell[s].a, cells.cell[s].b),
                    cells.cell[s], x, hi, at, hat);
        }
      }
    }
    tj::tv_commit();
  };

#pragma unroll
  for (int j = 0; j < V_GROUPS - 1; ++j) stage_step(j);
  constexpr int ROWS = tj::TV_ROWS, TY = tj::TV_TY;
  int o[ROWS];
  bool in[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    o[r] = B::at(ty + TY * r + 1, tx + 1);
    in[r] = r0 + ty + TY * r < n1 && c < n2;
  }
  float acc = 0.f;
  // step j: planes i0 .. i0 + V_STEP - 1 from them and plane i0 + V_STEP
  // (the next step's first); the copies of step j + V_GROUPS - 1 take the
  // slots of step j - 1, which every thread has left behind the barrier
  for (int j = 0, i0 = i_s; i0 < i_e; ++j, i0 += V_STEP) {
    tj::tv_wait<V_GROUPS - 3>();
    __syncthreads();
    stage_step(j + V_GROUPS - 1);
    const int k0 = j % V_GROUPS * V_STEP;
    const int k1 = (j + 1) % V_GROUPS * V_STEP;  // plane i0 + V_STEP
    float cv[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) cv[r] = buf(k0)[o[r]];
#pragma unroll
    for (int q = 0; q < V_STEP; ++q) {
      if (i0 + q < i_e) {
        const float* X = buf(k0 + q);
        const float* Xn = buf(q + 1 < V_STEP ? k0 + q + 1 : k1);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float nv = Xn[o[r]];
          if (in[r]) {
            acc = __fadd_rn(acc, tj::denom(cv[r], nv, X[o[r] + B::W],
                                           X[o[r] + 1]));
          }
          cv[r] = nv;
        }
      }
    }
  }
  const float total = tj::march_block_sum(acc, warps);
  if (threadIdx.x == 0) {
    partials[(static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                 gridDim.x + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(SUM_NT)
sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
           int count) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += SUM_NT) acc += partials[i];
  __shared__ float buf[SUM_NT];
  const float total = tj::block_sum<SUM_NT>(acc, buf);
  if (threadIdx.x == 0) out[0] = total;
}

// The march's grid with nel elements' chunks along z; z = 0 if it is not
// a grid the card takes.
dim3 value_grid(int nel, int n0, int n1, int n2) {
  dim3 g = tj::march_grid(n0, n1, n2);
  const bool ok = nel > 0 && tj::march_ok(n0, n1, n2) &&
                  static_cast<long long>(nel) * g.z <= 65535;
  g.z = ok ? nel * g.z : 0;
  return g;
}

}  // namespace

namespace tj {

cudaError_t sum_partials(const float* partials, float* out, int count,
                         cudaStream_t stream) {
  if (count <= 0) return cudaErrorInvalidValue;
  sum_kernel<<<1, SUM_NT, 0, stream>>>(partials, out, count);
  return cudaGetLastError();
}

}  // namespace tj

// The partials K5 writes for nel elements of (n0, n1, n2): one a block of
// the march's grid, element by element (tv/march.py value_partials).
TJ_API int tj_tv_value_partials(int nel, int n0, int n1, int n2) {
  const dim3 g = value_grid(nel, n0, n1, n2);
  return static_cast<int>(g.x * g.y * g.z);
}

// x: nel contiguous (n0, n1, n2) elements; partials:
// tj_tv_value_partials(nel, n0, n1, n2) floats of scratch; out: 1 float,
// the sum over the elements. hi: null (periodic wrap on axis 2) or the
// elements' (n0, n1) planes above slice n2 - 1.
TJ_API int tj_tv_value(const float* x, const float* hi, float* partials,
                       float* out, int nel, int n0, int n1, int n2,
                       void* stream) {
  const dim3 grid = value_grid(nel, n0, n1, n2);
  if (grid.z == 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int chunks = static_cast<int>(grid.z) / nel;
  const bool vec = n2 % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  auto kernel = hi != nullptr ? (vec ? tv_value_kernel<true, true>
                                     : tv_value_kernel<true, false>)
                              : (vec ? tv_value_kernel<false, true>
                                     : tv_value_kernel<false, false>);
  kernel<<<grid, TV_NT, 0, st>>>(x, hi, partials, n0, n1, n2, chunks);
  const int err = tj::launch_error();
  if (err != 0) return err;
  return static_cast<int>(tj::sum_partials(
      partials, out, static_cast<int>(grid.x * grid.y * grid.z), st));
}
