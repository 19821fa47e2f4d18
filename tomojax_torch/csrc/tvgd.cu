// K7 -- replaces tomojax/tv/pallas_tvgd.py:_grad_kernel (HALO false).
// K9c -- replaces tomojax/tv/pallas_tvgd_sharded.py:_grad_kernel_halo
// (HALO true): the same body on a slab of a z-sharded volume, whose axis-2
// neighbours below slice 0 and above slice n2 - 1 come from the ring's
// halo planes instead of the in-slab wrap. Its g equals K7's on the whole
// volume bit for bit; its ||g||^2 is the slab's partial, which the caller
// all-reduces.
//
// The 4-term isotropic TV subgradient with periodic wrap on all three axes
// (tomojax/tv/__init__.py:_tv_grad) of a contiguous (n0, n1, n2) f32
// volume, plus ||g||^2. In the port's slice-last layout (N, N, Ns) the
// reference's axes map as i (slices) -> axis 2, j (rows) -> axis 0,
// k (columns) -> axis 1. With D(v) = sqrt(eps + (x_v - x_{v+i})^2 +
// (x_v - x_{v+j})^2 + (x_v - x_{v+k})^2),
//   g = (3 x - x_{+i} - x_{+j} - x_{+k}) / D(v)
//     + (x - x_{-i}) / D(v-i) + (x - x_{-j}) / D(v-j) + (x - x_{-k}) / D(v-k).
// Every sum and product is rounded as the reference writes it (slice term,
// then row, then column), with round-to-nearest intrinsics, so no FMA
// contraction moves the kernel off its plain version.
//
// Bound on the H100: one streaming pass over x (64 MiB at 256^3) and one
// over g. The kernel marches along axis 0 (tv_march.cuh): each plane of x
// is staged once with its periodic halo (or the halo planes; 16-byte
// copies two planes ahead where n2 % 4 == 0), D is computed
// once a voxel on the tile plus one row and one column (one square root a
// voxel plus the halo), and g reads D(v-i), D(v-k) from shared memory and
// D(v-j), x_{-j} from the registers that held them a plane earlier. D(v-i)
// is the denominator voxel v-i computes for itself, so g is the same value
// the per-voxel form computes. Each block adds its g^2 in a fixed order to
// a partials buffer, and tj::sum_partials adds the partials in a fixed
// order: no float atomics, so ||g||^2 repeats bit for bit and the descent
// loop never reads it on the host.
//
// tj_tv_step is the descent step x - dpocs g / sqrt(||g||^2) (then the
// positivity clamp on the last step), one elementwise pass with dpocs and
// ||g||^2 read from device memory. The TPU had no kernel for it: XLA fused
// the step (tomojax/tv/pallas_tvgd.py:tv_gd_pallas).
#include "tv_march.cuh"

namespace {

using tj::TV_NT;
using tj::TV_R2;
using tj::TV_REG;
using tj::TV_T2;
using tj::denom;  // D at a voxel from its +i, +j, +k neighbours

// lo, hi: (n0, n1) planes at slices -1 and n2 (HALO only). VEC: x's rows
// are 16-byte aligned (n2 % 4 == 0), so planes arrive as 16-byte chunks.
template <bool HALO, bool VEC>
__global__ void __launch_bounds__(TV_NT, tj::TV_MIN_BLOCKS)
tv_grad_kernel(const float* __restrict__ x, const float* __restrict__ lo,
               const float* __restrict__ hi, float* __restrict__ g,
               float* __restrict__ partials, int n0, int n1, int n2) {
  using B = tj::TvBox<float>;
  using S = tj::PlaneSlot<float, 0>;
  __shared__ __align__(16) unsigned char ring[tj::TV_RING * S::BYTES];
  __shared__ float ds[TV_REG];  // D of plane i0 on the region
  __shared__ float warps[TV_NT / 32];
  const int tx = threadIdx.x % TV_T2, ty = threadIdx.x / TV_T2;
  const int c0 = blockIdx.x * TV_T2, r0 = blockIdx.y * tj::TV_T1;
  const int i_s = blockIdx.z * tj::TV_C;
  const int i_e = min(n0, i_s + tj::TV_C);
  const int c = c0 + tx;
  const size_t plane = static_cast<size_t>(n1) * n2;
  using Cells = tj::CellSet<VEC, true, HALO>;
  Cells cells;
  cells.init(r0, c0, n1, n2);
  float v[2][Cells::N];  // the cells of two planes in flight (tj::Set)
  auto wrap = [&](int p) { return p < 0 ? p + n0 : (p >= n0 ? p - n0 : p); };
  auto slot = [&](int p) {
    return ring + (p - i_s + 1) % tj::TV_RING * S::BYTES;
  };
  auto buf = [&](int p) { return reinterpret_cast<float*>(slot(p)); };
  // both halo columns come from the cells
  tj::PlaneCopy cps[S::COPIES];
#pragma unroll
  for (int j = 0; j < S::COPIES; ++j) {
    cps[j] = tj::plane_copy<float, 0, true>(threadIdx.x + j * TV_NT, r0, c0,
                                            n1, n2, c0 == 0,
                                            n2 <= c0 + TV_T2);
  }
  const void* const ops[1] = {x};
  // planes past the chunk's last + 1 are not needed: an empty group
  auto stage_async = [&](int p) {
    if (VEC && p <= i_e) {
      tj::copy_plane<float, 0>(slot(p), cps, ops, wrap(p) * plane, true, -1);
    }
    tj::tv_commit();
  };
  auto fetch = [&](int p, auto set) {
    constexpr int k = decltype(set)::value;
    const size_t q = wrap(p);
#pragma unroll
    for (int s = 0; s < Cells::N; ++s) {
      if (cells.live[s]) {
        v[k][s] = tj::cell_fetch(cells.cell[s], x, lo, hi, q * plane,
                                   q * n1);
      }
    }
  };
  auto put = [&](int p, auto set) {
    constexpr int k = decltype(set)::value;
    float* b = buf(p);
#pragma unroll
    for (int s = 0; s < Cells::N; ++s) {
      if (cells.live[s]) {
        b[B::at(cells.cell[s].a, cells.cell[s].b)] = v[k][s];
      }
    }
  };
  constexpr int ROWS = tj::TV_ROWS, TY = tj::TV_TY, NR = tj::TV_RCELLS;
  // the region (box rows 0..TV_T1, columns 0..TV_T2: the tile and one row
  // and one column before it), NR cells a thread at most
  int rb[NR];
#pragma unroll
  for (int m = 0; m < NR; ++m) {
    const int e = threadIdx.x + m * TV_NT;
    rb[m] = B::at(e / TV_R2, e % TV_R2);
  }

  stage_async(i_s - 1);
  stage_async(i_s);
  stage_async(i_s + 1);
  stage_async(i_s + 2);
  tj::tv_wait<2>();
  fetch(i_s - 1, tj::Set0{});
  fetch(i_s, tj::Set1{});
  put(i_s - 1, tj::Set0{});
  put(i_s, tj::Set1{});
  fetch(i_s + 1, tj::Set1{});  // the loop's steps take sets 1, 0, 1, ...
  if (i_s + 2 <= i_e) fetch(i_s + 2, tj::Set0{});  // n0 = 1: no plane 2
  __syncthreads();
  // x and D one plane below each voxel of this thread (rows ty + TY j)
  float x_jm[ROWS], d_jm[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const float* Xm = buf(i_s - 1);
    const int o = B::at(ty + TY * j + 1, tx + 1);
    x_jm[j] = Xm[o];
    d_jm[j] = denom(Xm[o], Xm[o + 1], buf(i_s)[o], Xm[o + B::W]);
  }
  float gsq = 0.f;
  // plane i0: its cells of plane i0 + 1 come from `set`, which then takes
  // plane i0 + 3's
  auto step = [&](int i0, auto set) {
    const size_t at = i0 * plane + static_cast<size_t>(r0 + ty) * n2 + c;
    tj::tv_wait<1>();
    put(i0 + 1, set);
    __syncthreads();
    stage_async(i0 + 3);
    if (i0 + 3 <= i_e) fetch(i0 + 3, set);
    const float* X = buf(i0);
    const float* Xn = buf(i0 + 1);
#pragma unroll
    for (int m = 0; m < NR; ++m) {
      const int e = threadIdx.x + m * TV_NT, b = rb[m];
      if (m == 0 || e < TV_REG) {
        ds[e] = denom(X[b], X[b + 1], Xn[b], X[b + B::W]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int o = B::at(ty + TY * j + 1, tx + 1);  // the voxel in the box
      const int q = (ty + TY * j + 1) * TV_R2 + tx + 1;  // in the region
      const float cv = X[o];
      const float d = ds[q];
      if (r0 + ty + TY * j < n1 && c < n2) {
        const float num = __fsub_rn(
            __fsub_rn(__fsub_rn(__fmul_rn(3.f, cv), X[o + 1]), Xn[o]),
            X[o + B::W]);
        float gv = __fdiv_rn(num, d);
        gv = __fadd_rn(gv, __fdiv_rn(__fsub_rn(cv, X[o - 1]), ds[q - 1]));
        gv = __fadd_rn(gv, __fdiv_rn(__fsub_rn(cv, x_jm[j]), d_jm[j]));
        gv = __fadd_rn(gv, __fdiv_rn(__fsub_rn(cv, X[o - B::W]),
                                     ds[q - TV_R2]));
        g[at + static_cast<size_t>(TY * j) * n2] = gv;
        gsq = __fadd_rn(gsq, __fmul_rn(gv, gv));
      }
      x_jm[j] = cv;
      d_jm[j] = d;
    }
  };
  for (int i0 = i_s; i0 < i_e; i0 += 2) {
    step(i0, tj::Set1{});
    if (i0 + 1 < i_e) step(i0 + 1, tj::Set0{});
  }
  const float total = tj::march_block_sum(gsq, warps);
  if (threadIdx.x == 0) {
    partials[(static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                 gridDim.x + blockIdx.x] = total;
  }
}

// out = x - (dpocs g) / sqrt(gsq), rounded as the PyTorch expression
// x - dpocs * g / torch.sqrt(gsq) rounds on the card (one multiply, the
// square root of the 0-dim norm, a true division, a subtraction); with
// CLAMP then max(., 0) with NaN kept, as torch.clamp_min does. VEC: four
// voxels a thread as 16-byte loads and stores.
template <bool CLAMP, bool VEC>
__global__ void __launch_bounds__(256)
tv_step_kernel(const float* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ dpocs, const float* __restrict__ gsq,
               float* __restrict__ out, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float dp = dpocs[0];
  const float nrm = __fsqrt_rn(gsq[0]);
  auto step = [&](float xv, float gv) {
    const float y = __fsub_rn(xv, __fdiv_rn(__fmul_rn(dp, gv), nrm));
    return CLAMP && !isnan(y) ? fmaxf(y, 0.f) : y;
  };
  if (VEC) {
    if (4 * i >= n) return;
    const float4 xv = reinterpret_cast<const float4*>(x)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    reinterpret_cast<float4*>(out)[i] =
        make_float4(step(xv.x, gv.x), step(xv.y, gv.y), step(xv.z, gv.z),
                    step(xv.w, gv.w));
  } else if (i < n) {
    out[i] = step(x[i], g[i]);
  }
}

template <bool CLAMP>
void launch_step(const float* x, const float* g, const float* dpocs,
                 const float* gsq, float* out, size_t n, cudaStream_t st) {
  const bool vec = n % 4 == 0 &&
                   (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(g) |
                    reinterpret_cast<size_t>(out)) % 16 == 0;
  const size_t items = vec ? n / 4 : n;
  const unsigned blocks = static_cast<unsigned>((items + 255) / 256);
  if (vec) {
    tv_step_kernel<CLAMP, true><<<blocks, 256, 0, st>>>(x, g, dpocs, gsq,
                                                        out, n);
  } else {
    tv_step_kernel<CLAMP, false><<<blocks, 256, 0, st>>>(x, g, dpocs, gsq,
                                                         out, n);
  }
}

int launch_grad(const float* x, const float* lo, const float* hi, float* g,
                float* partials, float* gsq, int n0, int n1, int n2,
                void* stream) {
  if (!tj::march_ok(n0, n1, n2)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = tj::march_grid(n0, n1, n2);
  const bool vec = n2 % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  auto kernel = lo != nullptr ? (vec ? tv_grad_kernel<true, true>
                                     : tv_grad_kernel<true, false>)
                              : (vec ? tv_grad_kernel<false, true>
                                     : tv_grad_kernel<false, false>);
  kernel<<<grid, TV_NT, 0, st>>>(x, lo, hi, g, partials, n0, n1, n2);
  const int err = tj::launch_error();
  if (err != 0) return err;
  return static_cast<int>(tj::sum_partials(
      partials, gsq, static_cast<int>(grid.x * grid.y * grid.z), st));
}

}  // namespace

// The partials K7 and K9c write: one a block of the march's grid.
TJ_API int tj_tv_grad_partials(int n0, int n1, int n2) {
  const dim3 g = tj::march_grid(n0, n1, n2);
  return static_cast<int>(g.x * g.y * g.z);
}

// partials: tj_tv_grad_partials(n0, n1, n2) floats of scratch; gsq: 1
// float, the fixed-order sum of the partials (||g||^2).
TJ_API int tj_tv_grad(const float* x, float* g, float* partials, float* gsq,
                      int n0, int n1, int n2, void* stream) {
  return launch_grad(x, nullptr, nullptr, g, partials, gsq, n0, n1, n2,
                     stream);
}

// K9c: lo, hi are the (n0, n1) planes below slice 0 and above slice n2 - 1
// (the ring neighbours' last and first slices); both required.
TJ_API int tj_tv_grad_halo(const float* x, const float* lo, const float* hi,
                           float* g, float* partials, float* gsq, int n0,
                           int n1, int n2, void* stream) {
  if (lo == nullptr || hi == nullptr) return cudaErrorInvalidValue;
  return launch_grad(x, lo, hi, g, partials, gsq, n0, n1, n2, stream);
}

// The descent step: out = x - dpocs g / sqrt(gsq) over n voxels, then
// max(., 0) when clamp != 0; dpocs and gsq are one float each in device
// memory; out is a tensor of its own.
TJ_API int tj_tv_step(const float* x, const float* g, const float* dpocs,
                      const float* gsq, float* out, long long n, int clamp,
                      void* stream) {
  if (n <= 0 || x == nullptr || g == nullptr || dpocs == nullptr ||
      gsq == nullptr || out == nullptr) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const size_t count = static_cast<size_t>(n);
  if (clamp) {
    launch_step<true>(x, g, dpocs, gsq, out, count, st);
  } else {
    launch_step<false>(x, g, dpocs, gsq, out, count, st);
  }
  return tj::launch_error();
}
