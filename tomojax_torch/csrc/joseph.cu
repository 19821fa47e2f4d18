// Joseph projector pair for Hopper: K1 (forward projection with the FISTA
// residual epilogue), K2 (matched backprojection with the SIRT-update
// epilogue) and K10 (K2 with the angles staged in groups). Slice-last
// layouts: volume x[r][c][s] (N, N, Ns), sinogram
// y[a][j][s] (Na, Nt, Ns). All three put the slice index s on
// threadIdx.x, so every tap a warp gathers is one contiguous 128-byte row.
//
// Weights: the Joseph closed form W[a,j,r,c] = hat((j - J*)/D_a)/D_a with
// J* = x_c cos_a + y_r sin_a + (Nt-1)/2 and D_a = max(|cos_a|, |sin_a|)
// (tomojax/projector/joseph.py). It holds at most two nonzero taps per
// (pixel, angle) and per (bin, step), so both operators are 2-point
// gathers with no scatter and no atomics.
#include "joseph.cuh"

namespace {

constexpr int FP_BS = 32;  // slices per block (threadIdx.x)
constexpr int FP_BJ = 8;   // detector bins per block (threadIdx.y)
constexpr int FP_NT = FP_BS * FP_BJ;
constexpr int BP_BS = 32;  // slices per block (threadIdx.x)
constexpr int BP_BC = 8;   // image columns per block (threadIdx.y)
constexpr int BP_MAX_ANGLES = 3072;  // 16 B each in shared memory (48 KB)

// K1 -- replaces tomojax/projector/pallas_joseph.py:_fp_resid_banded_kernel
// and _fp_resid_kernel (epilogue _fp_resid_epilogue), and with EPI false
// _fp_banded_kernel and _fp_kernel.
//
// One thread per (angle a, bin j, slice s) walks the driving axis
// (tj::fp_ray, joseph.cuh) and scales the sum by 1/D. tab[a] = {1/denom,
// shear, 1/|denom|, row_driven} from the host in f64 rounded to f32,
// exactly as the plain version uses them.
//
// Bound on the H100: gather issue. At 256^3 x 90 one launch makes
// 90*256*256*256*2 = 3.0e9 tap loads, served from L1/L2 (the 64 MiB volume
// is read ~once from memory per angle band). The design keeps each warp's
// taps contiguous (s across the warp) and puts 8 neighbouring bins of one
// angle in a block, whose taps fall on neighbouring columns of the same
// row, so L1 serves most of them.
//
// Epilogue (EPI), in registers: ax = A x, the next FISTA residual
// resid = (b - (ax + beta (ax - ax_old))) * inv_row[a, j], and the block's
// partial sum of (ax - b)^2, reduced in shared memory in a fixed order to
// partials[block]; tj::sum_partials then adds the partials in a fixed
// order (no float atomics: deterministic metrics). beta is read from
// device memory, so the host never waits for it.
template <bool EPI>
__global__ void __launch_bounds__(FP_NT)
fp_kernel(const float* __restrict__ x, const float4* __restrict__ tab,
          const float* __restrict__ b, const float* __restrict__ ax_old,
          const float* __restrict__ inv_row, const float* __restrict__ beta,
          float* __restrict__ ax, float* __restrict__ resid,
          float* __restrict__ partials, int n, int nt, int ns) {
  const int s = blockIdx.x * FP_BS + threadIdx.x;
  const int j = blockIdx.y * FP_BJ + threadIdx.y;
  const int a = blockIdx.z;
  const bool valid = s < ns && j < nt;
  const float4 t = tab[a];  // {inv_d, shear, scale, row_driven}
  const float acc = valid ? tj::fp_ray(x, t, n, nt, ns, j, s) : 0.f;
  const float axv = acc * t.z;
  const size_t o = (static_cast<size_t>(a) * nt + j) * ns + s;
  if (!EPI) {
    if (valid) ax[o] = axv;
    return;
  }
  float sq = 0.f;
  if (valid) {
    const float bv = b[o];
    const float ay = axv + beta[0] * (axv - ax_old[o]);
    ax[o] = axv;
    resid[o] = (bv - ay) * inv_row[static_cast<size_t>(a) * nt + j];
    const float r = axv - bv;
    sq = r * r;
  }
  __shared__ float buf[FP_NT];
  const float total = tj::block_sum<FP_NT>(sq, buf);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[(static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                 gridDim.x + blockIdx.x] = total;
  }
}

// K2 -- replaces tomojax/projector/pallas_joseph.py:_bp_kernel (fused and
// unfused); it also covers _bp_banded_kernel, which computes the same
// operator with another TPU tiling. The angle-blocked _bp_kernel_ab is K10
// below.
//
// One thread per voxel (r, c, s) loops over the angles, a 2-point gather
// per angle (tj::bp_angle, joseph.cuh). tab[a] = {cos, sin, 1/D, 0} in f32
// sits in shared
// memory. With EPI (the FISTA/SIRT update) the result is
// z = max(y_vol + inv_col[r, c] * acc, 0); without, plain A^T y.
//
// Bound on the H100: gather issue, like K1: 256*256*256*90*2 = 3.0e9 tap
// loads per launch at 256^3 x 90. A warp's taps are contiguous in s; the 8
// columns of a block fall within ~8 bins of each other at every angle, so
// the block's sinogram reads stay in L1.
template <bool EPI>
__global__ void __launch_bounds__(BP_BS * BP_BC)
bp_kernel(const float* __restrict__ y, const float4* __restrict__ tab,
          const float* __restrict__ y_vol, const float* __restrict__ inv_col,
          float* __restrict__ out, int n, int nt, int na, int ns) {
  extern __shared__ float4 stab[];
  const int tid = threadIdx.y * BP_BS + threadIdx.x;
  for (int i = tid; i < na; i += BP_BS * BP_BC) stab[i] = tab[i];
  __syncthreads();

  const int s = blockIdx.x * BP_BS + threadIdx.x;
  const int c = blockIdx.y * BP_BC + threadIdx.y;
  const int r = blockIdx.z;
  if (s >= ns || c >= n) return;
  const float ctr = 0.5f * static_cast<float>(n - 1);
  const float xc = static_cast<float>(c) - ctr;
  const float yr = ctr - static_cast<float>(r);
  const float off = 0.5f * static_cast<float>(nt - 1);
  const size_t sino_plane = static_cast<size_t>(nt) * ns;

  float acc = 0.f;
  for (int a = 0; a < na; ++a) {
    acc = tj::bp_angle(y + a * sino_plane + s, stab[a], xc, yr, off, nt, ns,
                       acc);
  }
  const size_t o = (static_cast<size_t>(r) * n + c) * ns + s;
  if (EPI) {
    out[o] = fmaxf(y_vol[o] + inv_col[static_cast<size_t>(r) * n + c] * acc,
                   0.f);
  } else {
    out[o] = acc;
  }
}

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

dim3 fp_grid(int nt, int na, int ns) {
  return dim3((ns + FP_BS - 1) / FP_BS, (nt + FP_BJ - 1) / FP_BJ, na);
}

bool fp_shape_ok(int n, int nt, int na, int ns) {
  return n > 0 && nt > 0 && na > 0 && ns > 0 && na <= 65535 &&
         (nt + FP_BJ - 1) / FP_BJ <= 65535;
}

}  // namespace

TJ_API const char* tj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

TJ_API int tj_fp(const float* x, const float* tab, float* ax, int n, int nt,
                 int na, int ns, void* stream) {
  if (!fp_shape_ok(n, nt, na, ns)) return cudaErrorInvalidValue;
  fp_kernel<false><<<fp_grid(nt, na, ns), dim3(FP_BS, FP_BJ), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const float4*>(tab), nullptr, nullptr, nullptr,
      nullptr, ax, nullptr, nullptr, n, nt, ns);
  return tj::launch_error();
}

TJ_API int tj_fp_resid_partials(int nt, int na, int ns) {
  const dim3 g = fp_grid(nt, na, ns);
  return static_cast<int>(g.x * g.y * g.z);
}

// partials: tj_fp_resid_partials(nt, na, ns) floats of scratch; ddsq: 1
// float, the fixed-order sum of the partials (||A x - b||^2).
TJ_API int tj_fp_resid(const float* x, const float* tab, const float* b,
                       const float* ax_old, const float* inv_row,
                       const float* beta, float* ax, float* resid,
                       float* partials, float* ddsq, int n, int nt, int na,
                       int ns, void* stream) {
  if (!fp_shape_ok(n, nt, na, ns)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  fp_kernel<true><<<fp_grid(nt, na, ns), dim3(FP_BS, FP_BJ), 0, st>>>(
      x, reinterpret_cast<const float4*>(tab), b, ax_old, inv_row, beta, ax,
      resid, partials, n, nt, ns);
  const int err = tj::launch_error();
  if (err != 0) return err;
  return static_cast<int>(tj::sum_partials(
      partials, ddsq, tj_fp_resid_partials(nt, na, ns), st));
}

// y_vol and inv_col both null: plain A^T y; both set: the SIRT epilogue.
TJ_API int tj_bp(const float* y, const float* tab, const float* y_vol,
                 const float* inv_col, float* out, int n, int nt, int na,
                 int ns, void* stream) {
  if (n <= 0 || nt <= 0 || na <= 0 || ns <= 0 || na > BP_MAX_ANGLES ||
      n > 65535 || (n + BP_BC - 1) / BP_BC > 65535 ||
      (y_vol == nullptr) != (inv_col == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((ns + BP_BS - 1) / BP_BS, (n + BP_BC - 1) / BP_BC, n);
  const size_t smem = static_cast<size_t>(na) * sizeof(float4);
  const auto* t4 = reinterpret_cast<const float4*>(tab);
  auto st = static_cast<cudaStream_t>(stream);
  if (y_vol != nullptr) {
    bp_kernel<true><<<grid, dim3(BP_BS, BP_BC), smem, st>>>(
        y, t4, y_vol, inv_col, out, n, nt, na, ns);
  } else {
    bp_kernel<false><<<grid, dim3(BP_BS, BP_BC), smem, st>>>(
        y, t4, nullptr, nullptr, out, n, nt, na, ns);
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
