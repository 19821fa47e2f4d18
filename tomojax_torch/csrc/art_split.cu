// A1's variants, which split a ray's time (art.cuh Variant): their own
// translation unit, so that they build beside the sweep (art.cu). They
// take the sweep's shapes where Ns % VS == 0 (the vector path);
// chip_smoke.py times them at 256^3 x 90.
#include "art.cuh"

using namespace tj_art;

TJ_API int tj_art_sweep(float* x, const float* b, const float* rtab,
                        const int* order, int count, float beta, int n,
                        int rays, int ns, int slices, void* stream);

// One sweep of a variant (bits of Variant: 0 is the sweep, tj_art_sweep;
// 1 NOLOAD, 2 NORED, 4 NOSTORE, 8 NOPREF, 16 PROF, each alone, and 13, the
// chain without x's traffic) in place on x, operands as tj_art_sweep's;
// prof (PROF) (blocks, A_PHASES + 1) int64s.
TJ_API int tj_art_variant(int variant, float* x, const float* b,
                          const float* rtab, const int* order, int count,
                          float beta, int n, int rays, int ns, int slices,
                          long long* prof, void* stream) {
  if (variant == FULL) {
    return tj_art_sweep(x, b, rtab, order, count, beta, n, rays, ns, slices,
                        stream);
  }
  if (!valid(rtab, count, n, rays, ns, slices) ||
      ((variant & PROF) && prof == nullptr)) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* t = reinterpret_cast<const float4*>(rtab);
#define TJ_ART_CASE(V_)                                                  \
  case V_:                                                               \
    return launch_sl<V_>(slices, x, b, t, order, count, beta, n, rays,   \
                         ns, prof, st);
  switch (variant) {
    TJ_ART_CASE(NOLOAD)
    TJ_ART_CASE(NORED)
    TJ_ART_CASE(NOSTORE)
    TJ_ART_CASE(NOPREF)
    TJ_ART_CASE(NOLOAD | NOSTORE | NOPREF)
    TJ_ART_CASE(PROF)
    default:
      return cudaErrorInvalidValue;
  }
#undef TJ_ART_CASE
}
