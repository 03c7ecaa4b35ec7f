// The resident whole-loop kernel with stages cut out, for timing attribution.
//
// sos_mega_ablate replaces the `ablate` flags of the Pallas TPU kernel
// _mega_kernel (sos_rt_tpu/ops/megakernel.py:303, flags at :313-319, used by
// tools/ablate_kernel.py): it launches mega_kernel<T, MODE, 256, AB> of
// mega_body.cuh, the body sos_mega runs, with the ablation bits AB of
// sos_tiles.cuh.  Results are wrong with any bit set; they are held against
// ops/megakernel.py::mega_plain(ablate=...), which cuts the same stages.
// AB = 0 is the solve itself, built here a second time so that the ablated
// builds can be shown to start from the same code (it must equal sos_mega to
// the bit).  Only the variants of sos_rt_tpu_torch/tools/ablate_kernel.py
// are built, for 256 threads (Mp <= 256), in float32 (bf16x3, highest) and
// float64 (highest): each variant is a whole kernel, and the solve's own
// build (megakernel.cu) stays as it is.  The float32 bf16x3 variants run
// their products on the tensor cores, as sos_mega does (mega_mma.cuh).
// This header holds the entry points; each of mega_ablate.cu (float32
// bf16x3), mega_ablate_f32.cu (float32 highest) and mega_ablate_f64.cu
// (float64 highest) builds them for its one (type, mode), ABLATE_T /
// ABLATE_MODE, so that the three compile in parallel (14 kernels each).
// Bound on the H100: as sos_mega's, less the stages cut out.
// Every entry point returns a CUDA error code; the caller raises on non-0.
#pragma once
#include <type_traits>

#include "mega_body.cuh"

namespace {

// The ablation masks built here (ops/megakernel.py::ABLATE_VARIANTS).
constexpr int NC = AB_NOCONV;
template <int... ABS> struct Masks {};
using Variants = Masks<0, NC, NC | AB_NOI1, NC | AB_NOSRC, NC | AB_NOLOOPS,
                       NC | AB_NOPOLY, NC | AB_NOSMOOTH, NC | AB_NOFIN, NC | AB_NOBC,
                       NC | AB_NORATIO, NC | AB_NOPASSA, NC | AB_NOPASSB,
                       NC | AB_NOSRC | AB_NOLOOPS | AB_NOPOLY | AB_NOFIN,
                       NC | AB_NOPASSA | AB_NOPASSB | AB_NORATIO>;

// f(T, MODE, AB) for the built (dtype, mode, ab), else cudaErrorInvalidValue
template <class F, int... ABS>
int with_mask(int ab, F&& f, Masks<ABS...>) {
  int rc = (int)cudaErrorInvalidValue;
  ((ab == ABS ? (rc = f(std::integral_constant<int, ABS>()), 0) : 0), ...);
  return rc;
}

// f(T, MODE, AB) for this unit's (ABLATE_T, ABLATE_MODE) and a built mask,
// else cudaErrorInvalidValue
template <class F> int dispatch_ablate(int ab, int dtype, int mode, F&& f) {
  constexpr int DTYPE = std::is_same<ABLATE_T, double>::value ? 1 : 0;
  if (dtype != DTYPE || mode != ABLATE_MODE) return (int)cudaErrorInvalidValue;
  return with_mask(ab, [&](auto abv) {
    return f(ABLATE_T(), std::integral_constant<int, ABLATE_MODE>(), abv);
  }, Variants());
}

}  // namespace

extern "C" {

// As sos_mega_blocks, for mask ab; -(CUDA error) for a mask, dtype or mode
// not built in this unit.
int sos_mega_ablate_blocks(int ab, int dtype, int mode, int Mp, int slot) {
  if (Mp < 8 || Mp > 256 || slot > Mp) return -(int)cudaErrorInvalidValue;
  const int rc = dispatch_ablate(ab, dtype, mode, [&](auto tv, auto mv, auto abv) {
    return resident_blocks<decltype(tv), decltype(mv)::value, 256,
                           decltype(abv)::value>(Mp, slot);
  });
  return rc > 0 ? rc : (rc < 0 ? rc : -(int)cudaErrorInvalidValue);
}

// As sos_mega, with the ablation mask ab first; Mp <= 256.
int sos_mega_ablate(int ab, int dtype, int mode, int lamb, int full,
                    const void* pack, const void* cpar, const void* tiles,
                    const void* colc, const void* ws_hi, const void* ws_lo,
                    const void* astk_hi, const void* astk_lo, const void* ws_tc,
                    const void* astk_tc, const void* tap_col,
                    const void* tap_hi, const void* tap_lo, const void* pvt,
                    const void* bct_hi, const void* bct_lo, void* work,
                    void* counter, void* o0, void* o1, void* o2, void* o3,
                    void* stats, int L, int Cg, int cb, int Mp, int mr, int slot,
                    int nblocks, int max_orders, double tol, void* stream) {
  if (!shape_ok(Mp, mr, slot, cb, Cg) || Mp > 256 || nblocks < 1 || L < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch_ablate(ab, dtype, mode, [&](auto tv, auto mv, auto abv) {
    return launch_mega<decltype(tv), decltype(mv)::value, 256, decltype(abv)::value>(
        pack, cpar, tiles, colc, ws_hi, ws_lo, astk_hi, astk_lo, ws_tc, astk_tc,
        tap_col, tap_hi, tap_lo, pvt, bct_hi, bct_lo, work, counter, o0, o1, o2, o3,
        stats, lamb, full, L, Cg, cb, Mp, mr, slot, nblocks, max_orders, tol, st);
  });
}

}  // extern "C"
