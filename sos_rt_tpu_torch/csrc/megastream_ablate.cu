// The streamed passes with stages cut out, for timing attribution.
//
// They replace the `ab` flags of two Pallas TPU kernels of
// sos_rt_tpu/ops/megastream.py, which tools/ablate_stream.py drives through
// fused.solve_batch_mega(stream=True, ablate=...):
//   sos_passA_ablate <- _passA_kernel's nosrc (:104: jn = I + 1, no source
//                       product) and noloops (:117: the downward recurrence
//                       without its carry)
//   sos_passB_ablate <- _passB_kernel's nopoly (:144: no band fix), noloops
//                       (:195: no up carry), nofin (:201: no join
//                       corrections, no smoothing) and nosmooth (:207: no
//                       smoothing)
// Results are wrong with any bit set; they are held against
// ops/megastream.py::passA_plain / passB_plain(ab=...), which cut the same
// stages.  Mask 0 is the solve itself, built here a second time so that the
// ablated builds can be shown to start from the same code (it must equal
// sos_passA and the passB stages of megastream.cu to the bit).  Each pass is
// built for mask 0 and each of its flags alone (PassAMasks, PassBMasks), in
// every (dtype, mode) that megastream.cu takes; another mask returns
// cudaErrorInvalidValue and the caller raises.  The bits live in
// stream_passes.cuh's launches and the kernels' templates, whose mask 0 is
// what megastream.cu builds, so its kernels stay as they were.
// Bound on the H100: as the pass's, less the stages cut out; nosrc reads
// two planes and writes two (0.25 ms at the canonical block, float32)
// where passA's product is bound by its operations (1.26 ms).
// Every entry point returns a CUDA error code; the caller raises on non-0.
#include "stream_passes.cuh"

namespace {

// nosrc's source: jn_down = I_down + 1 into sdn (the recurrence then runs
// over it in place), jn_up = I_up + 1
template <typename T>
__global__ void source_plus_one(const T* __restrict__ fdn, const T* __restrict__ fup,
                                T* sdn, T* jnup, size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += stride) {
    sdn[i] = fdn[i] + T(1);
    jnup[i] = fup[i] + T(1);
  }
}

template <int... ABS> struct Masks {};
using PassAMasks = Masks<0, AB_NOSRC, AB_NOLOOPS>;
using PassBMasks = Masks<0, AB_NOPOLY, AB_NOLOOPS, AB_NOFIN, AB_NOSMOOTH>;

// f(AB) for a built mask ab, else cudaErrorInvalidValue
template <class F, int... ABS>
int with_mask(int ab, F&& f, Masks<ABS...>) {
  int rc = (int)cudaErrorInvalidValue;
  ((ab == ABS ? (rc = f(std::integral_constant<int, ABS>()), 0) : 0), ...);
  return rc;
}

template <typename T, int MODE, int AB>
int pass_a_ablated(const void* pack, const void* fdn, const void* fup, const void* colc,
                   const void* ws_hi, const void* ws_lo, const void* ws_tc, int kp,
                   void* sdn, void* jnup, int L, int C, int Mp, cudaStream_t st) {
  if constexpr ((AB & AB_NOSRC) != 0) {
    const size_t n = (size_t)L * C * Mp;
    const int nt = 256;
    const size_t blocks = (n + nt - 1) / nt;
    source_plus_one<T><<<(unsigned)(blocks < (1u << 20) ? blocks : (1u << 20)), nt, 0, st>>>(
        (const T*)fdn, (const T*)fup, (T*)sdn, (T*)jnup, n);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    return launch_down_scan<T, AB & ~AB_NOSRC>(pack, colc, sdn, L, C, Mp, st);
  } else {
    return launch_pass_a<T, MODE, AB>(pack, fdn, fup, colc, ws_hi, ws_lo, ws_tc, kp, sdn,
                                      jnup, L, C, Mp, st);
  }
}

// the three stages of passB with bits AB: the band fix takes AB_NOPOLY, the
// walk the others; nofin and nosmooth smooth no row, so no pass_b_smooth
template <typename T, int MODE, int AB>
int pass_b_ablated(const PassBArgs<T>& a, int C, cudaStream_t st) {
  const int R = a.pm.L * C;
  int err = launch_pass_b_band<T, MODE, AB & AB_NOPOLY>(a, R, st);
  if (err != 0) return err;
  err = launch_pass_b_up<T, MODE, AB & ~AB_NOPOLY>(a, C, st);
  if (err != 0) return err;
  if constexpr ((AB & (AB_NOFIN | AB_NOSMOOTH)) == 0)
    err = launch_pass_b_smooth<T>(a.fup, a.colc, R, a.Mp, a.mr, st);
  return err;
}

}  // namespace

extern "C" {

// As sos_passA, with the ablation mask ab first (0, AB_NOSRC or AB_NOLOOPS).
int sos_passA_ablate(int ab, int dtype, int mode, const void* pack, const void* fdn,
                     const void* fup, const void* colc, const void* ws_hi,
                     const void* ws_lo, const void* ws_tc, int kp, void* sdn, void* jnup,
                     int L, int C, int Mp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, mode, [&](auto tv, auto mv) {
    return with_mask(ab, [&](auto abv) {
      return pass_a_ablated<decltype(tv), decltype(mv)::value, decltype(abv)::value>(
          pack, fdn, fup, colc, ws_hi, ws_lo, ws_tc, kp, sdn, jnup, L, C, Mp, st);
    }, PassAMasks());
  });
}

// sos_passB_band, sos_passB_walk and sos_passB_smooth in one call, with the
// ablation mask ab first (0, AB_NOPOLY, AB_NOLOOPS, AB_NOFIN or
// AB_NOSMOOTH); writes fdn and fup.
int sos_passB_ablate(int ab, int dtype, int mode, const void* pack, const void* sdn,
                     const void* jnup, const void* cpar, const void* colc,
                     const void* tap_col, const void* tap_hi, const void* tap_lo,
                     const void* pvt, const void* bct_hi, const void* bct_lo, void* fdn,
                     void* fup, int L, int C, int Mp, int mr, int slot, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, mode, [&](auto tv, auto mv) {
    using T = decltype(tv);
    PassBArgs<T> a{(const T*)pack, PackMap{L, C, C, 0}, (const T*)sdn, (const T*)jnup,
                   (const T*)cpar, (const T*)colc, (const int*)tap_col, (const T*)tap_hi,
                   (const T*)tap_lo, (const T*)pvt, (const T*)bct_hi, (const T*)bct_lo,
                   (T*)fdn, (T*)fup, Mp, mr, slot};
    return with_mask(ab, [&](auto abv) {
      return pass_b_ablated<T, decltype(mv)::value, decltype(abv)::value>(a, C, st);
    }, PassBMasks());
  });
}

}  // extern "C"
