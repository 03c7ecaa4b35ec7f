// Hand-written Hopper kernels of the streamed mega solve.
//
// They replace the three Pallas TPU kernels of sos_rt_tpu/ops/megastream.py:
//   sos_passI  <- _passI_kernel  (closed-form first order I1)
//   sos_passA  <- _passA_kernel  (J_n source product + downward recurrence)
//   sos_passB_band, sos_passB_walk, sos_passB_smooth
//              <- _passB_kernel  (surface BC, band fix, upward recurrence,
//                                  join corrections, smoothing walk: three
//                                  kernels, pass_b_split.cuh)
// Plain PyTorch versions of the same functions live beside their wrappers
// in sos_rt_tpu_torch/ops/megastream.py; the CPU runs those.
//
// Layout (one block of C columns): a half-field is (L, C, Mp) contiguous,
// angles last, so row r = t*C + c of the (L*C, Mp) matrix is one
// (layer, column) pair.  Per-(layer, column) scalars are pack (PK_W, L, C);
// per-column scalars cpar (CP_W, C); per-angle rows colc (7, Mp); per
// (column, angle) I1 tiles (NI, C, Mp).  The bodies of passI and passA are
// the device functions of sos_tiles.cuh, which the resident whole-loop
// kernel (megakernel.cu) calls too; passB's three kernels (pass_b_split.cuh)
// do what its pass_b_walk does, split by layer dependence.
//
// Bounds on the H100 and what the design does about them:
// - passA and passI are products of a fixed (4Mp, K) operator with an
//   (L*C, K) field, K = 2Mp or Mp: compute-bound (416 GFLOP per bf16 pass
//   at the 501x800 grid for one 128-column block, three passes in bf16x3).
//   The epilogue does the species mixing (passA) or the whole I1 closed form
//   (passI), so jn and the surface products never make a round trip through
//   device memory.  The mainloop is picked at compile time by (dtype, mode):
//   * float32 bf16x3 / bf16x5: tc::quad_mma (quad_mma.cuh), on the tensor
//     cores (wgmma bf16, float32 accumulators, a 3-stage shared-memory ring
//     filled by cp.async): the host-split operator (hi, lo) as bf16 copies,
//     x split in registers round half to even; a bf16 x bf16 product is
//     exact in float32, so the result differs from the SIMT product only in
//     the order of the float32 sums.
//   * float64 and float32 'highest' (no bf16 split exists): quad_gemm, the
//     tiled SIMT FMA product of sos_tiles.cuh, which the resident kernel
//     calls too.
// - The downward recurrence (passA scan) and passB are memory-bound: each
//   streams whole field planes once.  One thread per (column, angle) walks
//   the layers with the carry in a register (passA scan).  passB runs its
//   row-parallel work (the band fix, the smoothing of every row) one warp a
//   (layer, column) row on every SM, and only the upward carry and the two
//   join rows' smoothing in a walk over the layers, one block a column with
//   threads over angles, so every load of a layer row is contiguous
//   (pass_b_split.cuh).
// The launches are stream_passes.cuh's, built here for the solve (ablation
// bits 0); megastream_ablate.cu builds them with stages cut out.
// Every entry point returns cudaGetLastError(); the caller raises on non-0.
#include "stream_passes.cuh"

extern "C" {

// dtype: 0 float32, 1 float64; mode: 0 highest, 1 bf16x3, 2 bf16x5.
// ws_tc / astk_tc: the bf16 operator copy (2, 4Mp, kp) of the tensor-core
// mainloop (float32 bf16x3 / bf16x5; unread otherwise, may be null).
int sos_passA(int dtype, int mode, const void* pack, const void* fdn,
              const void* fup, const void* colc, const void* ws_hi,
              const void* ws_lo, const void* ws_tc, int kp, void* sdn, void* jnup,
              int L, int C, int Mp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, mode, [&](auto tv, auto mv) {
    return launch_pass_a<decltype(tv), decltype(mv)::value, 0>(
        pack, fdn, fup, colc, ws_hi, ws_lo, ws_tc, kp, sdn, jnup, L, C, Mp, st);
  });
}

int sos_passI(int dtype, int mode, int lamb, const void* pack,
              const void* tiles, const void* cpar, const void* colc,
              const void* astk_hi, const void* astk_lo, const void* astk_tc, int kp,
              void* fdn, void* fup, int L, int C, int Mp, int mr, void* stream) {
  const int R = L * C;
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, mode, [&](auto tv, auto mv) {
    using T = decltype(tv);
    constexpr int MODE = decltype(mv)::value;
    const PackMap pm{L, C, C, 0};
    LoadSurfaceExp<T> ld{(const T*)pack, pm, (const T*)colc + RC_IVUP * Mp};
    EpiFirstOrder<T> epi{(const T*)pack, pm, (const T*)tiles, (const T*)colc,
                         (const T*)cpar, (T*)fdn, (T*)fup, Mp, mr, lamb != 0};
    // a specular surface has no surface-integral product: K = 0
    return quad_product<T, MODE>(ld, epi, astk_hi, astk_lo, astk_tc, kp, R, Mp,
                                 lamb ? Mp : 0, st);
  });
}

// passB in three launches on one stream: the band fix of every row (fdn),
// the upward walk (fup, unsmoothed but at the join rows), the smoothing of
// every row of fup in place.  The caller checks each one's return code.
int sos_passB_band(int dtype, int mode, const void* pack, const void* sdn,
                   const void* colc, const void* tap_col, const void* tap_hi,
                   const void* tap_lo, const void* pvt, void* fdn, int L, int C, int Mp,
                   int mr, int slot, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, mode, [&](auto tv, auto mv) {
    using T = decltype(tv);
    PassBArgs<T> a{(const T*)pack, PackMap{L, C, C, 0}, (const T*)sdn, nullptr, nullptr,
                   (const T*)colc, (const int*)tap_col, (const T*)tap_hi, (const T*)tap_lo,
                   (const T*)pvt, nullptr, nullptr, (T*)fdn, nullptr, Mp, mr, slot};
    return launch_pass_b_band<T, decltype(mv)::value, 0>(a, L * C, st);
  });
}

int sos_passB_walk(int dtype, int mode, const void* pack, const void* jnup,
                   const void* cpar, const void* colc, const void* bct_hi,
                   const void* bct_lo, const void* fdn, void* fup, int L, int C, int Mp,
                   int mr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, mode, [&](auto tv, auto mv) {
    using T = decltype(tv);
    PassBArgs<T> a{(const T*)pack, PackMap{L, C, C, 0}, nullptr, (const T*)jnup,
                   (const T*)cpar, (const T*)colc, nullptr, nullptr, nullptr, nullptr,
                   (const T*)bct_hi, (const T*)bct_lo, (T*)fdn, (T*)fup, Mp, mr, 0};
    return launch_pass_b_up<T, decltype(mv)::value, 0>(a, C, st);
  });
}

int sos_passB_smooth(int dtype, void* fup, const void* colc, int L, int C, int Mp, int mr,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_pass_b_smooth<float>(fup, colc, L * C, Mp, mr, st);
  if (dtype == 1) return launch_pass_b_smooth<double>(fup, colc, L * C, Mp, mr, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory (bytes) of the tensor-core mainloop's CTA
int sos_tc_smem() { return tc::smem_bytes(); }

}  // extern "C"
