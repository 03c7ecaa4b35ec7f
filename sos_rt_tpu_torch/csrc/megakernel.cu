// Hand-written Hopper kernel of the resident whole-loop mega solve.
//
// sos_mega replaces the Pallas TPU kernel _mega_kernel of
// sos_rt_tpu/ops/megakernel.py (mega_call): the whole scattering-order loop
// in ONE launch -- the first order I1, then per order pass A (J_n source
// product + downward recurrence), the surface BC, pass B (band fix, upward
// recurrence, join corrections, smoothing walk), the per-column gated
// accumulation, the 100 ppm ratio, n and converged -- with the loop
// condition evaluated on the device.  The plain PyTorch version is
// sos_rt_tpu_torch/ops/megakernel.py::mega_plain.
//
// What the TPU design rests on and what this one does instead.  The TPU
// kernel keeps 6-8 whole (L, Mp, C) planes of a 128-column block in VMEM
// and shares one while_loop per block.  An SM has 227 KB of shared memory,
// and columns share nothing but the operators, so here ONE THREAD BLOCK
// OWNS A SMALL TILE of cb columns and runs that tile's own order loop to
// its own end: no grid-wide barrier, no cooperative launch.  Accumulation,
// ratio and n are gated per column, so a column's result does not depend
// on its tile; a finer tile only stops sooner.  The launch holds as many
// blocks as the card keeps resident; each takes column tiles in turn from
// an atomic counter, from the end of the batch first (the caller sorts
// columns by expected order count, so the longest tiles start first).
//
// The working state of a tile is four planes (fdn, fup, sdn in place of
// jn_down, jn_up) of (L, cb, Mp) in a global-memory workspace the wrapper
// allocates per resident block; at the 64x128 sweep grid that is 128 KiB a
// column in float32 and lives in L2.  Shared memory holds the product's
// tiles and pass B's rows.  The summary outputs need no I_tot planes: the
// four TOA/surface rows are accumulated in place in the outputs.
//
// The passes are the device functions of sos_tiles.cuh that the streamed
// kernels (megastream.cu) call too, so in float64 and float32 'highest' the
// resident and the streamed solve agree bit for bit.  The block has one
// thread shape for all of them: NT = 256 threads (512 for Mp > 256).  Pass B
// splits the block in groups of round32(Mp) threads, one column each.
//
// Bound on the H100: operations.  Per column and order the source product
// is 2*(4Mp)*(2Mp)*L operations per bf16 pass (8.4 MFLOP, 25.2 in three
// passes at 64x128) against ~0.3 MB of plane traffic that stays in L2.  In
// float32 'bf16x3' / 'bf16x5' with 256 threads the two products run on the
// tensor cores (mega_mma.cuh: mma.sync bf16 tiles written for this kernel's
// 128 registers and two blocks an SM) from the bf16 operator copies ws_tc /
// astk_tc, so they sum in another order than the streamed passes' wgmma
// mainloop; float64, 'highest' and Mp > 256 (512 threads) keep the SIMT
// product of sos_tiles.cuh (quad_gemm_tile, 16 x 16 workers).
// The kernel's body is in mega_body.cuh, which mega_ablate.cuh builds too
// with stages cut out (tools/ablate_kernel.py); this file builds the solve
// (AB = 0) and, as sos_mega_i1in, the solve whose first order comes from
// the host (AB = AB_I1IN: the TPU kernel's i1dn / i1up inputs,
// sos_rt_tpu/ops/megakernel.py:326-329, 404-411).  Its pre step is a copy
// of the tile's rows of two (L, Cg, Mp) planes into the workspace, bound by
// those bytes; the rest of its launch is the solve's.
// The entry points return cudaGetLastError(); the caller raises on non-0.
#include "mega_body.cuh"

namespace {

template <int AB> int blocks_for(int dtype, int mode, int Mp, int slot) {
  if (Mp < 8 || Mp > 512 || slot > Mp) return -(int)cudaErrorInvalidValue;
  const int rc = dispatch(dtype, mode, [&](auto tv, auto mv) {
    using T = decltype(tv);
    constexpr int MODE = decltype(mv)::value;
    return Mp <= 256 ? resident_blocks<T, MODE, 256, AB>(Mp, slot)
                     : resident_blocks<T, MODE, 512, AB>(Mp, slot);
  });
  return rc > 0 ? rc : (rc < 0 ? rc : -(int)cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The number of blocks the card keeps resident at once for these shapes
// (the wrapper sizes the workspace by it), or -(CUDA error).
int sos_mega_blocks(int dtype, int mode, int Mp, int slot) {
  return blocks_for<0>(dtype, mode, Mp, slot);
}

// As sos_mega_blocks, for sos_mega_i1in.
int sos_mega_i1in_blocks(int dtype, int mode, int Mp, int slot) {
  return blocks_for<AB_I1IN>(dtype, mode, Mp, slot);
}

// dtype: 0 float32, 1 float64; mode: 0 highest, 1 bf16x3, 2 bf16x5.
// pack (PK_W, L, Cg), cpar (CP_W, Cg), tiles (NI, Cg, Mp); work holds
// nblocks * 4 * L * cb * Mp elements; counter is one zeroed int.  ws_tc,
// astk_tc: the bf16 operator copies (2, 4Mp, Kp), K zero-padded to a
// multiple of 32, of the tensor-core product (float32 bf16x3 / bf16x5 with
// Mp <= 256, astk_tc for a Lambertian surface; null otherwise).
int sos_mega(int dtype, int mode, int lamb, int full, const void* pack,
             const void* cpar, const void* tiles, const void* colc,
             const void* ws_hi, const void* ws_lo, const void* astk_hi,
             const void* astk_lo, const void* ws_tc, const void* astk_tc,
             const void* tap_col, const void* tap_hi,
             const void* tap_lo, const void* pvt, const void* bct_hi,
             const void* bct_lo, void* work, void* counter, void* o0, void* o1,
             void* o2, void* o3, void* stats, int L, int Cg, int cb, int Mp,
             int mr, int slot, int nblocks, int max_orders, double tol,
             void* stream) {
  if (!shape_ok(Mp, mr, slot, cb, Cg) || nblocks < 1 || L < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, mode, [&](auto tv, auto mv) {
    using T = decltype(tv);
    constexpr int MODE = decltype(mv)::value;
    auto launch = Mp <= 256 ? launch_mega<T, MODE, 256, 0> : launch_mega<T, MODE, 512, 0>;
    return launch(pack, cpar, tiles, colc, ws_hi, ws_lo, astk_hi, astk_lo, ws_tc,
                  astk_tc, tap_col, tap_hi, tap_lo, pvt, bct_hi, bct_lo, work, counter,
                  o0, o1, o2, o3, stats, lamb, full, L, Cg, cb, Mp, mr, slot, nblocks,
                  max_orders, tol, st, nullptr, nullptr);
  });
}

// As sos_mega, with the first order given from the host: i1dn, i1up the
// (L, Cg, Mp) planes of I1's halves (angle pads 0).  tiles, the pack's I1
// rows, cpar's I1 constant, astk_* and astk_tc are not read.
int sos_mega_i1in(const void* i1dn, const void* i1up, int dtype, int mode, int lamb,
                  int full, const void* pack, const void* cpar, const void* tiles,
                  const void* colc, const void* ws_hi, const void* ws_lo,
                  const void* astk_hi, const void* astk_lo, const void* ws_tc,
                  const void* astk_tc, const void* tap_col, const void* tap_hi,
                  const void* tap_lo, const void* pvt, const void* bct_hi,
                  const void* bct_lo, void* work, void* counter, void* o0, void* o1,
                  void* o2, void* o3, void* stats, int L, int Cg, int cb, int Mp,
                  int mr, int slot, int nblocks, int max_orders, double tol,
                  void* stream) {
  if (!shape_ok(Mp, mr, slot, cb, Cg) || nblocks < 1 || L < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, mode, [&](auto tv, auto mv) {
    using T = decltype(tv);
    constexpr int MODE = decltype(mv)::value;
    auto launch = Mp <= 256 ? launch_mega<T, MODE, 256, AB_I1IN>
                            : launch_mega<T, MODE, 512, AB_I1IN>;
    return launch(pack, cpar, tiles, colc, ws_hi, ws_lo, astk_hi, astk_lo, ws_tc,
                  astk_tc, tap_col, tap_hi, tap_lo, pvt, bct_hi, bct_lo, work, counter,
                  o0, o1, o2, o3, stats, lamb, full, L, Cg, cb, Mp, mr, slot, nblocks,
                  max_orders, tol, st, i1dn, i1up);
  });
}

}  // extern "C"
