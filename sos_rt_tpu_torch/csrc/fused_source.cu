// The split-mode J_n source of the fused and reference engines on the
// tensor cores: one launch an order computes
//
//   J_n[b, l, :] = in_layer ? w_atm (a_atm/4) P_atm + w_aer (a_aer/4) P_aer
//                           : (a_atm/4) P_atm,
//   P_s = [I_dn | I_up][b, l] . A_s
//
// for float32 'bf16x3' and 'bf16x5'.  No Pallas kernel computes it: the JAX
// package runs it as split products (sos_rt_tpu/ops/precision.py::
// make_split_dot, used by sos_rt_tpu/fused.py's source_fn and
// sos_rt_tpu/solver.py's dot_atm / dot_aer) on the TPU's matrix unit, bf16
// passes with float32 results.  Its plain version, and what the CPU runs, is
// ops/fused_source.py::fused_source_plain: three (five) float32 products a
// species and half plus the mixing.
//
// Bound on the H100: operations.  At the fused canonical block (B = 64,
// L = 800, M = 501) the product is 3 x 2 x 51,200 rows x 1,002 x 2,004 =
// 617 GFLOP of bf16 work (bf16x3), 0.62 ms at the 989 TFLOP/s dense bf16
// peak, against 0.125 ms of compulsory traffic (X in and J_n out, 205 MB
// each, and the 8 MB operator copy).
//
// Design: passA's mainloop (quad_mma.cuh, wgmma bf16 with float32
// accumulators, a cp.async ring, 128 rows x 64 angles x 4 quads a CTA) over
// the stacked operator W of megakernel.stack_source_operator, rows
// [atm_dn; atm_up; aer_dn; aer_up] (4Mp x 2Mp, each block zero-padded to
// Mp), in the bf16 copy (hi, lo) that megakernel.tc_operator makes.  Two
// things differ from passA, both template choices of the mainloop:
// - the loader LoadFieldRows reads the engines' (B, L, M) halves, whose rows
//   start every M or 2M floats (2,004 B at M = 501: no 16-byte copy fits),
//   one float a cp.async with zeros in the pad columns; the two halves have
//   their own pointers and row strides, so the reference engine passes the
//   halves of its (B, L, 2M) field as they are;
// - x is split as the plain version splits it (x1 ties away from zero by
//   integer masking), so each bf16 product is the plain version's and only
//   the order of the float32 sums differs.
// The epilogue EpiFusedSource mixes the species in the plain version's order
// of separately rounded operations (-fmad=false: (a/4) P first, then
// w_atm t_atm + w_aer t_aer) and writes the contiguous (B, L, 2M) J_n whose
// halves the sweep kernels take as views.
#include "quad_mma.cuh"

namespace {

using namespace sos;

// row r = b L + l of the (B L, Mp) product; coef (4, B): a_atm/4, a_aer/4,
// w_atm, w_aer; span (2, B): the aerosol layer's first and last layer
struct EpiFusedSource {
  const float* coef; const int* span; float* jn; int B, L, M;
  __device__ void operator()(int r, int n, float a0, float a1, float a2, float a3) const {
    if (n >= M) return;
    const int b = r / L, l = r - b * L;
    const float ca = coef[b];
    const float td = ca * a0, tu = ca * a1;
    float* o = jn + (size_t)r * 2 * M;
    if (l >= span[b] && l <= span[B + b]) {
      const float cr = coef[B + b], wa = coef[2 * B + b], wr = coef[3 * B + b];
      o[n] = wa * td + wr * (cr * a2);
      o[M + n] = wa * tu + wr * (cr * a3);
    } else {
      o[n] = td;
      o[M + n] = tu;
    }
  }
};

}  // namespace

extern "C" {

// mode: 1 bf16x3, 2 bf16x5.  dn, up: float32 rows of M angles, row r = b L +
// l at r * ld_dn (ld_up) floats; wtc the (2, 4Mp, kp) bf16 operator copy;
// jn the contiguous (B, L, 2M) output.  Returns a CUDA error code.
int sos_fused_source(int mode, const void* dn, const void* up, long long ld_dn,
                     long long ld_up, const void* wtc, int kp, const void* coef,
                     const void* span, void* jn, int B, int L, int M, int Mp,
                     void* stream) {
  if (M > Mp || B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const tc::LoadFieldRows ld{(const float*)dn, (const float*)up, ld_dn, ld_up, M, Mp};
  const EpiFusedSource epi{(const float*)coef, (const int*)span, (float*)jn, B, L, M};
  const int R = B * L;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == MM_BF16X3) return tc::launch<MM_BF16X3>(ld, epi, wtc, R, Mp, 2 * Mp, kp, st);
  if (mode == MM_BF16X5) return tc::launch<MM_BF16X5>(ld, epi, wtc, R, Mp, 2 * Mp, kp, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
