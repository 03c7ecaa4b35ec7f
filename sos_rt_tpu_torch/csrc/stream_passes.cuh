// The launches of the streamed passes, shared by megastream.cu (the solve)
// and megastream_ablate.cu (its ablated builds): the SIMT quad product
// kernel, the downward recurrence, the product's mainloop pick and passB's
// three stage launches.  Each takes the ablation bits AB of sos_tiles.cuh;
// megastream.cu builds AB = 0 only, so its kernels are the solve's.
#pragma once
#include <type_traits>

#include "pass_b_split.cuh"
#include "quad_mma.cuh"
#include "sos_tiles.cuh"

namespace {

using namespace sos;

// one BM x BN tile of the quad product per block of 16 x 16 threads
template <typename T, int MODE, class Loader, class Epi>
__global__ void __launch_bounds__(TX * TY)
quad_gemm(Loader ld, Epi epi, const T* __restrict__ w_hi,
          const T* __restrict__ w_lo, int R, int Mp, int K) {
  __shared__ GemmSmem<T, MODE> sm;
  quad_gemm_tile<T, MODE>(ld, epi, w_hi, w_lo, R, Mp, K, blockIdx.y * BM,
                          blockIdx.x * BN, threadIdx.y * TX + threadIdx.x, true, sm);
}

// one thread per (column, angle) walks the layers downward; AB_NOLOOPS
// drops the carry
template <typename T, int AB = 0>
__global__ void down_scan(const T* __restrict__ pack, const T* __restrict__ colc,
                          T* sdn, int L, int C, int Mp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * Mp) return;
  down_scan_one<T, AB>(pack, PackMap{L, C, C, 0}, colc, sdn, Mp, idx / Mp, idx % Mp);
}

dim3 gemm_grid(int R, int Mp) { return dim3((Mp + BN - 1) / BN, (R + BM - 1) / BM); }

// the quad product in the mainloop (dtype, mode) takes: the tensor cores for
// float32 bf16x3 / bf16x5 (w_tc: the (2, 4Mp, kp) bf16 operator copy), the
// SIMT product otherwise (w_hi, w_lo)
template <typename T, int MODE, class Loader, class Epi>
int quad_product(const Loader& ld, const Epi& epi, const void* w_hi, const void* w_lo,
                 const void* w_tc, int kp, int R, int Mp, int K, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value && MODE != MM_HIGHEST) {
    return tc::launch<MODE>(ld, epi, w_tc, R, Mp, K, kp, st);
  } else {
    if ((R + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
    quad_gemm<T, MODE><<<gemm_grid(R, Mp), dim3(TX, TY), 0, st>>>(
        ld, epi, (const T*)w_hi, (const T*)w_lo, R, Mp, K);
    return (int)cudaGetLastError();
  }
}

// the downward recurrence over jn, which the caller left in sdn
template <typename T, int AB>
int launch_down_scan(const void* pack, const void* colc, void* sdn, int L, int C, int Mp,
                     cudaStream_t st) {
  const int n = C * Mp, nt = 256;
  down_scan<T, AB><<<(n + nt - 1) / nt, nt, 0, st>>>((const T*)pack, (const T*)colc,
                                                     (T*)sdn, L, C, Mp);
  return (int)cudaGetLastError();
}

// passA: the source product (its epilogue mixes the species into jn_down,
// left in sdn, and jn_up), then the downward recurrence with bits AB
template <typename T, int MODE, int AB>
int launch_pass_a(const void* pack, const void* fdn, const void* fup, const void* colc,
                  const void* ws_hi, const void* ws_lo, const void* ws_tc, int kp,
                  void* sdn, void* jnup, int L, int C, int Mp, cudaStream_t st) {
  LoadFields<T> ld{(const T*)fdn, (const T*)fup, Mp};
  EpiSource<T> epi{(const T*)pack, PackMap{L, C, C, 0}, (T*)sdn, (T*)jnup, Mp};
  const int err = quad_product<T, MODE>(ld, epi, ws_hi, ws_lo, ws_tc, kp, L * C, Mp, 2 * Mp, st);
  if (err != 0) return err;
  return launch_down_scan<T, AB>(pack, colc, sdn, L, C, Mp, st);
}

// passB stage 1, the band fix of every row (fdn), with bits AB
template <typename T, int MODE, int AB>
int launch_pass_b_band(const PassBArgs<T>& a, int R, cudaStream_t st) {
  if (a.slot > a.Mp || a.slot > 32 || a.mr < 4 || a.mr > a.Mp) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * pb::band_smem_elems(a.Mp);
  auto kern = pb::pass_b_band<T, MODE, AB>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(R + pb::ROW_WARPS - 1) / pb::ROW_WARPS, 32 * pb::ROW_WARPS, smem, st>>>(a, R);
  return (int)cudaGetLastError();
}

// passB stage 2, the upward walk (fup), one block a column, with bits AB
template <typename T, int MODE, int AB>
int launch_pass_b_up(const PassBArgs<T>& a, int C, cudaStream_t st) {
  const int nt = ((a.Mp + 31) / 32) * 32;
  if (nt > 1024 || a.mr < 4 || a.mr > a.Mp) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * pb::up_smem_elems<T, MODE>(a.Mp);
  pb::pass_b_up<T, MODE, AB><<<C, nt, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// passB stage 3, the smoothing of every row of fup in place
template <typename T>
int launch_pass_b_smooth(void* fup, const void* colc, int R, int Mp, int mr,
                         cudaStream_t st) {
  if (mr < 4 || mr > Mp) return (int)cudaErrorInvalidValue;
  const int blocks = (R + pb::ROW_WARPS - 1) / pb::ROW_WARPS;
  pb::pass_b_smooth<T><<<blocks, 32 * pb::ROW_WARPS, 0, st>>>((T*)fup, (const T*)colc, R,
                                                            Mp, mr);
  return (int)cudaGetLastError();
}

}  // namespace
