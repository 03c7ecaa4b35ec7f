// Hand-written Hopper kernels of the per-op microbenchmarks.
//
// They replace the two Pallas TPU kernels of the JAX package's tools:
//   sos_micro_ops   <- tools/micro_ops.py::kern   (k reps of one pattern)
//   sos_micro_pass  <- tools/micro_pass.py::kern  (K = 64 elementwise passes,
//                                                   one loop structure per mode)
// Plain PyTorch versions of the same functions are in
// sos_rt_tpu_torch/ops/micro.py, beside the wrappers.
//
// The field is (L, C, M2) = (128, 64, 128) float32, 4 MiB.  The TPU keeps it
// in VMEM for all reps; here it lives in shared memory, spread over 128
// thread blocks of 256 threads (one per SM): block b holds column b / 2's
// layers [64 (b % 2), 64 (b % 2) + 64), 64 rows of 128 lanes, for all reps
// (the TPU kernel's layer chunks are then chunks of a block's rows).  Every
// pattern is row-wise, so the blocks never meet.  Each rep ends in a block
// barrier, so each rep reads the field from shared memory and writes it back
// (registers cannot carry it from one rep to the next).
//
// micro_ops patterns (one template instantiation each; P_* below):
//   fma, rowscalar, rowscalar_slice, lanemask, tworefs, exp, lanebrd: a warp
//     per row, 4 lanes a thread, as separately rounded multiplies and adds
//     (-fmad=false), as the TPU computes them;
//   reduce, roll: the same, the lane sum a warp shuffle tree, the roll a
//     shuffle;
//   smooth: the mu->0+ smoothing walk of the resident kernel
//     (sos_tiles.cuh::smooth_up_walk) on each row's up half (lanes 64-127,
//     mu the up angles of GridSpec(64, 128)), the down half unchanged, in
//     pass B's own thread shape: a thread per angle, a group of two warps
//     per row, the first index a group minimum (two block barriers a row);
//   matmul: v @ a2 as FP32 FMAs on SIMT, summed in ascending k (dot_term of
//     mode 'highest');
//   matmul_high, matmul_def: v @ a2 on the tensor cores through
//     mma.sync.m16n8k16 bf16 with float32 accumulators: v split on the fly
//     into bf16 parts x1 + x2 (round half to even, split_x), a2 split once
//     by the wrapper into hi + lo (round half to even, as XLA splits both
//     operands for Precision.HIGH); matmul_high sums hi x1 + hi x2 + lo x1
//     (bf16x3), matmul_def hi x1 alone (one bf16 pass).
//   tworefs reads the scratch b, which the TPU kernel never writes: b holds
//     NaN, what the JAX kernel reads in interpret mode.
//
// Bound on the H100: per rep the elementwise patterns move 8 MiB through
// shared memory (read + write), against 132 SMs x 128 B per clock; matmul is
// bound by its 268 MFLOP a rep on the FP32 units, matmul_high by its
// 805 MFLOP a rep on the tensor cores (mma.sync does not reach wgmma's rate).
// Every entry point returns a CUDA error code; the caller raises on non-0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

#include "sos_tiles.cuh"

namespace {

using namespace sos;

constexpr int L = 128, C = 64, M2 = 128, M = M2 / 2;
constexpr int ROWS = 64;                    // rows a block holds
constexpr int NBLK = L * C / ROWS;          // 128 blocks
constexpr int NT = 256, NWARP = NT / 32;
constexpr int RPW = ROWS / NWARP;           // rows a warp walks
constexpr int RS = M2 + 8;                  // row stride in shared memory
constexpr int PK = 16;                      // pk values a row
constexpr int BS = M2 + 8;                  // bf16 row stride of the split a2

enum { P_FMA = 0, P_ROWSCALAR, P_ROWSCALAR_SLICE, P_LANEMASK, P_TWOREFS, P_EXP,
       P_LANEBRD, P_REDUCE, P_ROLL, P_SMOOTH, P_MATMUL, P_MATMUL_HIGH,
       P_MATMUL_DEF, N_PAT };

// element offset of local row rl of block b in the (L, C, M2) field
__device__ __forceinline__ size_t row_at(int b, int rl) {
  return ((size_t)((b & 1) * ROWS + rl) * C + (b >> 1)) * M2;
}

// shared memory of pattern P, in bytes, and where each part starts
template <int P> struct Smem {
  static constexpr bool TWO = P == P_TWOREFS, PKR = P == P_ROWSCALAR || P == P_ROWSCALAR_SLICE;
  static constexpr bool A2 = P == P_MATMUL, A2ROW = P == P_LANEBRD, MU = P == P_SMOOTH;
  static constexpr bool HI = P == P_MATMUL_HIGH || P == P_MATMUL_DEF, LO = P == P_MATMUL_HIGH;
  static constexpr size_t a = 0;
  static constexpr size_t b = a + sizeof(float) * ROWS * RS;
  static constexpr size_t pk = b + (TWO ? sizeof(float) * ROWS * RS : 0);
  static constexpr size_t a2 = pk + (PKR ? sizeof(float) * ROWS * PK : 0);
  static constexpr size_t mu = a2 + (A2 ? sizeof(float) * M2 * M2 : (A2ROW ? sizeof(float) * M2 : 0));
  static constexpr size_t hi = mu + (MU ? sizeof(float) * M : 0);
  static constexpr size_t lo = hi + (HI ? 2 * M2 * BS : 0);
  static constexpr size_t bytes = lo + (LO ? 2 * M2 * BS : 0);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<const uint32_t*>(&p);
}

// d += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one rep of a row-wise pattern on local row rl, lanes 4 lane .. 4 lane + 3
template <int P>
__device__ __forceinline__ void row_rep(float* a, const float* b, const float* pk,
                                        const float* a2, int rl, int lane) {
  float4* p = reinterpret_cast<float4*>(a + rl * RS) + lane;
  const float4 v = *p;
  float x[4] = {v.x, v.y, v.z, v.w};
  float r[4];
  if constexpr (P == P_FMA) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = x[i] * 1.0001f + 0.5f;
  } else if constexpr (P == P_ROWSCALAR || P == P_ROWSCALAR_SLICE) {
    const float s = pk[rl * PK + 3];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = s * x[i] + 0.5f;
  } else if constexpr (P == P_LANEMASK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = 4 * lane + i < M ? x[i] * 1.0001f : 0.0f;
  } else if constexpr (P == P_TWOREFS) {
    const float4 w = reinterpret_cast<const float4*>(b + rl * RS)[lane];
    const float y[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = x[i] * 1.0001f + y[i];
  } else if constexpr (P == P_EXP) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = expf(x[i] * 1e-3f);
  } else if constexpr (P == P_LANEBRD) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = x[i] * a2[4 * lane + i] + 0.5f;
  } else if constexpr (P == P_REDUCE) {
    float s = ((x[0] + x[1]) + x[2]) + x[3];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = x[i] + s;
  } else if constexpr (P == P_ROLL) {
    const float next = __shfl_sync(0xffffffffu, x[0], (lane + 1) & 31);
    r[0] = x[0] + x[1];
    r[1] = x[1] + x[2];
    r[2] = x[2] + x[3];
    r[3] = x[3] + next;
  }
  *p = make_float4(r[0], r[1], r[2], r[3]);
}

// one rep of smooth: the resident kernel's walk as pass B runs it, a
// thread per up angle and a group of M = 64 threads (two warps) per row,
// whose first index is a group minimum through shared memory; NT / M rows
// at a time.  Only up angles 1 .. idx-1 change, and the walk reads sv[0]
// and sv[idx], which no thread writes, after the group barrier.
__device__ __forceinline__ void smooth_rep(float* a, const float* mu, int* sred, int tid) {
  constexpr int GROUPS = NT / M;
  const int grp = tid / M, n = tid % M;
  for (int r0 = 0; r0 < ROWS; r0 += GROUPS) {
    float* sv = a + (r0 + grp) * RS + M;
    const float f = sv[n];
    const float sm = smooth_up_walk<float>(sv, mu, 0, M, n, mu[n], f,
                                           GroupMin{sred, grp * (M / 32), M / 32});
    if (sm != f) sv[n] = sm;
  }
}

// one rep of matmul (SIMT FMA): warp w computes rows 8w..8w+7, lane the
// columns lane + 32 j; every output sums over k in ascending order
__device__ __forceinline__ void matmul_rep(float* a, const float* a2, int warp,
                                           int lane) {
  float acc[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k = 0; k < M2; ++k) {
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = a2[k * M2 + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float x[1] = {a[(warp * RPW + i) * RS + k]};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = dot_term<float, MM_HIGHEST>(acc[i][j], w[j], 0.0f, x);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[(warp * RPW + i) * RS + lane + 32 * j] = acc[i][j];
}

// one rep of matmul_high (X3) or matmul_def on the tensor cores: warp w
// computes rows 16 (w % 4) .. +15 and columns 64 (w / 4) .. +63, eight
// m16n8 tiles, K = 128 in eight steps of 16
template <bool X3>
__device__ __forceinline__ void mma_rep(float* a, const uint16_t* hiT,
                                        const uint16_t* loT, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = 64 * (warp >> 2);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll 2
  for (int k0 = 0; k0 < M2; k0 += 16) {
    // A fragments: rows g, g + 8; columns k0 + 2t (+1), k0 + 8 + 2t (+1)
    uint32_t x1[4], x2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + g + 8 * (q & 1), col = k0 + 2 * t + 8 * (q >> 1);
      const float2 v = *reinterpret_cast<const float2*>(a + row * RS + col);
      float p0[2], p1[2];
      split_x<float, MM_BF16X3>(v.x, p0);
      split_x<float, MM_BF16X3>(v.y, p1);
      x1[q] = pack_bf16(p0[0], p1[0]);
      x2[q] = pack_bf16(p0[1], p1[1]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // B fragments: column n = c0 + 8j + g, rows k0 + 2t (+1), k0 + 8 + 2t (+1)
      const uint16_t* hb = hiT + (c0 + 8 * j + g) * BS + k0 + 2 * t;
      const uint32_t h0 = *reinterpret_cast<const uint32_t*>(hb);
      const uint32_t h1 = *reinterpret_cast<const uint32_t*>(hb + 8);
      mma_bf16(acc[j], x1, h0, h1);
      if constexpr (X3) {
        const uint16_t* lb = loT + (c0 + 8 * j + g) * BS + k0 + 2 * t;
        mma_bf16(acc[j], x2, h0, h1);
        mma_bf16(acc[j], x1, *reinterpret_cast<const uint32_t*>(lb),
                 *reinterpret_cast<const uint32_t*>(lb + 8));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(a + (r0 + g) * RS + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(a + (r0 + g + 8) * RS + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

template <int P>
__global__ void __launch_bounds__(NT, 1)
micro_ops_kernel(int k, const float* __restrict__ x, const float* __restrict__ pk,
                 const float* __restrict__ a2, const uint16_t* __restrict__ hiT,
                 const uint16_t* __restrict__ loT, const float* __restrict__ muup,
                 float* __restrict__ out) {
  using S = Smem<P>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* a = reinterpret_cast<float*>(smem + S::a);
  float* b = reinterpret_cast<float*>(smem + S::b);
  float* spk = reinterpret_cast<float*>(smem + S::pk);
  float* sa2 = reinterpret_cast<float*>(smem + S::a2);
  float* smu = reinterpret_cast<float*>(smem + S::mu);
  uint16_t* shi = reinterpret_cast<uint16_t*>(smem + S::hi);
  uint16_t* slo = reinterpret_cast<uint16_t*>(smem + S::lo);
  __shared__ int sred[NWARP];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, blk = blockIdx.x;

  // a <- x (and what the pattern reads besides)
  for (int e = tid; e < ROWS * M2 / 4; e += NT) {
    const int rl = e / (M2 / 4), c4 = e % (M2 / 4);
    reinterpret_cast<float4*>(a + rl * RS)[c4] =
        reinterpret_cast<const float4*>(x + row_at(blk, rl))[c4];
    if constexpr (S::TWO)
      reinterpret_cast<float4*>(b + rl * RS)[c4] =
          make_float4(__int_as_float(0x7fc00000), __int_as_float(0x7fc00000),
                      __int_as_float(0x7fc00000), __int_as_float(0x7fc00000));
  }
  if constexpr (S::PKR)
    for (int e = tid; e < ROWS * PK; e += NT)
      spk[e] = pk[row_at(blk, e / PK) / M2 * PK + e % PK];
  if constexpr (S::A2)
    for (int e = tid; e < M2 * M2; e += NT) sa2[e] = a2[e];
  if constexpr (S::A2ROW)
    for (int e = tid; e < M2; e += NT) sa2[e] = a2[e];
  if constexpr (S::MU)
    for (int e = tid; e < M; e += NT) smu[e] = muup[e];
  if constexpr (S::HI)
    for (int e = tid; e < M2 * M2; e += NT) {
      shi[(e / M2) * BS + e % M2] = hiT[e];
      if constexpr (S::LO) slo[(e / M2) * BS + e % M2] = loT[e];
    }
  __syncthreads();

  for (int rep = 0; rep < k; ++rep) {
    if constexpr (P == P_SMOOTH) {
      smooth_rep(a, smu, sred, tid);
    } else if constexpr (P == P_MATMUL) {
      matmul_rep(a, sa2, warp, lane);
    } else if constexpr (P == P_MATMUL_HIGH || P == P_MATMUL_DEF) {
      mma_rep<P == P_MATMUL_HIGH>(a, shi, slo, warp, lane);
    } else {
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        row_rep<P>(a, b, spk, sa2, warp * RPW + i, lane);
    }
    __syncthreads();
  }

  for (int e = tid; e < ROWS * M2 / 4; e += NT) {
    const int rl = e / (M2 / 4), c4 = e % (M2 / 4);
    reinterpret_cast<float4*>(out + row_at(blk, rl))[c4] =
        reinterpret_cast<const float4*>(a + rl * RS)[c4];
  }
}

// ---- micro_pass: K passes of a <- a * 1.0001 + 0.5 ----
constexpr int K_PASSES = 64;
enum { MODE_FLAT = 0, MODE_CHUNK, MODE_STATIC, MODE_CHUNK2D };

// rows [r0, r0 + nrows) of the block's field, a float4 a thread at a time
__device__ __forceinline__ void pass_rows(float4* a4, int r0, int nrows, int tid) {
  for (int e = r0 * (M2 / 4) + tid; e < (r0 + nrows) * (M2 / 4); e += NT) {
    float4 v = a4[e];
    v.x = v.x * 1.0001f + 0.5f;
    v.y = v.y * 1.0001f + 0.5f;
    v.z = v.z * 1.0001f + 0.5f;
    v.w = v.w * 1.0001f + 0.5f;
    a4[e] = v;
  }
}

// MODE_FLAT: the block's rows, then a barrier; MODE_CHUNK / MODE_CHUNK2D: a
// runtime loop over chunks of g rows (layers), a barrier each; MODE_STATIC:
// the same loop over chunks of G rows, unrolled at compile time
template <int MODE, int G>
__global__ void __launch_bounds__(NT, 1)
micro_pass_kernel(int g, const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(16) float a[ROWS * M2];
  float4* a4 = reinterpret_cast<float4*>(a);
  const int tid = threadIdx.x, blk = blockIdx.x;
  for (int e = tid; e < ROWS * M2 / 4; e += NT)
    a4[e] = reinterpret_cast<const float4*>(x + row_at(blk, e / (M2 / 4)))[e % (M2 / 4)];
  __syncthreads();
  for (int pass = 0; pass < K_PASSES; ++pass) {
    if constexpr (MODE == MODE_FLAT) {
      pass_rows(a4, 0, ROWS, tid);
      __syncthreads();
    } else if constexpr (MODE == MODE_STATIC) {
#pragma unroll
      for (int r0 = 0; r0 < ROWS; r0 += G) {
        pass_rows(a4, r0, G, tid);
        __syncthreads();
      }
    } else {
#pragma unroll 1
      for (int r0 = 0; r0 < ROWS; r0 += g) {
        pass_rows(a4, r0, g, tid);
        __syncthreads();
      }
    }
  }
  for (int e = tid; e < ROWS * M2 / 4; e += NT)
    reinterpret_cast<float4*>(out + row_at(blk, e / (M2 / 4)))[e % (M2 / 4)] = a4[e];
}

template <int P>
int launch_ops(int k, const float* x, const float* pk, const float* a2,
               const uint16_t* hiT, const uint16_t* loT, const float* muup,
               float* out, cudaStream_t st) {
  constexpr size_t smem = Smem<P>::bytes;
  cudaError_t e = cudaFuncSetAttribute(micro_ops_kernel<P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  micro_ops_kernel<P><<<NBLK, NT, smem, st>>>(k, x, pk, a2, hiT, loT, muup, out);
  return (int)cudaGetLastError();
}

template <int... PS>
int launch_pattern(int pat, int k, const float* x, const float* pk, const float* a2,
                   const uint16_t* hiT, const uint16_t* loT, const float* muup,
                   float* out, cudaStream_t st, std::integer_sequence<int, PS...>) {
  int rc = (int)cudaErrorInvalidValue;
  ((pat == PS ? (rc = launch_ops<PS>(k, x, pk, a2, hiT, loT, muup, out, st), 0) : 0), ...);
  return rc;
}

}  // namespace

extern "C" {

// pat: index into P_* (ops/micro.py::PATTERNS); k >= 0 reps.  x, out (L, C, M2),
// pk (L, C, 16), a2 (M2, M2) float32; a2_hiT, a2_loT the bf16 parts of a2
// transposed (M2, M2); mu_up (64,) float32.
int sos_micro_ops(int pat, int k, const void* x, const void* pk, const void* a2,
                  const void* a2_hiT, const void* a2_loT, const void* mu_up,
                  void* out, void* stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  return launch_pattern(pat, k, (const float*)x, (const float*)pk, (const float*)a2,
                        (const uint16_t*)a2_hiT, (const uint16_t*)a2_loT,
                        (const float*)mu_up, (float*)out, (cudaStream_t)stream,
                        std::make_integer_sequence<int, N_PAT>());
}

// mode: MODE_* (0 flat, 1 chunk, 2 static, 3 chunk2d); g rows (layers) a
// chunk, a multiple of 8 that divides 64 (static: 8, 16 or 32; flat: any).
int sos_micro_pass(int mode, int g, const void* x, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* xi = (const float*)x;
  float* o = (float*)out;
  const bool chunked = mode == MODE_CHUNK || mode == MODE_CHUNK2D || mode == MODE_STATIC;
  if (chunked && (g < 8 || g % 8 != 0 || ROWS % g != 0)) return (int)cudaErrorInvalidValue;
  if (mode == MODE_FLAT) micro_pass_kernel<MODE_FLAT, 0><<<NBLK, NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_CHUNK) micro_pass_kernel<MODE_CHUNK, 0><<<NBLK, NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_CHUNK2D) micro_pass_kernel<MODE_CHUNK2D, 0><<<NBLK, NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_STATIC && g == 8) micro_pass_kernel<MODE_STATIC, 8><<<NBLK, NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_STATIC && g == 16) micro_pass_kernel<MODE_STATIC, 16><<<NBLK, NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_STATIC && g == 32) micro_pass_kernel<MODE_STATIC, 32><<<NBLK, NT, 0, st>>>(g, xi, o);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
