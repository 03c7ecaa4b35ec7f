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
// in VMEM for all reps; here it lives in shared memory.  Every rep (and
// every micro_pass pass) reads the field from shared memory and writes it
// back: no design carries it in registers from one rep to the next, since
// the tools time exactly that round trip.  Every pattern is row-wise, so
// blocks never meet.
//
// micro_ops: 128 thread blocks (one an SM); block b holds column b / 2's
// layers [64 (b % 2), 64 (b % 2) + 64), 64 rows of 128 lanes, for all reps
// (the TPU kernel's layer chunks are then chunks of a block's rows).  One
// template instantiation a pattern (P_* below), with its own thread shape:
//   fma, rowscalar, rowscalar_slice, lanemask, tworefs, exp, lanebrd,
//     reduce, roll: 256 threads, a warp per row, 4 lanes a thread, as
//     separately rounded multiplies and adds (-fmad=false), as the TPU
//     computes them; the lane sum a warp shuffle tree, the roll a shuffle;
//     a block barrier ends each rep;
//   smooth: the mu->0+ smoothing walk of the resident kernel
//     (sos_tiles.cuh::smooth_up_walk, the same separately rounded
//     operations) on each row's up half (lanes 64-127, mu the up angles of
//     GridSpec(64, 128)), the down half unchanged: one warp a row for all
//     reps, two angles a lane, the first index a warp minimum (redux.sync),
//     no block barrier; 1024 threads, 32 warps of two rows each, so that
//     enough loads are in flight (pass B's own shape, a group of two warps
//     a row and a group minimum through shared memory, cost 16x the rep's
//     bound);
//   matmul: v @ a2 as FP32 FMAs on SIMT, one FMA a k in ascending k (dot_term
//     of mode 'highest'); 128 threads, a thread computes 8 rows x 8
//     columns, loading the rows 4 k at a time and a2's row k over its
//     columns as float4 (2 shared loads for 32 FMAs), no block barrier;
//   matmul_high, matmul_def: v @ a2 on the tensor cores through
//     wgmma.m64n64k16 bf16 with float32 accumulators, one warpgroup a
//     block, the output in two column halves (WgmmaProduct): each rep
//     splits the thread's A fragments of v into bf16 parts x1 + x2 in
//     registers (round half to even, as split_x), which never go back to
//     shared memory; a2's hi + lo (split once by the wrapper, round half to
//     even, as XLA splits both operands for Precision.HIGH) stay in shared
//     memory in wgmma's K-major core-matrix layout for all reps;
//     matmul_high sums hi x1 + hi x2 + lo x1 (bf16x3), matmul_def hi x1
//     alone (one bf16 pass).  A thread reads back exactly the elements its
//     accumulators wrote, so no barrier orders the reps.  Per rep the
//     field's read and write and the B operand's reads put 96 KiB (def)
//     through shared memory, more than the tensor cores' time.
//   tworefs reads the scratch b, which the TPU kernel never writes: b holds
//     NaN, what the JAX kernel reads in interpret mode.
//
// micro_pass: 256 blocks of 128 threads, each half a row (64 lanes) of a
// column's 64 layers (16 KiB), two an SM, so that another block's work
// fills one block's barrier; a thread owns 8 fixed float4s (rows 8 i +
// tid / 16, i = 0..7) and issues a chunk's loads before its first store.
//
// Bound on the H100: per rep the elementwise patterns move 8 MiB through
// shared memory (read + write), against 132 SMs x 128 B per clock; matmul is
// bound by its 268 MFLOP a rep on the FP32 units, matmul_high by its
// 805 MFLOP a rep on the tensor cores.
// Every entry point returns a CUDA error code; the caller raises on non-0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

#include "sos_tiles.cuh"

namespace {

using namespace sos;

constexpr unsigned FULL = 0xffffffffu;
constexpr int L = 128, C = 64, M2 = 128, M = M2 / 2;
constexpr int ROWS = 64;                    // rows a block holds
constexpr int NBLK = L * C / ROWS;          // 128 blocks
constexpr int NT = 256, NWARP = NT / 32;    // the elementwise patterns
constexpr int RPW = ROWS / NWARP;           // rows a warp walks
constexpr int RS = M2 + 8;                  // row stride in shared memory
constexpr int PK = 16;                      // pk values a row
constexpr int SMOOTH_NT = 1024;             // smooth: a warp a row, 2 rows a warp
constexpr int TC_NT = 128;                  // matmul and the products: 16 rows a warp
constexpr int B_BYTES = 2 * M2 * M2;        // a bf16 part of a2 in shared memory

enum { P_FMA = 0, P_ROWSCALAR, P_ROWSCALAR_SLICE, P_LANEMASK, P_TWOREFS, P_EXP,
       P_LANEBRD, P_REDUCE, P_ROLL, P_SMOOTH, P_MATMUL, P_MATMUL_HIGH,
       P_MATMUL_DEF, N_PAT };

template <int P> __host__ __device__ constexpr int threads_of() {
  return P == P_SMOOTH ? SMOOTH_NT : (P >= P_MATMUL) ? TC_NT : NT;
}

// element offset of local row rl of block b in the (L, C, M2) field
__device__ __forceinline__ size_t row_at(int b, int rl) {
  return ((size_t)((b & 1) * ROWS + rl) * C + (b >> 1)) * M2;
}

// shared memory of pattern P, in bytes, and where each part starts (hi and
// lo at multiples of 128 bytes, as wgmma's descriptors take them)
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
  static constexpr size_t lo = hi + (HI ? B_BYTES : 0);
  static constexpr size_t bytes = lo + (LO ? B_BYTES : 0);
  static_assert(!HI || hi % 128 == 0, "wgmma's B operand must start at 128 bytes");
};

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
    for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(FULL, s, o);
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = x[i] + s;
  } else if constexpr (P == P_ROLL) {
    const float next = __shfl_sync(FULL, x[0], (lane + 1) & 31);
    r[0] = x[0] + x[1];
    r[1] = x[1] + x[2];
    r[2] = x[2] + x[3];
    r[3] = x[3] + next;
  }
  *p = make_float4(r[0], r[1], r[2], r[3]);
}

// one rep of smooth on the up halves of R rows (rows w + nw r), one warp a
// row: lane l holds up angles n = 2l, 2l + 1 (their raw mu in mun).  The
// walk of smooth_up_walk with mr = M: the first n in [1, M - 3] whose second
// difference |sv[n] - 2 sv[n+1] + sv[n+2]| is <= 1e-4 (M - 3 if none) gives
// idx = n + 1, the warp's minimum; angles 1 <= n < idx take (1 - w) sv[0] +
// w sv[idx], w = mu_n / mu_idx, the others keep their value.  sv[0] comes
// from lane 0's register, sv[idx] and mu_idx from shared memory (no lane
// changes them).  Each lane stores back both its angles.
template <int R>
__device__ __forceinline__ void smooth_rep(float* a, const float* smu, float2 mun, int w,
                                           int nw, int lane) {
  const int n0 = 2 * lane, n1 = n0 + 1;
  float2* sv[R];
  float2 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sv[r] = reinterpret_cast<float2*>(a + (w + nw * r) * RS + M) + lane;
    v[r] = *sv[r];
  }
  int idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // sv[n0 + 2], sv[n0 + 3] from the next lane (lane 31's angles take no part)
    const float nx = __shfl_down_sync(FULL, v[r].x, 1);
    const float ny = __shfl_down_sync(FULL, v[r].y, 1);
    const float d0 = abs_t(v[r].x - 2.0f * v[r].y + nx);
    const float d1 = abs_t(v[r].y - 2.0f * nx + ny);
    int cand = BIG_ROW;
    if (n1 <= M - 3 && d1 <= 1e-4f) cand = n1;
    if (n0 >= 1 && n0 <= M - 3 && d0 <= 1e-4f) cand = n0;
    idx[r] = min(__reduce_min_sync(FULL, cand), M - 3) + 1;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float s0 = __shfl_sync(FULL, v[r].x, 0);
    const float si = a[(w + nw * r) * RS + M + idx[r]], mi = smu[idx[r]];
    float2 o = v[r];
    if (n0 >= 1 && n0 < idx[r]) {
      const float wt = mun.x / mi;
      o.x = (1.0f - wt) * s0 + wt * si;
    }
    if (n1 < idx[r]) {
      const float wt = mun.y / mi;
      o.y = (1.0f - wt) * s0 + wt * si;
    }
    __syncwarp();
    *sv[r] = o;
  }
}

// one rep of matmul (SIMT FMA), 128 threads: warp w computes rows 16 w ..
// 16 w + 15 as two groups of 8 (lanes 0-15 and 16-31), lane % 16 = c the
// columns 4c .. 4c + 3 and 64 + 4c .. 64 + 4c + 3; every output sums over k
// in ascending order, one FMA a k.  A thread loads its rows 4 k at a time
// and a2's row k over its columns as float4: 16 shared loads for 256 FMAs.
// The warp reads only its own rows.
__device__ __forceinline__ void matmul_rep(float* a, const float* a2, int warp, int lane) {
  const int c = lane & 15, row0 = 16 * warp + 8 * (lane >> 4);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k0 = 0; k0 < M2; k0 += 4) {
    float4 wv[4][2], xv[8];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wv[kk][0] = *reinterpret_cast<const float4*>(a2 + (k0 + kk) * M2 + 4 * c);
      wv[kk][1] = *reinterpret_cast<const float4*>(a2 + (k0 + kk) * M2 + M + 4 * c);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) xv[i] = *reinterpret_cast<const float4*>(a + (row0 + i) * RS + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float w8[8] = {wv[kk][0].x, wv[kk][0].y, wv[kk][0].z, wv[kk][0].w,
                           wv[kk][1].x, wv[kk][1].y, wv[kk][1].z, wv[kk][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x4[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
        const float x[1] = {x4[kk]};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = dot_term<float, MM_HIGHEST>(acc[i][j], w8[j], 0.0f, x);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* r = a + (row0 + i) * RS;
    *reinterpret_cast<float4*>(r + 4 * c) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(r + M + 4 * c) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ---- the products on wgmma ----
constexpr int B_LBO = 128;                  // bytes between k-adjacent core matrices
constexpr int B_SBO = (M2 / 8) * 128;       // bytes between n-adjacent ones
constexpr int HN = M2 / 2;                  // columns of an output half (wgmma's N)
constexpr int NACC = HN / 2;                // a thread's accumulators of a half
constexpr int KSTEPS = M2 / 16;             // k16 steps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of column n, 16-byte k-chunk c of a2's bf16 part in the
// no-swizzle K-major core-matrix layout (8 columns x 16 bytes contiguous)
__device__ __forceinline__ int b_at(int n, int c) {
  return ((n >> 3) * (M2 / 8) + c) * 128 + (n & 7) * 16;
}

// wgmma shared-memory descriptor of the K-major, no-swizzle B tile at saddr
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)(B_LBO >> 4) << 16) |
         ((uint64_t)(B_SBO >> 4) << 32);
}

// a float2 of the field read from shared memory, also where this thread
// stored it last: a volatile load, which ptxas performs (a plain load of a
// value the thread has just stored it may take from the store's
// registers); the clobber keeps the compiler's stores before it
__device__ __forceinline__ float2 lds_f2(const float* p) {
  float2 v;
  asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(smem_u32(p)) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<const uint32_t*>(&p);
}

// keep the compiler from moving accesses to the accumulators across the
// asynchronous wgmmas that write them
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 of the warpgroup) = a (64 x 16, registers) . B (16 x 64 at
// desc), plus d where acc != 0
__device__ __forceinline__ void wgmma_64(float (&d)[NACC], const uint32_t (&a)[4],
                                         uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// matmul_high (X3) or matmul_def on wgmma, one warpgroup: warp w holds rows
// 16 w .. 16 w + 15.  The output is two column halves of 64, each its own
// accumulators and commit group, so that half 0's stores and the next rep's
// first splits run while half 1's wgmmas do.  A fragment register q of k16
// step ks holds row g + 8 (q & 1), columns 16 ks + 2t, + 1 (+ 8 for q >= 2),
// split into bf16 parts x1, x2 (round half to even: x1 by one packing
// conversion, x2 from the exact remainder) in one of two register sets, the
// next rep's set filled while this rep's wgmmas read the other; accumulator
// 4j + e of half h is row g + 8 (e >> 1), column 64 h + 8j + 2t + (e & 1).
// A thread reads back exactly the elements its accumulators wrote, so no
// barrier orders the reps; that read is a volatile load (lds_f2), so the
// compiler cannot hand a stored value to it in registers.
template <bool X3>
struct WgmmaProduct {
  float* a;
  uint32_t hi_s, lo_s;
  int g, t, r0;
  float acc[2][NACC];
  uint32_t x1[2][KSTEPS][4], x2[2][X3 ? KSTEPS : 1][4];

  __device__ __forceinline__ WgmmaProduct(float* a_, uint32_t hi, uint32_t lo, int warp, int lane)
      : a(a_), hi_s(hi), lo_s(lo), g(lane >> 2), t(lane & 3), r0(16 * warp) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[h][i] = 0.0f;
  }

  __device__ __forceinline__ void split(int b, int ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + g + 8 * (q & 1), col = 16 * ks + 2 * t + 8 * (q >> 1);
      const float2 v = lds_f2(a + row * RS + col);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(v.x, v.y);
      x1[b][ks][q] = *reinterpret_cast<const uint32_t*>(&p1);
      if constexpr (X3) {
        const float2 f = __bfloat1622float2(p1);
        x2[b][ks][q] = pack_bf16(v.x - f.x, v.y - f.y);
      }
    }
  }

  // acc[h] (+)= x . a2[:, 64 h ..] at k16 step ks: hi x1 (, hi x2, lo x1)
  __device__ __forceinline__ void mma(int b, int h, int ks) {
    const uint32_t off = ks * 2 * B_LBO + h * (HN / 8) * B_SBO;
    wgmma_64(acc[h], x1[b][ks], b_desc(hi_s + off), ks);
    if constexpr (X3) {
      wgmma_64(acc[h], x2[b][ks], b_desc(hi_s + off), 1);
      wgmma_64(acc[h], x1[b][ks], b_desc(lo_s + off), 1);
    }
  }

  __device__ __forceinline__ void store(int h) {
#pragma unroll
    for (int j = 0; j < HN / 8; ++j) {
      const int col = HN * h + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(a + (r0 + g) * RS + col) =
          make_float2(acc[h][4 * j], acc[h][4 * j + 1]);
      *reinterpret_cast<float2*>(a + (r0 + g + 8) * RS + col) =
          make_float2(acc[h][4 * j + 2], acc[h][4 * j + 3]);
    }
  }

  // one rep from fragment set b; with more, the next rep's set b ^ 1 is
  // split from the field this rep writes (half h's columns are steps 4h ..
  // 4h + 3)
  __device__ __forceinline__ void rep(int b, bool more) {
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) mma(b, h, ks);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc[0]);
    store(0);
    if (more) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS / 2; ++ks) split(b ^ 1, ks);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc[1]);
    store(1);
    if (more) {
#pragma unroll
      for (int ks = KSTEPS / 2; ks < KSTEPS; ++ks) split(b ^ 1, ks);
    }
  }

  // k reps: the sets alternate, so the loop walks two reps at a time
  __device__ __forceinline__ void run(int k) {
    if (k > 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) split(0, ks);
    }
    for (int r = 0; r < k; r += 2) {
      rep(0, r + 1 < k);
      if (r + 1 < k) rep(1, r + 2 < k);
      __syncwarp();
    }
  }
};

template <int P>
__global__ void __launch_bounds__(threads_of<P>(), 1)
micro_ops_kernel(int k, const float* __restrict__ x, const float* __restrict__ pk,
                 const float* __restrict__ a2, const uint16_t* __restrict__ hiT,
                 const uint16_t* __restrict__ loT, const float* __restrict__ muup,
                 float* __restrict__ out) {
  using S = Smem<P>;
  constexpr int NTP = threads_of<P>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* a = reinterpret_cast<float*>(smem + S::a);
  float* b = reinterpret_cast<float*>(smem + S::b);
  float* spk = reinterpret_cast<float*>(smem + S::pk);
  float* sa2 = reinterpret_cast<float*>(smem + S::a2);
  float* smu = reinterpret_cast<float*>(smem + S::mu);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, blk = blockIdx.x;

  // a <- x (and what the pattern reads besides)
  for (int e = tid; e < ROWS * M2 / 4; e += NTP) {
    const int rl = e / (M2 / 4), c4 = e % (M2 / 4);
    reinterpret_cast<float4*>(a + rl * RS)[c4] =
        reinterpret_cast<const float4*>(x + row_at(blk, rl))[c4];
    if constexpr (S::TWO)
      reinterpret_cast<float4*>(b + rl * RS)[c4] =
          make_float4(__int_as_float(0x7fc00000), __int_as_float(0x7fc00000),
                      __int_as_float(0x7fc00000), __int_as_float(0x7fc00000));
  }
  if constexpr (S::PKR)
    for (int e = tid; e < ROWS * PK; e += NTP)
      spk[e] = pk[row_at(blk, e / PK) / M2 * PK + e % PK];
  if constexpr (S::A2)
    for (int e = tid; e < M2 * M2; e += NTP) sa2[e] = a2[e];
  if constexpr (S::A2ROW)
    for (int e = tid; e < M2; e += NTP) sa2[e] = a2[e];
  if constexpr (S::MU)
    for (int e = tid; e < M; e += NTP) smu[e] = muup[e];
  if constexpr (S::HI) {
    // a2's parts, transposed (column n's 128 k contiguous), 16 bytes at a time
    for (int e = tid; e < M2 * M2 / 8; e += NTP) {
      const int n = e / (M2 / 8), c = e % (M2 / 8);
      *reinterpret_cast<uint4*>(smem + S::hi + b_at(n, c)) =
          reinterpret_cast<const uint4*>(hiT)[e];
      if constexpr (S::LO)
        *reinterpret_cast<uint4*>(smem + S::lo + b_at(n, c)) =
            reinterpret_cast<const uint4*>(loT)[e];
    }
    // the stores above before the async proxy (wgmma) reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if constexpr (P == P_SMOOTH) {
    constexpr int NW = SMOOTH_NT / 32;
    const float2 mun = reinterpret_cast<const float2*>(smu)[lane];
    for (int rep = 0; rep < k; ++rep) {
      smooth_rep<ROWS / NW>(a, smu, mun, warp, NW, lane);
      __syncwarp();
    }
  } else if constexpr (P == P_MATMUL) {
    for (int rep = 0; rep < k; ++rep) {
      matmul_rep(a, sa2, warp, lane);
      __syncwarp();
    }
  } else if constexpr (P == P_MATMUL_HIGH || P == P_MATMUL_DEF) {
    WgmmaProduct<P == P_MATMUL_HIGH> prod(a, smem_u32(smem + S::hi), smem_u32(smem + S::lo),
                                          warp, lane);
    prod.run(k);
  } else {
    for (int rep = 0; rep < k; ++rep) {
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        row_rep<P>(a, b, spk, sa2, warp * RPW + i, lane);
      __syncthreads();
    }
  }
  __syncthreads();

  for (int e = tid; e < ROWS * M2 / 4; e += NTP) {
    const int rl = e / (M2 / 4), c4 = e % (M2 / 4);
    reinterpret_cast<float4*>(out + row_at(blk, rl))[c4] =
        reinterpret_cast<const float4*>(a + rl * RS)[c4];
  }
}

// ---- micro_pass: K passes of a <- a * 1.0001 + 0.5 ----
constexpr int K_PASSES = 64;
enum { MODE_FLAT = 0, MODE_CHUNK, MODE_STATIC, MODE_CHUNK2D };
constexpr int PASS_LANES = 64;                            // lanes a block holds
constexpr int PASS_NBLK = L * C * M2 / (ROWS * PASS_LANES);   // 256 blocks
constexpr int PASS_NT = 128;
constexpr int ROW4 = PASS_LANES / 4;                      // float4s a row
constexpr int SWEEP_ROWS = PASS_NT / ROW4;                // rows one float4 a thread covers: 8
constexpr int PASS_V4 = ROWS / SWEEP_ROWS;                // float4s a thread owns: 8

// element offset of row rl, float4 c4 of block b: layers 64 (b % 2) + rl,
// column b / 4, lanes 64 ((b / 2) % 2) + 4 c4
__device__ __forceinline__ size_t pass_at(int b, int rl, int c4) {
  return ((size_t)((b & 1) * ROWS + rl) * C + (b >> 2)) * M2 + ((b >> 1) & 1) * PASS_LANES +
         4 * c4;
}

// the thread's N float4s from i0 (rows 8 i + tid / 16): every load, then
// every store
template <int N>
__device__ __forceinline__ void pass_chunk(float4* a4, int i0, int tid) {
  float4 v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = a4[(i0 + j) * PASS_NT + tid];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    v[j].x = v[j].x * 1.0001f + 0.5f;
    v[j].y = v[j].y * 1.0001f + 0.5f;
    v[j].z = v[j].z * 1.0001f + 0.5f;
    v[j].w = v[j].w * 1.0001f + 0.5f;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) a4[(i0 + j) * PASS_NT + tid] = v[j];
}

// a runtime loop over chunks of g = 8 N rows, a barrier after each
template <int N>
__device__ __forceinline__ void pass_chunks(float4* a4, int g, int tid) {
#pragma unroll 1
  for (int r0 = 0; r0 < ROWS; r0 += g) {
    pass_chunk<N>(a4, r0 / SWEEP_ROWS, tid);
    __syncthreads();
  }
}

// MODE_FLAT: the block's rows, then a barrier; MODE_CHUNK / MODE_CHUNK2D: a
// runtime loop over chunks of g rows (layers), a barrier each, the chunk's
// body compiled for its width (as the TPU kernel's chunk is a static slice
// in a runtime loop); MODE_STATIC: the same loop over chunks of G rows,
// unrolled at compile time
template <int MODE, int G>
__global__ void __launch_bounds__(PASS_NT)
micro_pass_kernel(int g, const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(16) float4 a4[ROWS * ROW4];
  const int tid = threadIdx.x, blk = blockIdx.x;
  for (int e = tid; e < ROWS * ROW4; e += PASS_NT)
    a4[e] = *reinterpret_cast<const float4*>(x + pass_at(blk, e / ROW4, e % ROW4));
  __syncthreads();
#pragma unroll 1
  for (int pass = 0; pass < K_PASSES; ++pass) {
    if constexpr (MODE == MODE_FLAT) {
      pass_chunk<PASS_V4>(a4, 0, tid);
      __syncthreads();
    } else if constexpr (MODE == MODE_STATIC) {
#pragma unroll
      for (int r0 = 0; r0 < ROWS; r0 += G) {
        pass_chunk<G / SWEEP_ROWS>(a4, r0 / SWEEP_ROWS, tid);
        __syncthreads();
      }
    } else if (g == SWEEP_ROWS) {
      pass_chunks<1>(a4, g, tid);
    } else if (g == 2 * SWEEP_ROWS) {
      pass_chunks<2>(a4, g, tid);
    } else if (g == 4 * SWEEP_ROWS) {
      pass_chunks<4>(a4, g, tid);
    } else {
      pass_chunks<8>(a4, g, tid);
    }
  }
  for (int e = tid; e < ROWS * ROW4; e += PASS_NT)
    *reinterpret_cast<float4*>(out + pass_at(blk, e / ROW4, e % ROW4)) = a4[e];
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
  micro_ops_kernel<P><<<NBLK, threads_of<P>(), smem, st>>>(k, x, pk, a2, hiT, loT, muup, out);
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
  if (mode == MODE_FLAT) micro_pass_kernel<MODE_FLAT, 0><<<PASS_NBLK, PASS_NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_CHUNK) micro_pass_kernel<MODE_CHUNK, 0><<<PASS_NBLK, PASS_NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_CHUNK2D) micro_pass_kernel<MODE_CHUNK2D, 0><<<PASS_NBLK, PASS_NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_STATIC && g == 8) micro_pass_kernel<MODE_STATIC, 8><<<PASS_NBLK, PASS_NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_STATIC && g == 16) micro_pass_kernel<MODE_STATIC, 16><<<PASS_NBLK, PASS_NT, 0, st>>>(g, xi, o);
  else if (mode == MODE_STATIC && g == 32) micro_pass_kernel<MODE_STATIC, 32><<<PASS_NBLK, PASS_NT, 0, st>>>(g, xi, o);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
