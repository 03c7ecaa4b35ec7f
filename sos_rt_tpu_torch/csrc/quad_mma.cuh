// Tensor-core quad product: the mainloop of sos_passA and sos_passI
// (megastream.cu) in float32 modes bf16x3 and bf16x5.
//
// It serves the two TPU kernels whose time is their product:
//   sos_rt_tpu/ops/megastream.py::_passA_kernel  (J_n = W . [I_dn | I_up])
//   sos_rt_tpu/ops/megastream.py::_passI_kernel  (I1's surface product)
// and computes what quad_gemm_tile (sos_tiles.cuh) computes,
//   out_q[r, n] = sum_j W[q*Mp + n, j] * X[r, j],   q = 0..3, r < R, n < Mp,
// from the same split terms: W = hi + lo split by the host, x = x1 + x2
// (+ x3) split here round half to even (split_x); bf16x3 sums hi.x1 + hi.x2
// + lo.x1, bf16x5 adds hi.x3 + lo.x2.  Each bf16 x bf16 product is exact in
// float32, so only the order and rounding of the float32 sums differ from
// quad_gemm_tile's.  float64 and float32 'highest' have no bf16 split and
// stay on quad_gemm_tile (megastream.cu picks at compile time).
//
// Bound on the H100: operations.  At the canonical block (R = L*C =
// 102,400, Mp = 504) passA's product is 3 x 416 GFLOP of bf16 work, 1.26 ms
// at the 989 TFLOP/s dense bf16 peak, against 0.83 GB of compulsory traffic
// (0.25 ms); passI's is half of it.
//
// Design (wgmma bf16 with float32 accumulators; a cp.async ring):
// - A CTA computes BM = 128 rows x BN = 64 angles x the four quads: 256
//   operator rows, q*Mp + n0 .. + 63 for q = 0..3, side by side in shared
//   memory, one wgmma.m64n64k16 a quad.  Two warpgroups (256 threads), 64
//   rows each; a thread holds 128 float32 running sums in wgmma's layout,
//   the four quads of the same (r, n) among them, and 32 more for the k16
//   block of a quad in flight.  One CTA an SM (the ring takes 156 KiB).
// - W comes as the bf16 copy (2, 4Mp, Kp) the host builds once a solve
//   (hi, lo; k contiguous, K zero-padded to Kp, a multiple of BK): K-major
//   rows, the B operand as wgmma reads it.  Each stage holds hi and lo of
//   the 256 rows x BK = 32 in the no-swizzle core-matrix layout (8 rows x 16
//   bytes contiguous; k-adjacent core matrices 128 bytes apart, row groups
//   512), which 16-byte cp.async copies fill directly.
// - A ring of STAGES = 3 stages, filled by cp.async (zero-filled outside
//   the operator and the field), one barrier a k-tile; a proxy fence hands
//   the copies to wgmma's reads.
// - X of passA, [fdn | fup], is copied as float32 into the ring (k below Mp
//   from fdn, the rest from fup; Mp % 4 == 0, so no copy straddles the two).
//   X of passI, e^{tau* . ivup_j} (0 at j = 0), is computed into the ring by
//   the CTA (the accurate expf, as quad_gemm_tile's loader LoadSurfaceExp),
//   once for both warpgroups' use.  Either way each thread splits its rows
//   of X into bf16 A fragments in registers (wgmma takes A from registers):
//   x1, x2 (, x3) never reach memory.
// - Per k16 block and quad, as mega_mma.cuh sums it: hi.x1 (into a fresh
//   block accumulator: scale-d 0), hi.x2 (, hi.x3), then lo.x1 (, lo.x2),
//   one wgmma each, committed as a group; once the group is done, its sum
//   is added to the quad's running float32 sums, rounded to nearest.  A
//   tensor-core instruction adds its products to the accumulator it is
//   given aligned to the largest and truncated, so summing straight into
//   the running sum would cut every block's terms at the running sum's
//   exponent.  The ring's next fill (copies, passI's exponentials) is
//   issued while the k-tile's first group runs.  Every output sums its k16
//   blocks in ascending k, each block in the tensor core's own order: the
//   resident kernel's product gives the same bits.  The tile keeps its
//   128 x 64 extent, as the product is held by the bytes it pulls from L2
//   (each CTA reads its X rows and its operator rows once a k-tile): a
//   32-angle tile, which pulls X twice as often, was slower, and so were
//   two block sets in flight, which spill at 255 registers (PERF.md).
// - The fused and reference engines' split-mode J_n source (fused_source.cu)
//   takes the same mainloop with its own loader and epilogue: LoadFieldRows
//   copies X = [I_dn | I_up] from rows whose stride (M or 2M floats) is no
//   multiple of 4, one float a cp.async, zeros in the pad columns; and it
//   splits x as make_split_dot does (ops/precision.py: x1 ties away from
//   zero by integer masking), not round half to even.  Both choices sit
//   behind `if constexpr` on the loader's type, so passA's and passI's code
//   is what it was.
// - The epilogue stages the four quads' accumulators through shared memory
//   (the ring is free by then), then runs the epilogue functor (EpiSource,
//   EpiFirstOrder) unchanged with consecutive threads on consecutive angles:
//   the field rows it writes and the per-angle tiles it reads are coalesced,
//   and the functor's code is not repeated for each accumulator.
#pragma once
#include <stdint.h>

#include <type_traits>

#include "sos_tiles.cuh"

namespace sos {
namespace tc {

constexpr int BM = 128, BN = 64, BK = 32, STAGES = 3, NT = 256;
constexpr int WROWS = 4 * BN;                 // operator rows of a tile
constexpr int NACC = BN / 2;                  // a thread's accumulators of a quad (wgmma's N = BN)
constexpr int GROUPS = (BK / 16) * 4;         // (k16 block, quad) groups of a k-tile
constexpr int XS = BK + 8;                    // float32 row stride of the X tile
constexpr int ES = BN + 8;                    // float32 row stride of the epilogue tile
constexpr int W_PART = WROWS * BK * 2;        // bytes of hi (or lo) of a stage
constexpr int X_STAGE = BM * XS * 4;          // bytes
constexpr int STAGE = 2 * W_PART + X_STAGE;
constexpr int E_BYTES = 4 * BM * ES * 4;      // the four quads' output tile
// the ring, then the epilogue tile in the same bytes, then BM row scalars
constexpr int ROWS_AT = STAGES * STAGE > E_BYTES ? STAGES * STAGE : E_BYTES;
// core-matrix strides of a W part (bytes): k-adjacent, row-group-adjacent
constexpr int LBO = 128, SBO = (BK / 8) * 128;

// X = [I_dn | I_up] of the fused and reference engines: rows r of two
// float32 fields with M angles each and row strides ld_dn, ld_up (floats),
// placed at k = j (I_dn) and k = Mp + j (I_up), zeros at the pad columns
// [M, Mp) and [Mp + M, 2Mp) where the stacked operator has zero columns too
struct LoadFieldRows {
  const float* dn; const float* up; long long ld_dn, ld_up; int M, Mp;
};

// the loaders whose X is copied into the ring (the others compute it there)
template <class Loader> __host__ __device__ constexpr bool x_by_copy() {
  return std::is_same<Loader, LoadFields<float>>::value ||
         std::is_same<Loader, LoadFieldRows>::value;
}

// float32 rounded to bf16 with ties away from zero by integer masking, as
// ops/precision.py::_hi_f32 (and the JAX package's split_bf16) computes it
__device__ __forceinline__ float hi_away(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x8000u) & 0xFFFF0000u);
}

// x split as the loader's plain version splits it: LoadFieldRows as
// make_split_dot (split_bf16 / split_bf16_3: x1 and bf16x5's x2 ties away,
// the last part round half to even), the others round half to even
// (split_x)
template <class Loader, int MODE>
__device__ __forceinline__ void split_a(float x, float* p) {
  if constexpr (std::is_same<Loader, LoadFieldRows>::value) {
    const float x1 = hi_away(x), r1 = x - x1;
    p[0] = x1;
    if constexpr (MODE == MM_BF16X3) {
      p[1] = bf16r(r1);
    } else {
      const float x2 = hi_away(r1);
      p[1] = x2;
      p[2] = bf16r(r1 - x2);
    }
  } else {
    split_x<float, MODE>(x, p);
  }
}

__host__ __device__ constexpr int smem_bytes() { return ROWS_AT + BM * 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, or 4 zero bytes where !ok (src is not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the thread's shared-memory writes (cp.async included) before the async
// proxy (wgmma) reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of row `row`, 16-byte k-chunk c of a W part tile (quad q
// starts at w_at(BN q, 0))
__device__ __forceinline__ int w_at(int row, int c) {
  return ((row >> 3) * (BK / 8) + c) * 128 + (row & 7) * 16;
}

// wgmma shared-memory descriptor of a K-major, no-swizzle B tile at saddr
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

// two floats exact in bf16 as one bf16x2 register, a in the low half
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
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
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// Fill stage st with k-tile k0: W rows (part, q*Mp + n0 + nn) by cp.async;
// X rows r0 .. r0 + BM by cp.async (passA) or computed (passI: tau* of the
// CTA's rows staged in sastar).
template <class Loader>
__device__ __forceinline__ void load_stage(const Loader& ld, const uint16_t* wb,
                                           unsigned char* st, const float* sastar, int R,
                                           int Mp, int K, int Kp, int r0, int n0, int k0,
                                           int tid) {
  constexpr int WCH = BK / 8;                   // 16-byte chunks a W row
  const uint32_t wbase = smem_u32(st);
#pragma unroll
  for (int s = 0; s < 2 * WROWS * WCH / NT; ++s) {
    const int e = tid + s * NT;
    const int c = e % WCH, row = (e / WCH) % WROWS, part = e / (WCH * WROWS);
    const int n = n0 + row % BN;
    const bool ok = n < Mp;
    const size_t grow = (size_t)part * 4 * Mp + (row / BN) * Mp + (ok ? n : 0);
    cp_async16(wbase + part * W_PART + w_at(row, c), wb + grow * Kp + k0 + 8 * c, ok);
  }
  if constexpr (std::is_same<Loader, LoadFieldRows>::value) {
    // one float a copy (rows start at any float): consecutive threads on
    // consecutive k of a row, so a warp reads 128 contiguous bytes
    const uint32_t xbase = wbase + 2 * W_PART;
#pragma unroll 4
    for (int s = 0; s < BM * BK / NT; ++s) {
      const int e = tid + s * NT;
      const int kk = e % BK, row = e / BK;
      const int r = r0 + row, j = k0 + kk;
      const bool up = j >= ld.Mp;
      const int n = up ? j - ld.Mp : j;
      const bool ok = r < R && n < ld.M;
      const float* src = !ok ? ld.dn
                             : (up ? ld.up + r * ld.ld_up + n : ld.dn + r * ld.ld_dn + n);
      cp_async4(xbase + (row * XS + kk) * 4, src, ok);
    }
  } else if constexpr (x_by_copy<Loader>()) {
    constexpr int XCH = BK / 4;                 // 16-byte chunks an X row
    const uint32_t xbase = wbase + 2 * W_PART;
#pragma unroll
    for (int s = 0; s < BM * XCH / NT; ++s) {
      const int e = tid + s * NT;
      const int c = e % XCH, row = e / XCH;
      const int r = r0 + row, j = k0 + 4 * c;
      const bool ok = r < R && j < K;
      const float* src = !ok ? ld.fdn
                             : (j < ld.Mp ? ld.fdn + (size_t)r * ld.Mp + j
                                          : ld.fup + (size_t)r * ld.Mp + (j - ld.Mp));
      cp_async16(xbase + (row * XS + 4 * c) * 4, src, ok);
    }
  } else {
    // LoadSurfaceExp: X = e^{tau* . ivup_j}, 0 at j = 0 and beyond K; the
    // thread fills column k0 + tid % BK of the rows tid / BK + s NT / BK
    float* xs = reinterpret_cast<float*>(st + 2 * W_PART);
    const int kk = tid % BK, j = k0 + kk;
    const bool zero = j == 0 || j >= K;
    const float iv = zero ? 0.0f : ld.ivup[j];
#pragma unroll 4
    for (int s = 0; s < BM * BK / NT; ++s) {
      const int row = tid / BK + s * (NT / BK);
      xs[row * XS + kk] = zero ? 0.0f : exp_t(sastar[row] * iv);
    }
  }
}

// One BM x BN x 4 tile of the quad product per CTA of NT threads.
template <int MODE, class Loader, class Epi>
__global__ void __launch_bounds__(NT, 1)
quad_mma(Loader ld, Epi epi, const uint16_t* __restrict__ wb, int R, int Mp, int K, int Kp) {
  constexpr int NX = Parts<MODE>::NX;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;                 // the warp's 16 rows (warpgroup warp / 4)
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  float acc[4][NACC], blk[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q][i] = 0.0f;
    blk[i] = 0.0f;
  }

  float* sastar = reinterpret_cast<float*>(smem + ROWS_AT);
  if constexpr (!x_by_copy<Loader>()) {
    for (int i = tid; i < BM; i += NT)
      sastar[i] = r0 + i < R ? ld.pack[ld.pm.pk(PK_ASTAR, r0 + i)] : 0.0f;
    __syncthreads();
  }
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage(ld, wb, smem + s * STAGE, sastar, R, Mp, K, Kp, r0, n0, s * BK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();          // tile kt has landed; stage (kt - 1) % STAGES is free
    unsigned char* st = smem + (kt % STAGES) * STAGE;
    const uint32_t wst = smem_u32(st);
    const float* xs = reinterpret_cast<const float*>(st + 2 * W_PART);
    // A fragments of the k16 blocks ks: register i holds row g + 8 (i & 1),
    // columns 2t, 2t + 1 (+ 8 for i >= 2), split into NX bf16 parts
    uint32_t xa[BK / 16][NX][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wr + g + 8 * (i & 1), col = 16 * ks + 2 * t + 8 * (i >> 1);
        const float2 v = *reinterpret_cast<const float2*>(xs + row * XS + col);
        float p0[3], p1[3];
        split_a<Loader, MODE>(v.x, p0);
        split_a<Loader, MODE>(v.y, p1);
#pragma unroll
        for (int h = 0; h < NX; ++h) xa[ks][h][i] = pack2(p0[h], p1[h]);
      }
    // group u: the k16 block u / 4 of quad u % 4 into blk (k-chunks 2 ks,
    // 2 ks + 1 of hi and lo, operator rows BN q ..)
    auto issue = [&](int u) {
      const int ks = u / 4, q = u % 4;
      const uint32_t at = wst + 2 * ks * LBO + w_at(BN * q, 0);
      const uint64_t dhi = b_desc(at), dlo = b_desc(at + W_PART);
      fence_acc(blk);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int x = 0; x < NX; ++x) wgmma_64(blk, xa[ks][x], dhi, x);
#pragma unroll
      for (int x = 0; x + 1 < NX; ++x) wgmma_64(blk, xa[ks][x], dlo, 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    issue(0);
    // fill the stage tile kt - 1 used while the tensor cores work
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage(ld, wb, smem + (nk % STAGES) * STAGE, sastar, R, Mp, K, Kp, r0, n0,
                 nk * BK, tid);
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < GROUPS; ++u) {
      // group u's sum into quad u % 4's running sums
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(blk);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[u % 4][i] = acc[u % 4][i] + blk[i];
      if (u + 1 < GROUPS) issue(u + 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // every warp is done with the ring

  // accumulators 4j + e of quad q: row g + 8 (e >> 1), angle 8j + 2t +
  // (e & 1) of the warpgroup's 64 x BN tile; staged as es[q][row][nn]
  float* es = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = wr + g + 8 * e, nn = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(es + (q * BM + row) * ES + nn) =
            make_float2(acc[q][4 * j + 2 * e], acc[q][4 * j + 2 * e + 1]);
      }
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < BM * BN; i += NT) {
    const int row = i / BN, nn = i % BN, r = r0 + row, n = n0 + nn;
    const float* e = es + row * ES + nn;
    if (r < R && n < Mp) epi(r, n, e[0], e[BM * ES], e[2 * BM * ES], e[3 * BM * ES]);
  }
}

// Launch the product on stream st; wb is the (2, 4Mp, Kp) bf16 operator
// copy (unread, and may be null, when K = 0).  Returns a CUDA error code.
template <int MODE, class Loader, class Epi>
int launch(const Loader& ld, const Epi& epi, const void* wb, int R, int Mp, int K, int Kp,
           cudaStream_t st) {
  if (Mp % 8 != 0 || (K > 0 && (wb == nullptr || Kp < K || Kp % BK != 0)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Mp + BN - 1) / BN, (R + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes();
  auto kern = quad_mma<MODE, Loader, Epi>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, NT, smem, st>>>(ld, epi, static_cast<const uint16_t*>(wb), R, Mp, K, Kp);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace sos
