// Tensor-core quad product of the resident whole-loop kernel (sos_mega,
// mega_body.cuh) in float32 modes bf16x3 and bf16x5.
//
// It computes what quad_gemm_tile (sos_tiles.cuh) computes,
//   out_q[r, n] = sum_j W[q*Mp + n, j] * X[r, j],   q = 0..3, r < R, n < Mp,
// for the resident kernel's two products, the counterparts of the TPU
// kernel _mega_kernel's passA and pre with _dot3
// (sos_rt_tpu/ops/megakernel.py:126, 376, 448):
//   the J_n source product of every order  X = [fdn | fup], K = 2Mp;
//   the I1 surface product of the first    X = e^{tau* . ivup_j} (0 at j = 0),
//   order (Lambertian only)                K = Mp (0 when specular).
// It takes the same split terms as tc::quad_mma (quad_mma.cuh), the streamed
// passes' mainloop: W = hi + lo split by the host, x = x1 + x2 (+ x3) split
// here round half to even (split_x); per k16 block hi.x1, hi.x2 (, hi.x3),
// then lo.x1 (, lo.x2), k ascending.  Each bf16 x bf16 product is exact in
// float32, so only the order and rounding of the float32 sums differ from
// quad_gemm_tile's.  Unlike quad_mma.cuh, each k16 block's terms go into a
// fresh accumulator whose sum is then added to the running float32 sum,
// rounded to nearest: a tensor-core instruction adds its products to the
// accumulator it is given aligned to the largest and truncated, so summing
// straight into the running sum cuts every block's terms at the running
// sum's exponent.  On an H100 that moved more of the smoothing walk's
// threshold decisions away from the plain version's, past what
// tests/test_torch_cuda.py::test_mega_call_matches_plain allows, for a few
// percent less time.
//
// Bound on the H100: operations.  At the 64x128 sweep grid (4 columns a
// tile: R = 512 rows, K = 128, N = 4Mp = 256) the source product is
// 3 x 33.6 MFLOP of bf16 work a tile and order against 0.38 MB of operands
// that stay in L2 (the planes of the tile, the operator copy).
//
// Why not quad_mma.cuh's mainloop: that kernel holds 128 accumulators a
// thread at one CTA an SM, while the resident kernel keeps two blocks an SM
// at 128 registers a thread (__launch_bounds__(256, 2)), so that one block's
// product overlaps the other's serial pass-B walk.  This is a device
// function that all 256 threads of the block call together between the
// barriers the order loop already has:
// - mma.sync.m16n8k16 bf16 with float32 accumulators.  A warp computes 32
//   rows x 8 angles x the four quads (2 x 4 m16n8 tiles): 32 accumulators a
//   thread, and the four quads of the same (r, n) in the same thread, so the
//   epilogue functors (EpiSource, EpiFirstOrder) run on the registers
//   unchanged.  A block step is 64 rows x 32 angles (2 x 4 warps); the steps
//   cover R x Mp, each over k-tiles of BK = 32.
// - W is the bf16 copy (2, 4Mp, Kp) that StreamOps builds for the streamed
//   passes (K zero-padded to Kp, a multiple of BK): each k-tile's hi and lo
//   of the step's 128 operator rows are copied into shared memory by 16-byte
//   cp.async (zero-filled past Mp).
// - X is read as float32 into registers, split into its bf16 parts there
//   and stored in shared memory as parts: each value is split once a block
//   step, where fragments built from a float32 tile would split it once in
//   each of the four warps that read its row.
// - Two stages: the next k-tile's copies and X loads are issued before the
//   tensor cores run on this one, its split and stores after them; one
//   block barrier a k-tile.  61,440 bytes of dynamic shared memory in
//   bf16x3, 71,680 in bf16x5, beside pass B's rows: two blocks fit an SM.
#pragma once
#include <stdint.h>

#include <type_traits>

#include "sos_tiles.cuh"

namespace sos {
namespace rmma {

constexpr int NT = 256;                   // the block's threads: 8 warps
constexpr int BM = 64, BN = 32, BK = 32;  // a step's rows and angles; the k-tile
constexpr int WROWS = 4 * BN;             // operator rows of a step
constexpr int ROW_BYTES = (BK + 8) * 2;   // a bf16 row in shared memory, padded

template <int MODE> struct Layout {
  static constexpr int NX = Parts<MODE>::NX;
  static constexpr int W_PART = WROWS * ROW_BYTES;    // hi (or lo) of a stage
  static constexpr int X_PART = BM * ROW_BYTES;       // one bf16 part of X
  static constexpr int STAGE = 2 * W_PART + NX * X_PART;
  static constexpr int BYTES = 2 * STAGE;
};

// whether mega_kernel<T, MODE, NTHREADS> runs its products here: float32
// with a bf16 split and the 256-thread block (Mp <= 256); float64, 'highest'
// and the 512-thread block keep quad_gemm_tile
template <typename T, int MODE, int NTHREADS>
__host__ __device__ constexpr bool takes_tc() {
  return std::is_same<T, float>::value && MODE != MM_HIGHEST && NTHREADS == NT;
}

// the dynamic shared memory of the product (0 where it does not run here)
template <typename T, int MODE, int NTHREADS>
__host__ __device__ constexpr size_t smem_bytes() {
  if constexpr (takes_tc<T, MODE, NTHREADS>()) return Layout<MODE>::BYTES;
  else return 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// two floats exact in bf16 as one bf16x2 register, a in the low half
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// X[r, j .. j + 3], zero outside R x K (K is a multiple of 8, so a quad is
// inside or outside whole); the field planes as float4 (Mp % 8 == 0)
template <class Loader>
__device__ __forceinline__ float4 fetch4(const Loader& ld, int r, int j, int R, int K) {
  if (r >= R || j >= K) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (std::is_same<Loader, LoadFields<float>>::value) {
    const float* p = j < ld.Mp ? ld.fdn + (size_t)r * ld.Mp + j
                               : ld.fup + (size_t)r * ld.Mp + (j - ld.Mp);
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(ld(r, j), ld(r, j + 1), ld(r, j + 2), ld(r, j + 3));
  }
}

// the bf16 parts of X[row, 4c .. 4c + 3] of a step into the stage's X parts
template <int MODE>
__device__ __forceinline__ void store_x(unsigned char* xs, int row, int c, float4 v) {
  constexpr int NX = Parts<MODE>::NX;
  float p0[3], p1[3], p2[3], p3[3];
  split_x<float, MODE>(v.x, p0);
  split_x<float, MODE>(v.y, p1);
  split_x<float, MODE>(v.z, p2);
  split_x<float, MODE>(v.w, p3);
#pragma unroll
  for (int h = 0; h < NX; ++h)
    *reinterpret_cast<uint2*>(xs + h * Layout<MODE>::X_PART + row * ROW_BYTES + 8 * c) =
        make_uint2(pack2(p0[h], p1[h]), pack2(p2[h], p3[h]));
}

// cp.async of the k-tile k0 of the operator rows (part, q*Mp + n0 + nn),
// nn < BN, into the stage at wbase
template <int MODE>
__device__ __forceinline__ void issue_w(const uint16_t* wtc, uint32_t wbase, int Mp, int Kp,
                                        int n0, int k0, int tid) {
  constexpr int CH = BK / 8;                     // 16-byte chunks a row
#pragma unroll
  for (int s = 0; s < 2 * WROWS * CH / NT; ++s) {
    const int e = tid + s * NT;
    const int c = e % CH, row = (e / CH) % WROWS, part = e / (CH * WROWS);
    const int n = n0 + row % BN;
    const bool ok = n < Mp;
    const size_t grow = (size_t)part * 4 * Mp + (row / BN) * Mp + (ok ? n : 0);
    cp_async16(wbase + part * Layout<MODE>::W_PART + row * ROW_BYTES + 16 * c,
               wtc + grow * Kp + k0 + 8 * c, ok);
  }
}

// the warp's 2 x 4 m16n8 tiles over the stage's k-tile: rows 32 wr + 16 mt
// (+ g, + 8), angles 8 wa (+ g of B, 2t of C), quad q
template <int MODE>
__device__ __forceinline__ void compute(const unsigned char* st, float (&acc)[2][4][4],
                                        int wr, int wa, int g, int t) {
  constexpr int NX = Parts<MODE>::NX;
  using LY = Layout<MODE>;
  const unsigned char* xs = st + 2 * LY::W_PART;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    // A fragments: register i holds row g + 8 (i & 1), columns 2t, 2t + 1
    // (+ 8 for i >= 2) of part h
    uint32_t xa[2][NX][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < NX; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 32 * wr + 16 * mt + g + 8 * (i & 1);
          const int k = 16 * ks + 2 * t + 8 * (i >> 1);
          xa[mt][h][i] =
              *reinterpret_cast<const uint32_t*>(xs + h * LY::X_PART + row * ROW_BYTES + 2 * k);
        }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // B fragments: operator row q BN + 8 wa + g, k 2t, 2t + 1 (+ 8)
      const unsigned char* wb = st + (q * BN + 8 * wa + g) * ROW_BYTES + 2 * (16 * ks + 2 * t);
      const uint32_t h0 = *reinterpret_cast<const uint32_t*>(wb);
      const uint32_t h1 = *reinterpret_cast<const uint32_t*>(wb + 16);
      const uint32_t l0 = *reinterpret_cast<const uint32_t*>(wb + LY::W_PART);
      const uint32_t l1 = *reinterpret_cast<const uint32_t*>(wb + LY::W_PART + 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // the k16 block's terms into a fresh accumulator, then its sum
        // into the running one, rounded to nearest
        float blk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < NX; ++h) mma(blk, xa[mt][h], h0, h1);
#pragma unroll
        for (int h = 0; h + 1 < NX; ++h) mma(blk, xa[mt][h], l0, l1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][q][e] = acc[mt][q][e] + blk[e];
      }
    }
  }
}

// The quad product over R x Mp into epi(r, n, out_0, out_1, out_2, out_3),
// by all NT threads of the block together (it holds block barriers); wtc is
// the (2, 4Mp, Kp) bf16 operator copy, Kp = K rounded up to BK (unread when
// K = 0).  Returns after a block barrier, its shared memory free.
template <int MODE, class Loader, class Epi>
__device__ __forceinline__ void quad_tile(const Loader& ld, const Epi& epi,
                                          const uint16_t* __restrict__ wtc, int R, int Mp,
                                          int K, int tid) {
  extern __shared__ __align__(128) unsigned char rmma_smem[];
  using LY = Layout<MODE>;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wa = warp & 3;
  const int KT = (K + BK - 1) / BK, Kp = KT * BK;
  const int nsn = (Mp + BN - 1) / BN, nsteps = (R + BM - 1) / BM * nsn;

  float acc[2][4][4];
  auto zero = [&] {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.0f;
  };
  // accumulator e of tile (mt, q): row g + 8 (e >> 1), angle 2t + (e & 1)
  auto epilogue = [&](int s) {
    const int r0 = (s / nsn) * BM + 32 * wr, n0 = (s % nsn) * BN + 8 * wa + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 16 * mt + g + 8 * (e >> 1), n = n0 + (e & 1);
        if (r < R && n < Mp)
          epi(r, n, acc[mt][0][e], acc[mt][1][e], acc[mt][2][e], acc[mt][3][e]);
      }
  };
  zero();
  if (KT == 0) {                      // no product (a specular surface)
    for (int s = 0; s < nsteps; ++s) epilogue(s);
    __syncthreads();
    return;
  }

  // X of the step's rows: thread quad u covers row (tid + u NT) / 8,
  // columns 4 ((tid + u NT) % 8) .. + 3 of the k-tile
  float4 xr[BM * BK / (4 * NT)];
  auto fetch = [&](int s, int kt) {
    const int r0 = (s / nsn) * BM;
#pragma unroll
    for (int u = 0; u < BM * BK / (4 * NT); ++u) {
      const int e = tid + u * NT;
      xr[u] = fetch4(ld, r0 + e / (BK / 4), kt * BK + 4 * (e % (BK / 4)), R, K);
    }
  };
  auto put = [&](int buf) {
    unsigned char* xs = rmma_smem + buf * LY::STAGE + 2 * LY::W_PART;
#pragma unroll
    for (int u = 0; u < BM * BK / (4 * NT); ++u) {
      const int e = tid + u * NT;
      store_x<MODE>(xs, e / (BK / 4), e % (BK / 4), xr[u]);
    }
  };
  const uint32_t base = smem_u32(rmma_smem);
  auto issue = [&](int buf, int s, int kt) {
    issue_w<MODE>(wtc, base + buf * LY::STAGE, Mp, Kp, (s % nsn) * BN, kt * BK, tid);
  };

  issue(0, 0, 0);
  cp_async_commit();
  fetch(0, 0);
  put(0);
  cp_async_wait_all();
  __syncthreads();
  int s = 0, kt = 0;
  for (int i = 0; i < nsteps * KT; ++i) {
    int s1 = s, kt1 = kt + 1;
    if (kt1 == KT) {
      kt1 = 0;
      ++s1;
    }
    const bool more = s1 < nsteps;
    if (more) {                       // the next k-tile, into the other stage
      issue((i + 1) & 1, s1, kt1);
      fetch(s1, kt1);
    }
    cp_async_commit();
    compute<MODE>(rmma_smem + (i & 1) * LY::STAGE, acc, wr, wa, g, t);
    if (more) put((i + 1) & 1);
    if (kt == KT - 1) {
      epilogue(s);
      zero();
    }
    cp_async_wait_all();
    __syncthreads();                  // the next stage has landed; this one is free
    s = s1;
    kt = kt1;
  }
}

}  // namespace rmma
}  // namespace sos
