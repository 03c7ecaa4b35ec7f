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
// The three passes are the device functions of sos_tiles.cuh that the
// streamed kernels (megastream.cu) call too, summed in the same order, so
// the resident and the streamed solve agree bit for bit.  The block has one
// thread shape for all of them: NT = 256 threads (512 for Mp > 256).  The
// product uses the first 256 as 16 x 16 workers; pass B splits the block in
// groups of round32(Mp) threads, one column each.
//
// Bound on the H100: operations.  Per column and order the source product
// is 2*(4Mp)*(2Mp)*L operations per bf16 pass (25.2 MFLOP in three passes
// at 64x128) against ~0.3 MB of plane traffic that stays in L2.  The
// product runs on FP32 FMAs (as in the streamed kernels); tensor cores and
// planes in shared memory are later work.
// The entry point returns cudaGetLastError(); the caller raises on non-0.
#include "sos_tiles.cuh"

namespace {

using namespace sos;

constexpr int CB_MAX = 32;      // most columns a tile may hold
// Blocks of 256 threads per SM the compiler must leave registers for: with
// two, one block's product overlaps the other's serial pass-B walk (128
// registers a thread instead of ~200).
constexpr int MIN_BLOCKS_256 = 2;

template <typename T> struct MegaArgs {
  const T *pack, *cpar, *tiles, *colc, *ws_hi, *ws_lo, *astk_hi, *astk_lo;
  const int* tap_col;
  const T *tap_hi, *tap_lo, *pvt, *bct_hi, *bct_lo;
  T* work;            // per resident block: 4 planes of (L, cb, Mp)
  int* counter;       // next tile to take (zero at launch)
  // summary: toa_dn, toa_up, srf_dn, srf_up (Cg, Mp);
  // full: itot_dn, itot_up (L, Cg, Mp), o2/o3 unused
  T *o0, *o1, *o2, *o3;
  T* stats;           // (3, Cg): n, converged, ratio
  int L, Cg, cb, Mp, mr, slot, lamb, full, max_orders;
  double tol;
};

// max that keeps a NaN (as torch.amax / torch.maximum do)
template <typename T> __device__ __forceinline__ T nanmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// max of v over the warps [w0, w0 + nw) of the block (one group)
template <typename T>
__device__ __forceinline__ T group_max(T v, T* sredv, int w0, int nw) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sredv[threadIdx.x >> 5] = v;
  __syncthreads();
  T m = sredv[w0];
  for (int w = 1; w < nw; ++w) m = nanmax(m, sredv[w0 + w]);
  __syncthreads();
  return m;
}

// Adds a column's new order into its totals while the column is active,
// and keeps what the convergence ratio reads: the new and the total
// TOA-up and surface-down values of this thread's angle.
template <typename T> struct Accumulate {
  const MegaArgs<T>& a;
  int c;              // global column
  T active;           // 1 while the column's ratio is >= tol, else 0
  T new_top, tot_top, new_bot, tot_bot;
  __device__ void add(T* tot, size_t o, T v, T& kept) const {
    kept = tot[o] + active * v;
    tot[o] = kept;
  }
  __device__ void operator()(int t, int n, T fv, T sm) {
    const bool top = t == 0, bot = t == a.L - 1;
    T dn = T(0), up = T(0);
    if (a.full) {
      const size_t o = ((size_t)t * a.Cg + c) * a.Mp + n;
      add(a.o0, o, fv, dn);
      add(a.o1, o, sm, up);
    } else if (top || bot) {
      const size_t o = (size_t)c * a.Mp + n;
      add(top ? a.o0 : a.o2, o, fv, dn);
      add(top ? a.o1 : a.o3, o, sm, up);
    }
    if (top) { new_top = sm; tot_top = up; }
    if (bot) { new_bot = fv; tot_bot = dn; }
  }
};

// new / total where the total is not 0, else 0 (megakernel.ratio_rows_tile)
template <typename T> __device__ __forceinline__ T ratio_of(T a, T b) {
  return b != T(0) ? a / b : T(0);
}

template <typename T, int MODE, int NT>
__global__ void __launch_bounds__(NT, NT == 256 ? MIN_BLOCKS_256 : 1)
mega_kernel(const MegaArgs<T> a) {
  __shared__ GemmSmem<T, MODE> gsm;
  __shared__ int sred[32];
  __shared__ T sredv[32];
  __shared__ T s_ratio[CB_MAX], s_n[CB_MAX];
  __shared__ int s_tile;
  extern __shared__ unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const bool worker = tid < TX * TY;
  const int L = a.L, Cg = a.Cg, cb = a.cb, Mp = a.Mp, mr = a.mr;
  // pass B groups: round32(Mp) threads each, one column each
  const int gsize = ((Mp + 31) / 32) * 32, ngroups = NT / gsize;
  const int g = tid / gsize, gt = tid - g * gsize;
  const bool in_group = g < ngroups;
  T* gs = reinterpret_cast<T*>(smem_raw) +
          (in_group ? g : 0) * pass_b_smem_elems<T, MODE>(Mp, a.slot);
  const int w0 = g * (gsize >> 5), nw = gsize >> 5;

  const size_t plane = (size_t)L * cb * Mp;
  T* fdn = a.work + (size_t)blockIdx.x * 4 * plane;
  T* fup = fdn + plane;
  T* sdn = fup + plane;
  T* jnu = sdn + plane;
  const int R = L * cb, ntiles = Cg / cb;
  const T tol = (T)a.tol, seed = (T)(2.0 * a.tol), nmax = (T)a.max_orders;

  for (;;) {
    if (tid == 0) s_tile = atomicAdd(a.counter, 1);
    __syncthreads();
    const int taken = s_tile;
    __syncthreads();
    if (taken >= ntiles) break;
    const int c0 = (ntiles - 1 - taken) * cb;
    const PackMap pm{L, cb, Cg, c0};

    // ---- pre: the closed-form first order I1 into fdn, fup ----
    {
      LoadSurfaceExp<T> ld{a.pack, pm, a.colc + RC_IVUP * Mp};
      EpiFirstOrder<T> epi{a.pack, pm, a.tiles, a.colc, a.cpar, fdn, fup, Mp, mr,
                           a.lamb != 0};
      // a specular surface has no surface-integral product: K = 0
      for (int r0 = 0; r0 < R; r0 += BM)
        for (int n0 = 0; n0 < Mp; n0 += BN)
          quad_gemm_tile<T, MODE>(ld, epi, a.astk_hi, a.astk_lo, R, Mp,
                                  a.lamb ? Mp : 0, r0, n0, tid, worker, gsm);
    }
    __syncthreads();
    // the totals start from I1; ratio above tol, n = 1
    if (a.full) {
      for (size_t i = tid; i < plane; i += NT) {
        const int n = (int)(i % Mp), r = (int)(i / Mp);
        const size_t o = ((size_t)(r / cb) * Cg + c0 + r % cb) * Mp + n;
        a.o0[o] = fdn[i];
        a.o1[o] = fup[i];
      }
    } else {
      const size_t last = (size_t)(L - 1) * cb * Mp;
      for (int i = tid; i < cb * Mp; i += NT) {
        const size_t o = (size_t)c0 * Mp + i;
        a.o0[o] = fdn[i];
        a.o1[o] = fup[i];
        a.o2[o] = fdn[last + i];
        a.o3[o] = fup[last + i];
      }
    }
    if (tid < cb) {
      s_ratio[tid] = seed;
      s_n[tid] = T(1);
    }
    __syncthreads();

    for (;;) {
      // the loop condition, the same in every thread
      bool any = false;
      T nhi = T(0);
      for (int c = 0; c < cb; ++c) {
        any = any || s_ratio[c] >= tol;
        nhi = s_n[c] > nhi ? s_n[c] : nhi;
      }
      if (!(any && nhi < nmax)) break;

      // ---- pass A: source product, then the downward recurrence ----
      {
        LoadFields<T> ld{fdn, fup, Mp};
        EpiSource<T> epi{a.pack, pm, sdn, jnu, Mp};
        for (int r0 = 0; r0 < R; r0 += BM)
          for (int n0 = 0; n0 < Mp; n0 += BN)
            quad_gemm_tile<T, MODE>(ld, epi, a.ws_hi, a.ws_lo, R, Mp, 2 * Mp,
                                    r0, n0, tid, worker, gsm);
      }
      __syncthreads();
      for (int i = tid; i < cb * Mp; i += NT)
        down_scan_one<T>(a.pack, pm, a.colc, sdn, Mp, i / Mp, i % Mp);
      __syncthreads();

      // ---- pass B, a group per column, with the gated accumulation and
      // the convergence ratio of each column ----
      const PassBArgs<T> pb{a.pack, pm, sdn, jnu, a.cpar, a.colc, a.tap_col,
                            a.tap_hi, a.tap_lo, a.pvt, a.bct_hi, a.bct_lo,
                            fdn, fup, Mp, mr, a.slot};
      for (int cl0 = 0; cl0 < cb; cl0 += ngroups) {
        const bool live = in_group && cl0 + g < cb;
        const int cl = live ? cl0 + g : 0;
        const bool act = live && gt < Mp;
        const bool on = live && s_ratio[cl] >= tol;
        Accumulate<T> sink{a, c0 + cl, on ? T(1) : T(0), T(0), T(0), T(0), T(0)};
        pass_b_walk<T, MODE>(pb, cl, live ? gt : Mp, act, gs, sred, w0, nw, sink);
        // pad angles and zero totals count as converged (0); threads
        // without an angle do not count
        T v = -INFINITY;
        if (act)
          v = gt < mr ? nanmax(ratio_of(sink.new_top, sink.tot_top),
                               ratio_of(sink.new_bot, sink.tot_bot))
                      : T(0);
        v = group_max(v, sredv, w0, nw);
        if (on && gt == 0) {
          s_ratio[cl] = v;
          s_n[cl] = s_n[cl] + T(1);
        }
      }
      __syncthreads();
    }

    if (tid < cb) {
      const int c = c0 + tid;
      a.stats[(size_t)ST_N * Cg + c] = s_n[tid];
      a.stats[(size_t)ST_CONV * Cg + c] = s_ratio[tid] < tol ? T(1) : T(0);
      a.stats[(size_t)ST_RATIO * Cg + c] = s_ratio[tid];
    }
  }
}

int threads_for(int Mp) { return Mp <= 256 ? 256 : 512; }

template <typename T, int MODE>
size_t smem_for(int Mp, int slot) {
  const int nt = threads_for(Mp), gsize = ((Mp + 31) / 32) * 32;
  return sizeof(T) * (nt / gsize) * pass_b_smem_elems<T, MODE>(Mp, slot);
}

bool shape_ok(int Mp, int mr, int slot, int cb, int Cg) {
  return Mp >= 8 && Mp <= 512 && mr >= 4 && mr <= Mp && slot <= Mp && cb >= 1 &&
         cb <= CB_MAX && Cg > 0 && Cg % cb == 0;
}

}  // namespace

extern "C" {

// The number of blocks the card keeps resident at once for these shapes
// (the wrapper sizes the workspace by it), or -(CUDA error).
int sos_mega_blocks(int dtype, int mode, int Mp, int slot) {
  if (Mp < 8 || Mp > 512 || slot > Mp) return -(int)cudaErrorInvalidValue;
  const int rc = dispatch(dtype, mode, [&](auto tv, auto mv) {
    using T = decltype(tv);
    constexpr int MODE = decltype(mv)::value;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const size_t smem = smem_for<T, MODE>(Mp, slot);
    if (e == cudaSuccess)
      e = Mp <= 256 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &per_sm, mega_kernel<T, MODE, 256>, 256, smem)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &per_sm, mega_kernel<T, MODE, 512>, 512, smem);
    if (e != cudaSuccess) return -(int)e;
    return per_sm > 0 ? sms * per_sm : -(int)cudaErrorLaunchOutOfResources;
  });
  return rc > 0 ? rc : (rc < 0 ? rc : -(int)cudaErrorInvalidValue);
}

// dtype: 0 float32, 1 float64; mode: 0 highest, 1 bf16x3, 2 bf16x5.
// pack (PK_W, L, Cg), cpar (CP_W, Cg), tiles (NI, Cg, Mp); work holds
// nblocks * 4 * L * cb * Mp elements; counter is one zeroed int.
int sos_mega(int dtype, int mode, int lamb, int full, const void* pack,
             const void* cpar, const void* tiles, const void* colc,
             const void* ws_hi, const void* ws_lo, const void* astk_hi,
             const void* astk_lo, const void* tap_col, const void* tap_hi,
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
    const MegaArgs<T> a{(const T*)pack, (const T*)cpar, (const T*)tiles,
                        (const T*)colc, (const T*)ws_hi, (const T*)ws_lo,
                        (const T*)astk_hi, (const T*)astk_lo,
                        (const int*)tap_col, (const T*)tap_hi, (const T*)tap_lo,
                        (const T*)pvt, (const T*)bct_hi, (const T*)bct_lo,
                        (T*)work, (int*)counter, (T*)o0, (T*)o1, (T*)o2, (T*)o3,
                        (T*)stats, L, Cg, cb, Mp, mr, slot, lamb, full,
                        max_orders, tol};
    const size_t smem = smem_for<T, MODE>(Mp, slot);
    if (Mp <= 256)
      mega_kernel<T, MODE, 256><<<nblocks, 256, smem, st>>>(a);
    else
      mega_kernel<T, MODE, 512><<<nblocks, 512, smem, st>>>(a);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
