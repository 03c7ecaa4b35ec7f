// The body of the resident whole-loop kernel (sos_mega), shared by
// megakernel.cu, which builds the solve (AB = 0), and mega_ablate.cuh, which
// builds the ablated variants of tools/ablate_kernel.py in translation units
// of their own, so the solve's registers, spills and build time do not move.
// The design is described in megakernel.cu; AB is a set of the ablation bits
// of sos_tiles.cuh (the flags of megakernel._mega_kernel's ``ablate``):
//   AB_NOCONV    a fixed order count: the loop runs until n = max_orders and
//                n counts every order (the ratio still gates accumulation)
//   AB_NOI1      the fields and totals start from 1 instead of I1
//   AB_NOSRC     no source product: jn_down = fdn + 1, jn_up = fup + 1
//   AB_NOLOOPS   no carries in the two recurrences
//   AB_NOPASSA   no pass A: pass B reads sdn = jn_up = 0
//   AB_NOPOLY    no mu->0- polyfit band
//   AB_NOPASSB   no pass B (and no BC, no accumulation): the ratio is taken
//                on the fields and totals as they stand
//   AB_NOBC      no surface BC product
//   AB_NOFIN     no join corrections and no smoothing
//   AB_NOSMOOTH  no smoothing
//   AB_NORATIO   the ratio keeps its seed
// With AB = 0 every `if constexpr` below drops out and the kernel is the
// solve.  One more bit, AB_I1IN, is no ablation: it builds the solve with
// the first order given from the host (the TPU kernel's i1dn_ref /
// i1up_ref inputs, megakernel.py:326-329, 404-411): the pre step copies the
// tile's rows of the two (L, Cg, Mp) planes i1dn / i1up into fdn / fup in
// place of evaluating I1, and reads no I1 tile, pack row or surface
// operator.  Only megakernel.cu builds it (sos_mega_i1in).
//
// The two quad products (I1's surface product, the J_n source product) run
// on the tensor cores (mega_mma.cuh) in float32 'bf16x3' / 'bf16x5' with
// 256 threads (Mp <= 256), from the bf16 operator copies ws_tc / astk_tc;
// float64, 'highest' and the 512-thread block (Mp > 256) keep the SIMT
// product quad_gemm_tile of sos_tiles.cuh.
#pragma once
#include "mega_mma.cuh"
#include "sos_tiles.cuh"

namespace {

using namespace sos;

constexpr int CB_MAX = 32;      // most columns a tile may hold
constexpr int AB_I1IN = 2048;   // I1 from the host planes (see above)
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
  // the bf16 operator copies (2, 4Mp, Kp) of the tensor-core product
  // (rmma::takes_tc builds; null and unread otherwise)
  const uint16_t *ws_tc, *astk_tc;
  // the host's first order, (L, Cg, Mp) each (AB_I1IN builds; null and
  // unread otherwise)
  const T *i1dn, *i1up;
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

template <typename T, int MODE, int NT, int AB = 0>
__global__ void __launch_bounds__(NT, NT == 256 ? MIN_BLOCKS_256 : 1)
mega_kernel(const MegaArgs<T> a) {
  constexpr bool TC = rmma::takes_tc<T, MODE, NT>();
  // the SIMT product's tiles (the tensor-core product's are dynamic)
  __shared__ std::conditional_t<TC, char, GemmSmem<T, MODE>> gsm;
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
  T* gs = reinterpret_cast<T*>(smem_raw + rmma::smem_bytes<T, MODE, NT>()) +
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
    if constexpr ((AB & AB_NOI1) != 0) {
      for (size_t i = tid; i < plane; i += NT) fdn[i] = fup[i] = T(1);
    } else if constexpr ((AB & AB_I1IN) != 0) {
      // the tile's rows (t, c0 + cl) of the host planes; workspace row
      // r = t * cb + cl
      for (size_t i = tid; i < plane; i += NT) {
        const size_t r = i / Mp, n = i - r * Mp;
        const size_t o = ((r / cb) * Cg + c0 + r % cb) * Mp + n;
        fdn[i] = a.i1dn[o];
        fup[i] = a.i1up[o];
      }
    } else {
      LoadSurfaceExp<T> ld{a.pack, pm, a.colc + RC_IVUP * Mp};
      EpiFirstOrder<T> epi{a.pack, pm, a.tiles, a.colc, a.cpar, fdn, fup, Mp, mr,
                           a.lamb != 0};
      // a specular surface has no surface-integral product: K = 0
      if constexpr (TC) {
        rmma::quad_tile<MODE>(ld, epi, a.astk_tc, R, Mp, a.lamb ? Mp : 0, tid);
      } else {
        for (int r0 = 0; r0 < R; r0 += BM)
          for (int n0 = 0; n0 < Mp; n0 += BN)
            quad_gemm_tile<T, MODE>(ld, epi, a.astk_hi, a.astk_lo, R, Mp,
                                    a.lamb ? Mp : 0, r0, n0, tid, worker, gsm);
      }
    }
    if constexpr ((AB & AB_NOPASSA) != 0) {
      for (size_t i = tid; i < plane; i += NT) sdn[i] = jnu[i] = T(0);
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
      if constexpr ((AB & AB_NOCONV) != 0) any = true;
      if (!(any && nhi < nmax)) break;

      // ---- pass A: source product, then the downward recurrence ----
      if constexpr ((AB & AB_NOPASSA) == 0) {
        if constexpr ((AB & AB_NOSRC) != 0) {
          for (size_t i = tid; i < plane; i += NT) {
            sdn[i] = fdn[i] + T(1);
            jnu[i] = fup[i] + T(1);
          }
        } else {
          LoadFields<T> ld{fdn, fup, Mp};
          EpiSource<T> epi{a.pack, pm, sdn, jnu, Mp};
          if constexpr (TC) {
            rmma::quad_tile<MODE>(ld, epi, a.ws_tc, R, Mp, 2 * Mp, tid);
          } else {
            for (int r0 = 0; r0 < R; r0 += BM)
              for (int n0 = 0; n0 < Mp; n0 += BN)
                quad_gemm_tile<T, MODE>(ld, epi, a.ws_hi, a.ws_lo, R, Mp, 2 * Mp,
                                        r0, n0, tid, worker, gsm);
          }
        }
        __syncthreads();
        for (int i = tid; i < cb * Mp; i += NT)
          down_scan_one<T, AB>(a.pack, pm, a.colc, sdn, Mp, i / Mp, i % Mp);
        __syncthreads();
      }

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
        if constexpr ((AB & AB_NOPASSB) == 0) {
          pass_b_walk<T, MODE, AB>(pb, cl, live ? gt : Mp, act, gs, sred, w0, nw,
                                   sink);
        } else if (act) {
          // the fields and totals as they stand
          const int c = c0 + cl;
          sink.new_top = fup[(size_t)cl * Mp + gt];
          sink.new_bot = fdn[(size_t)((L - 1) * cb + cl) * Mp + gt];
          sink.tot_top = a.o1[(size_t)c * Mp + gt];     // t = 0 in both layouts
          sink.tot_bot = a.full ? a.o0[((size_t)(L - 1) * Cg + c) * Mp + gt]
                                : a.o2[(size_t)c * Mp + gt];
        }
        // pad angles and zero totals count as converged (0); threads
        // without an angle do not count
        if constexpr ((AB & (AB_NORATIO | AB_NOCONV)) == 0) {
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
        } else {
          auto ratio = [&] {
            T v = -INFINITY;
            if (act)
              v = gt < mr ? nanmax(ratio_of(sink.new_top, sink.tot_top),
                                   ratio_of(sink.new_bot, sink.tot_bot))
                          : T(0);
            return group_max(v, sredv, w0, nw);
          };
          if constexpr ((AB & AB_NORATIO) == 0) {
            const T v = ratio();
            if (on && gt == 0) s_ratio[cl] = v;
          }
          if (gt == 0 && ((AB & AB_NOCONV) != 0 ? live : on)) s_n[cl] = s_n[cl] + T(1);
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

// dynamic shared memory of mega_kernel<T, MODE, NT>: the tensor-core
// product's stages, then pass B's rows, a group's each
template <typename T, int MODE, int NT>
size_t smem_for(int Mp, int slot) {
  const int gsize = ((Mp + 31) / 32) * 32;
  return rmma::smem_bytes<T, MODE, NT>() +
         sizeof(T) * (NT / gsize) * pass_b_smem_elems<T, MODE>(Mp, slot);
}

// allow mega_kernel<T, MODE, NT, AB> the dynamic shared memory `bytes` on
// the current device (needed above 48 KiB)
template <typename T, int MODE, int NT, int AB>
cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(mega_kernel<T, MODE, NT, AB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool shape_ok(int Mp, int mr, int slot, int cb, int Cg) {
  return Mp >= 8 && Mp <= 512 && mr >= 4 && mr <= Mp && slot <= Mp && cb >= 1 &&
         cb <= CB_MAX && Cg > 0 && Cg % cb == 0;
}

// The number of blocks of mega_kernel<T, MODE, NT, AB> the card keeps
// resident at once for these shapes, or -(CUDA error).
template <typename T, int MODE, int NT, int AB>
int resident_blocks(int Mp, int slot) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem<T, MODE, NT, AB>(smem_for<T, MODE, NT>(Mp, slot));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mega_kernel<T, MODE, NT, AB>, NT, smem_for<T, MODE, NT>(Mp, slot));
  if (e != cudaSuccess) return -(int)e;
  return per_sm > 0 ? sms * per_sm : -(int)cudaErrorLaunchOutOfResources;
}

// Launch mega_kernel<T, MODE, NT, AB> on the arguments of sos_mega (and,
// for AB_I1IN, the host's I1 planes).  A build with the tensor-core product
// needs the bf16 operator copies (astk_tc only for a Lambertian surface
// whose I1 the kernel evaluates): without them it refuses to launch, as an
// AB_I1IN build does without its planes.
template <typename T, int MODE, int NT, int AB>
int launch_mega(const void* pack, const void* cpar, const void* tiles,
                const void* colc, const void* ws_hi, const void* ws_lo,
                const void* astk_hi, const void* astk_lo, const void* ws_tc,
                const void* astk_tc, const void* tap_col,
                const void* tap_hi, const void* tap_lo, const void* pvt,
                const void* bct_hi, const void* bct_lo, void* work, void* counter,
                void* o0, void* o1, void* o2, void* o3, void* stats, int lamb,
                int full, int L, int Cg, int cb, int Mp, int mr, int slot,
                int nblocks, int max_orders, double tol, cudaStream_t st,
                const void* i1dn = nullptr, const void* i1up = nullptr) {
  const MegaArgs<T> a{(const T*)pack, (const T*)cpar, (const T*)tiles,
                      (const T*)colc, (const T*)ws_hi, (const T*)ws_lo,
                      (const T*)astk_hi, (const T*)astk_lo,
                      (const int*)tap_col, (const T*)tap_hi, (const T*)tap_lo,
                      (const T*)pvt, (const T*)bct_hi, (const T*)bct_lo,
                      (T*)work, (int*)counter, (T*)o0, (T*)o1, (T*)o2, (T*)o3,
                      (T*)stats, L, Cg, cb, Mp, mr, slot, lamb, full,
                      max_orders, tol, (const uint16_t*)ws_tc,
                      (const uint16_t*)astk_tc, (const T*)i1dn, (const T*)i1up};
  constexpr bool I1IN = (AB & AB_I1IN) != 0;
  if constexpr (I1IN) {
    if (i1dn == nullptr || i1up == nullptr) return (int)cudaErrorInvalidValue;
  }
  if constexpr (rmma::takes_tc<T, MODE, NT>()) {
    if (ws_tc == nullptr || (lamb && !I1IN && astk_tc == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_for<T, MODE, NT>(Mp, slot);
  const cudaError_t e = allow_smem<T, MODE, NT, AB>(smem);
  if (e != cudaSuccess) return (int)e;
  mega_kernel<T, MODE, NT, AB><<<nblocks, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
