// Device functions shared by the streamed kernels (megastream.cu) and the
// resident whole-loop kernel (megakernel.cu, mega_ablate*.cu through
// mega_body.cuh): the tiled quad product, the downward recurrence and the
// pass-B walk; micro.cu takes the smoothing walk and the bf16 split from
// here too.  The solve's sources call the same functions on the same
// arithmetic, so a column's fields come out bit for bit the same whichever
// kernel computes them (the mu->0+ smoothing walk compares a second
// difference with 1e-4: a last-bit change can move its blend endpoint).
//
// Layout: a half-field of Cl local columns is (L, Cl, Mp) contiguous, angles
// last, so row r = t*Cl + cl of the (L*Cl, Mp) matrix is one (layer, column)
// pair.  The per-(layer, column) scalars pack (PK_W, L, Cg), the per-column
// scalars cpar (CP_W, Cg) and the I1 tiles (NI, Cg, Mp) belong to Cg >= Cl
// columns of which the fields cover [c0, c0 + Cl): PackMap does the
// indexing.  Per-angle rows are colc (7, Mp).  Row-index constants match
// sos_rt_tpu_torch/ops/megakernel.py and ops/first_order.py.
//
// Field planes are read and written inside one kernel by different threads
// (the resident kernel), so no plane pointer here is __restrict__ or read
// through the read-only cache; a __syncthreads() orders the accesses.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace sos {

enum { PK_TAU = 0, PK_HDT_DN, PK_HDT_UP, PK_COEF_ATM, PK_COEF_AER, PK_CDN,
       PK_CUP, PK_GS, PK_R1, PK_R2, PK_CHOICE, PK_ABDN, PK_ASDN, PK_ABUP,
       PK_ASUP, PK_ASTAR, PK_E0T, PK_ES0T, PK_E0RDN, PK_ESRDN, PK_E0RUP,
       PK_ESRUP, PK_REGION };
enum { CP_GRD = 0, CP_CONST = 1 };
enum { RC_EMU_DN = 0, RC_EMU_UP, RC_IVDN, RC_IVUP, RC_MUUP, RC_PKA, RC_PKR };
enum { T_DDA = 0, T_DDR, T_DBA, T_DBR, T_UDA, T_UDR, T_RESDN, T_ROWA, T_ROWB,
       T_BC, T_ROWC, T_ROWBU, T_SCKDNA, T_SCKDNB, T_SCKDNC, T_SCKUPA,
       T_SCKUPB, T_SCKUPC, T_DMA, T_DMR, T_UMA, T_UMR, T_UBA, T_UBR,
       T_RESUP };
enum { ST_N = 0, ST_CONV = 1, ST_RATIO = 2 };
enum { MM_HIGHEST = 0, MM_BF16X3 = 1, MM_BF16X5 = 2 };
// Ablation bits of the resident kernel (tools/ablate_kernel.py; the flags of
// the TPU kernel's ``ablate`` string, megakernel._mega_kernel): each cuts a
// stage out for timing attribution, and the results are wrong with any bit
// set.  0 is the solve itself.
enum { AB_NOCONV = 1, AB_NOI1 = 2, AB_NOSRC = 4, AB_NOLOOPS = 8, AB_NOPASSA = 16,
       AB_NOPOLY = 32, AB_NOPASSB = 64, AB_NOBC = 128, AB_NOFIN = 256,
       AB_NOSMOOTH = 512, AB_NORATIO = 1024 };
constexpr int N_TAPS = 6;
constexpr int BIG_ROW = 1 << 30;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
template <typename T> __device__ __forceinline__ T clexp(T x) { return exp_t(x < T(0) ? x : T(0)); }

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MODE> struct Parts {
  static constexpr int NX = MODE == MM_HIGHEST ? 1 : (MODE == MM_BF16X3 ? 2 : 3);
  static constexpr int NW = MODE == MM_HIGHEST ? 1 : 2;
};

// x split into its bf16 parts (round half to even, as astype(bfloat16)).
template <typename T, int MODE>
__device__ __forceinline__ void split_x(T x, T* p) {
  if constexpr (MODE == MM_HIGHEST) {
    p[0] = x;
  } else {
    float x1 = bf16r(x);
    float r1 = x - x1;
    float x2 = bf16r(r1);
    p[0] = x1;
    p[1] = x2;
    if constexpr (MODE == MM_BF16X5) p[2] = bf16r(r1 - x2);
  }
}

// acc + (hi, lo) . x in mode MODE; split products are exact in float32.
template <typename T, int MODE>
__device__ __forceinline__ T dot_term(T acc, T hi, T lo, const T* x) {
  if constexpr (MODE == MM_HIGHEST) {
    return fma_t(hi, x[0], acc);
  } else if constexpr (MODE == MM_BF16X3) {
    acc = fma_t(hi, x[0], acc);
    acc = fma_t(hi, x[1], acc);
    return fma_t(lo, x[0], acc);
  } else {
    acc = fma_t(hi, x[0], acc);
    acc = fma_t(hi, x[1], acc);
    acc = fma_t(hi, x[2], acc);
    acc = fma_t(lo, x[0], acc);
    return fma_t(lo, x[1], acc);
  }
}

// acc + (hi, lo) . x as separately rounded products and sums, in the order
// of megakernel.add_terms (passB's short sums; with -fmad=false they match
// the plain PyTorch version bit for bit).
template <typename T, int MODE>
__device__ __forceinline__ T add_terms(T acc, T hi, T lo, const T* x) {
  constexpr int NX = Parts<MODE>::NX;
#pragma unroll
  for (int h = 0; h < NX; ++h) acc = acc + hi * x[h];
#pragma unroll
  for (int h = 0; h + 1 < NX; ++h) acc = acc + lo * x[h];
  return acc;
}

// The value an identity operator row gives in mode MODE (1·x1 + 1·x2 ...).
template <typename T, int MODE>
__device__ __forceinline__ T split_sum(T x) {
  T p[3];
  split_x<T, MODE>(x, p);
  if constexpr (MODE == MM_HIGHEST) return p[0];
  else if constexpr (MODE == MM_BF16X3) return p[0] + p[1];
  else return p[0] + p[1] + p[2];
}

// Where the scalars of local field row r = t*Cl + cl live in the arrays of
// all Cg columns (the fields cover columns [c0, c0 + Cl)).
struct PackMap {
  int L, Cl, Cg, c0;
  __device__ __forceinline__ int col(int r) const { return c0 + r % Cl; }
  // pack (PK_W, L, Cg): offset of (row, layer t, local column cl)
  __device__ __forceinline__ size_t at(int row, int t, int cl) const {
    return ((size_t)row * L + t) * Cg + c0 + cl;
  }
  // the same for local field row r
  __device__ __forceinline__ size_t pk(int row, int r) const { return at(row, r / Cl, r % Cl); }
  // cpar (CP_W, Cg): offset of (row, global column c)
  __device__ __forceinline__ size_t cp(int row, int c) const { return (size_t)row * Cg + c; }
  // tiles (NI, Cg, Mp): offset of (tile i, global column c, angle n)
  __device__ __forceinline__ size_t tl(int i, int c, int n, int Mp) const {
    return ((size_t)i * Cg + c) * Mp + n;
  }
};

// ---------------------------------------------------------------------------
// quad product: out_q[r, n] = sum_j W[q*Mp + n, j] * X[r, j], q = 0..3,
// r < R, n < Mp, j < K; X is produced by a loader, the four sums go to an
// epilogue.  One BM x BN output tile per call, by 16 x 16 worker threads,
// each 4 rows x 2 angles x 4 quads; every output sums over j in ascending
// order, so it does not depend on the tiling.  All threads of the block
// call it together (it holds block barriers); threads that are no workers
// only keep the barriers.
// ---------------------------------------------------------------------------
constexpr int BM = 64, BN = 32, BK = 16, TX = 16, TY = 16;

template <typename T, int MODE> struct GemmSmem {
  T xs[Parts<MODE>::NX][BK][BM + 1];
  T ws[Parts<MODE>::NW][4][BK][BN + 1];
};

template <typename T, int MODE, class Loader, class Epi>
__device__ __forceinline__ void quad_gemm_tile(
    const Loader& ld, const Epi& epi, const T* __restrict__ w_hi,
    const T* __restrict__ w_lo, int R, int Mp, int K, int r0, int n0,
    int tid, bool worker, GemmSmem<T, MODE>& sm) {
  constexpr int NX = Parts<MODE>::NX, NW = Parts<MODE>::NW;
  const int tx = tid % TX, ty = tid / TX;
  T acc[4][4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i][0] = acc[q][i][1] = T(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (worker) {
#pragma unroll
      for (int s = 0; s < (BM * BK) / (TX * TY); ++s) {
        const int e = tid + s * TX * TY, row = e / BK, kk = e % BK;
        const int r = r0 + row, j = k0 + kk;
        T p[3];
        split_x<T, MODE>((r < R && j < K) ? ld(r, j) : T(0), p);
#pragma unroll
        for (int h = 0; h < NX; ++h) sm.xs[h][kk][row] = p[h];
      }
#pragma unroll
      for (int s = 0; s < (4 * BN * BK) / (TX * TY); ++s) {
        const int e = tid + s * TX * TY, q = e / (BN * BK), rem = e % (BN * BK);
        const int nn = rem / BK, kk = rem % BK, n = n0 + nn, j = k0 + kk;
        const bool ok = n < Mp && j < K;
        const size_t o = (size_t)(q * Mp + n) * K + j;
        sm.ws[0][q][kk][nn] = ok ? w_hi[o] : T(0);
        if constexpr (NW > 1) sm.ws[NW - 1][q][kk][nn] = ok ? w_lo[o] : T(0);
      }
    }
    __syncthreads();
    if (worker) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        T xa[4][NX];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < NX; ++h) xa[i][h] = sm.xs[h][kk][ty + TY * i];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            const T hi = sm.ws[0][q][kk][tx + TX * jn];
            const T lo = NW > 1 ? sm.ws[NW - 1][q][kk][tx + TX * jn] : T(0);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[q][i][jn] = dot_term<T, MODE>(acc[q][i][jn], hi, lo, xa[i]);
          }
      }
    }
    __syncthreads();
  }
  if (worker) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int r = r0 + ty + TY * i, n = n0 + tx + TX * jn;
        if (r < R && n < Mp)
          epi(r, n, acc[0][i][jn], acc[1][i][jn], acc[2][i][jn], acc[3][i][jn]);
      }
  }
}

// ---- passA: X = [fdn | fup] (K = 2Mp); epilogue mixes the species ----
template <typename T> struct LoadFields {
  const T* fdn; const T* fup; int Mp;
  __device__ T operator()(int r, int j) const {
    return j < Mp ? fdn[(size_t)r * Mp + j] : fup[(size_t)r * Mp + (j - Mp)];
  }
};

template <typename T> struct EpiSource {
  const T* pack; PackMap pm; T* jnd; T* jnu; int Mp;
  __device__ void operator()(int r, int n, T a0, T a1, T a2, T a3) const {
    const T ca = pack[pm.pk(PK_COEF_ATM, r)];
    const T cr = pack[pm.pk(PK_COEF_AER, r)];
    const size_t o = (size_t)r * Mp + n;
    jnd[o] = ca * a0 + cr * a2;
    jnu[o] = ca * a1 + cr * a3;
  }
};

// downward recurrence r_t = e^{2 hdt_dn_t / mu} r_{t-1} + cdn_t jn_t for
// local column cl and angle n; sdn = r - hdt_up jn overwrites jn in place.
// AB_NOLOOPS drops the carry: r_t = cdn_t jn_t.
template <typename T, int AB = 0>
__device__ __forceinline__ void down_scan_one(const T* __restrict__ pack,
                                              const PackMap& pm,
                                              const T* __restrict__ colc,
                                              T* sdn, int Mp, int cl, int n) {
  const T emu = colc[RC_EMU_DN * Mp + n];
  T r = T(0);
  for (int t = 0; t < pm.L; ++t) {
    const size_t o = (size_t)(t * pm.Cl + cl) * Mp + n;
    T jn;
    if constexpr ((AB & AB_NOLOOPS) != 0) {
      jn = sdn[o];
      r = pack[pm.at(PK_CDN, t, cl)] * jn;
    } else {
      const T att = exp_t(T(2) * pack[pm.at(PK_HDT_DN, t, cl)] * emu);
      jn = sdn[o];
      r = att * r + pack[pm.at(PK_CDN, t, cl)] * jn;
    }
    sdn[o] = r - pack[pm.at(PK_HDT_UP, t, cl)] * jn;
  }
}

// ---- passI: X = e^{(tau - tau*) / mu'} (K = Mp, row 0 zero); epilogue is
// the closed-form I1 (megakernel.make_i1_block) ----
template <typename T> struct LoadSurfaceExp {
  const T* pack; PackMap pm; const T* ivup;
  __device__ T operator()(int r, int j) const {
    return j == 0 ? T(0) : exp_t(pack[pm.pk(PK_ASTAR, r)] * ivup[j]);
  }
};

template <typename T> struct EpiFirstOrder {
  const T* pack; PackMap pm; const T* tiles; const T* colc; const T* cpar;
  T* fdn; T* fup; int Mp; int mr; bool lamb;
  __device__ void operator()(int r, int n, T e0, T e1, T e2, T e3) const {
    const int c = pm.col(r);
    auto s = [&](int row) { return pack[pm.pk(row, r)]; };
    auto til = [&](int i) { return tiles[pm.tl(i, c, n, Mp)]; };
    const T ca = T(4) * s(PK_COEF_ATM);
    const T cr = T(4) * s(PK_COEF_AER);
    const T reg = s(PK_REGION);
    const bool in_a = reg < T(0.5), in_b = reg < T(1.5);
    auto sel = [&](T va, T vb, T vc) { return in_a ? va : (in_b ? vb : vc); };
    const T e0t = s(PK_E0T), es0t = s(PK_ES0T);
    const T constc = cpar[pm.cp(CP_CONST, c)];
    const T emu_dn = colc[RC_EMU_DN * Mp + n];
    const T ivup = colc[RC_IVUP * Mp + n];
    const bool lastrow = n >= mr - 1, row0 = n == 0;
    // down half (row mr-1 = mu=0-: attenuations masked off)
    const T attb = lastrow ? T(0) : clexp(s(PK_ABDN) * emu_dn);
    const T atts = lastrow ? T(0) : clexp(s(PK_ASDN) * emu_dn);
    T dirn = (ca * til(T_DDA) + cr * til(T_DDR)) * (e0t - s(PK_E0RDN) * attb);
    const T dres = (ca * til(T_DBA) + cr * til(T_DBR)) * e0t * s(PK_ABDN);
    if (til(T_RESDN) > T(0.5)) dirn = dres;
    T surf;
    if (lamb) {
      const T rowsel = ca * e0 + cr * e1;
      const T sck = sel(til(T_SCKDNA), til(T_SCKDNB), til(T_SCKDNC));
      surf = constc * (rowsel - atts * sck);
    } else {
      surf = (ca * til(T_DMA) + cr * til(T_DMR)) * (es0t - s(PK_ESRDN) * atts);
    }
    T before = sel(T(0), til(T_ROWA), til(T_ROWB));
    const size_t o = (size_t)r * Mp + n;
    fdn[o] = dirn + surf + before * attb;
    // up half (row 0 = mu=0+: attenuations masked off)
    const T attbu = row0 ? T(0) : clexp(s(PK_ABUP) * ivup);
    const T attsu = row0 ? T(0) : clexp(s(PK_ASUP) * ivup);
    const T diru = (ca * til(T_UDA) + cr * til(T_UDR)) * (e0t - s(PK_E0RUP) * attbu);
    if (lamb) {
      const T rowsel = ca * e2 + cr * e3;
      const T sck = sel(til(T_SCKUPA), til(T_SCKUPB), til(T_SCKUPC));
      const T et = row0 ? T(0) : exp_t(s(PK_ASTAR) * ivup);
      const T pk = ca * colc[RC_PKA * Mp + n] + cr * colc[RC_PKR * Mp + n];
      const T lim = ivup * et * (-s(PK_ASUP)) * pk * constc;
      surf = constc * (rowsel - attsu * sck) + lim;
    } else {
      surf = (ca * til(T_UMA) + cr * til(T_UMR)) * (es0t - s(PK_ESRUP) * attsu);
      const T sres = (ca * til(T_UBA) + cr * til(T_UBR)) * es0t * (-s(PK_ASUP));
      if (til(T_RESUP) > T(0.5)) surf = sres;
    }
    before = sel(til(T_ROWBU), til(T_ROWC), til(T_BC));
    fup[o] = diru + surf + before * attbu;
  }
};

// ---------------------------------------------------------------------------
// passB: a group of round32(Mp) threads walks one column's layers
// L-1 .. 0, thread n = angle.  A block holds one group (the streamed kernel)
// or several, each on its own column (the resident kernel); every thread of
// the block calls pass_b_walk together, because it holds block barriers.
// ---------------------------------------------------------------------------

// min of v over the warps [w0, w0 + nw) of the block (one group).
__device__ __forceinline__ int group_min(int v, int* sred, int w0, int nw) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = BIG_ROW;
  for (int w = 0; w < nw; ++w) m = min(m, sred[w0 + w]);
  __syncthreads();
  return m;
}

// The mu->0+ smoothing walk (megakernel._smooth_up) at angle n of one
// up-half row of mr real angles staged in sv, whose value is f = sv[n] and
// raw up mu mun; mu[mu_off + k] is the raw up mu of angle k.  The first
// angle k in [1, mr - 3] whose second difference |sv[k] - 2 sv[k+1] +
// sv[k+2]| is <= 1e-4 (mr - 3 if none) gives idx = k + 1; the angles
// 1 <= n < idx take the blend of sv[0] and sv[idx] linear in mu, the others
// keep f.  rmin(c) is the min of c over the threads of the row, one angle
// each (an n outside [0, mr) takes no part); GroupMin does it for a group
// of warps.  Called by pass_b_walk and by the micro_ops pattern `smooth`.
template <typename T, class Min>
__device__ __forceinline__ T smooth_up_walk(const T* sv, const T* mu, int mu_off, int mr,
                                            int n, T mun, T f, Min rmin) {
  int cand = BIG_ROW;
  if (n >= 1 && n <= mr - 3) {
    const T d = abs_t(sv[n] - T(2) * sv[n + 1] + sv[n + 2]);
    if (d <= T(1e-4)) cand = n;
  }
  const int idx = min(rmin(cand), mr - 3) + 1;
  T sm = f;
  if (n >= 1 && n < idx) {
    const T w = mun / mu[mu_off + idx];
    sm = (T(1) - w) * sv[0] + w * sv[idx];
  }
  return sm;
}

// group_min over the warps [w0, w0 + nw) of the block, as a reducer
struct GroupMin {
  int* sred;
  int w0, nw;
  __device__ __forceinline__ int operator()(int c) const { return group_min(c, sred, w0, nw); }
};

template <typename T> struct PassBArgs {
  const T* pack; PackMap pm; const T* sdn; const T* jnup; const T* cpar;
  const T* colc; const int* tap_col; const T* tap_hi; const T* tap_lo;
  const T* pvt; const T* bct_hi; const T* bct_lo; T* fdn; T* fup;
  int Mp, mr, slot;
};

// The group's shared memory: Mp values of the current row, their NX * Mp
// bf16 parts, and slot band values.
template <typename T, int MODE>
__host__ __device__ constexpr size_t pass_b_smem_elems(int Mp, int slot) {
  return (size_t)(1 + Parts<MODE>::NX) * Mp + slot;
}

struct NoSink {
  template <typename T> __device__ void operator()(int, int, T, T) const {}
};

// Walk local column cl.  n is the thread's angle (any n >= Mp for a thread
// without one), act whether it has a real one; gs points at the group's
// shared memory, [w0, w0 + nw) are the group's warps.  sink(t, n, fv, sm)
// sees every value the walk stores.  AB (ablation bits, 0 for the solve):
// AB_NOPOLY keeps the band rows of I_down as they are (the mu=0- row
// zeroed), AB_NOBC starts the up carry from jn_up of the deepest layer on
// every angle, AB_NOLOOPS drops the carry (r_t = src_t), AB_NOFIN skips
// the join corrections and the smoothing, AB_NOSMOOTH the smoothing.
template <typename T, int MODE, int AB = 0, class Sink>
__device__ __forceinline__ void pass_b_walk(const PassBArgs<T>& a, int cl, int n,
                                            bool act, T* gs, int* sred, int w0,
                                            int nw, Sink& sink) {
  constexpr int NX = Parts<MODE>::NX;
  const int L = a.pm.L, Cl = a.pm.Cl, Mp = a.Mp, mr = a.mr, slot = a.slot;
  T* sv = gs;                                 // Mp values of the current row
  T* sx = sv + Mp;                            // NX * Mp bf16 parts of sv
  T* spoly = sx + NX * Mp;                    // slot band values
  const T* colc = a.colc;
  const T ivdn = act ? colc[RC_IVDN * Mp + n] : T(0);
  const T ivup = act ? colc[RC_IVUP * Mp + n] : T(0);
  const T emu_up = act ? colc[RC_EMU_UP * Mp + n] : T(0);
  const T muup = act ? colc[RC_MUUP * Mp + n] : T(0);
  auto pk = [&](int row, int t) { return a.pack[a.pm.at(row, t, cl)]; };

  // put this thread's value (0 for idle threads) and its parts in smem
  auto stage = [&](T v) {
    if (act) {
      sv[n] = v;
      T p[3];
      split_x<T, MODE>(v, p);
#pragma unroll
      for (int h = 0; h < NX; ++h) sx[h * Mp + n] = p[h];
    }
    __syncthreads();
  };

  // I_down = -sdn / mu with the mu->0- polyfit band fix (band_fix_tile)
  auto band_fixed = [&](int t) {
    const int rr = t * Cl + cl;
    T fv = act ? -a.sdn[(size_t)rr * Mp + n] * ivdn : T(0);
    if (n >= mr - 1) fv = T(0);                // mu=0- row and pad rows
    if constexpr ((AB & AB_NOPOLY) != 0) return fv;
    stage(fv);
    const int choice = (int)pk(PK_CHOICE, t);
    if (act && n < slot) {
      const int row = choice * slot + n;
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < N_TAPS; ++j) {
        const int col = a.tap_col[row * N_TAPS + j];
        T x[3];
#pragma unroll
        for (int h = 0; h < NX; ++h) x[h] = sx[h * Mp + col];
        acc = add_terms<T, MODE>(acc, a.tap_hi[row * N_TAPS + j],
                                 a.tap_lo[row * N_TAPS + j], x);
      }
      spoly[n] = acc;
    }
    __syncthreads();
    const int i = mr - 1 - n;
    if (act && i >= 0 && i < slot && a.pvt[choice * Mp + n] > T(0.5))
      fv = split_sum<T, MODE>(spoly[i]);
    __syncthreads();
    return fv;
  };

  // surface BC from the deepest layer's band-fixed I_down
  const T fvs = band_fixed(L - 1);
  T rcar = T(0);
  if constexpr ((AB & AB_NOBC) != 0) {
    if (act) rcar = a.jnup[(size_t)((L - 1) * Cl + cl) * Mp + n];
  } else {
    stage(fvs);
    if (act) {
      if (n == 0) {
        rcar = a.jnup[(size_t)((L - 1) * Cl + cl) * Mp];
      } else {
        T acc = T(0);
        for (int k = 0; k < Mp; ++k) {
          T x[3];
#pragma unroll
          for (int h = 0; h < NX; ++h) x[h] = sx[h * Mp + k];
          acc = add_terms<T, MODE>(acc, a.bct_hi[(size_t)k * Mp + n],
                                   Parts<MODE>::NW > 1 ? a.bct_lo[(size_t)k * Mp + n] : T(0), x);
        }
        rcar = a.cpar[a.pm.cp(CP_GRD, a.pm.c0 + cl)] * acc;
      }
    }
    __syncthreads();
  }

  T q1 = T(0), q2 = T(0);
  const T corr = n >= 1 ? T(1) : T(0);
  for (int t = L - 1; t >= 0; --t) {
    const int rr = t * Cl + cl;
    const size_t o = (size_t)rr * Mp + n;
    const T fv = t == L - 1 ? fvs : band_fixed(t);
    // upward recurrence; the mu=0+ row rides along pinned to jn
    const T attu = n == 0 ? T(0) : exp_t(T(2) * pk(PK_HDT_UP, t) * emu_up);
    const T jn = act ? a.jnup[o] : T(0);
    const T jiv = ivup * jn;
    const T src = n == 0 ? jn : pk(PK_CUP, t) * jiv;
    const T gsv = pk(PK_GS, t) * jiv;
    if constexpr ((AB & AB_NOLOOPS) != 0) rcar = src;
    else rcar = attu * rcar + src;
    T f = rcar - gsv;
    T sm[1] = {f};
    if constexpr ((AB & AB_NOFIN) == 0) {
      q1 = q1 * attu;
      q2 = q2 * attu;
      f = f + corr * (q1 + q2);
      sm[0] = f;
      if constexpr ((AB & AB_NOSMOOTH) == 0) {
        stage(f);
        sm[0] = smooth_up_walk<T>(sv, colc, RC_MUUP * Mp, mr, n, muup, f,
                                  GroupMin{sred, w0, nw});
      }
      const T d = sm[0] - f;
      if (pk(PK_R1, t) > T(0.5)) q1 = d;
      if (pk(PK_R2, t) > T(0.5)) q2 = d;
    }
    if (act) {
      a.fdn[o] = fv;
      a.fup[o] = sm[0];
      sink(t, n, fv, sm[0]);
    }
    __syncthreads();
  }
}

template <typename F> int dispatch(int dtype, int mode, F&& f) {
  if (dtype == 0) {
    if (mode == MM_HIGHEST) return f(float(), std::integral_constant<int, MM_HIGHEST>());
    if (mode == MM_BF16X3) return f(float(), std::integral_constant<int, MM_BF16X3>());
    if (mode == MM_BF16X5) return f(float(), std::integral_constant<int, MM_BF16X5>());
  } else if (dtype == 1 && mode == MM_HIGHEST) {
    return f(double(), std::integral_constant<int, MM_HIGHEST>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace sos
