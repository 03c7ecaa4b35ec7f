// The streamed passB (sos_passB_band / _walk / _smooth in megastream.cu) as
// three kernels, split by what really depends on the layer below.
//
// It replaces sos_rt_tpu/ops/megastream.py::_passB_kernel and computes what
// sos_tiles.cuh::pass_b_walk computes for one column (the resident kernel
// keeps that walk): the surface BC, I_down = -sdn / mu with the mu->0- band
// fix, the upward recurrence with the mu=0+ row pinned to jn, the q1/q2 join
// corrections and the mu->0+ smoothing.  Of these only the upward carry,
// the q decay and the smoothing of the two join rows (PK_R1, PK_R2: one-hot
// over layers) are serial in t; the band fix depends on its own row, and
// the smoothing of every other row feeds nothing back.  So:
//   1. pass_b_band: the band fix of all L*C rows, one warp a row: the row
//      of -sdn / mu staged in shared memory, the <= 6 stencil taps of each
//      band value (lanes below slot), the values placed; writes fdn.
//   2. pass_b_up: one block of round32(Mp) threads a column, thread n =
//      angle, carries r, q1, q2 in registers from the BC (the deepest row of
//      stage 1's fdn) to the top; its loads do not depend on the carry, so
//      they are issued WALK_UNROLL layers ahead.  The threads of a column
//      meet only at the BC and at a join row, where the whole row's
//      smoothing gives d = sm - f; no barrier elsewhere.  Writes the
//      corrected, unsmoothed f = r - gsv + corr (q1 + q2) into fup.
//   3. pass_b_smooth: the smoothing of all L*C rows of fup in place, one
//      warp a row: the first-index search over 32 angles a step (warp
//      shuffles and a ballot) stops at the first chunk that holds one, and
//      only the blended angles [1, idx) are written.  A join row gets the
//      value stage 2 used, from the same function of the same inputs.
// Every value is the same sequence of separately rounded operations as in
// pass_b_walk and the plain version (megastream.passB_plain; -fmad=false),
// so the result equals both to the bit.
//
// Bound on the H100: bytes.  The function reads sdn and jn_up and writes
// fdn and fup: four (L, C, Mp) planes, 0.25 ms at the canonical block
// (L = 800, C = 128, Mp = 504, float32).  The design adds one write and
// one partial read of fup between stages 2 and 3.
#pragma once
#include "sos_tiles.cuh"

namespace sos {
namespace pb {

constexpr int ROW_WARPS = 8;        // rows of a block of the row-parallel stages
constexpr int WALK_UNROLL = 8;      // layers whose loads the walk issues ahead
constexpr unsigned FULL = 0xffffffffu;

// dynamic shared memory (elements) of pass_b_band: a row and slot band values a warp
__host__ __device__ constexpr int band_smem_elems(int Mp) { return ROW_WARPS * (Mp + 32); }

// Stage 1: fdn of local field row r = t*C + c for every row, warp-uniform.
// AB (ablation bits of sos_tiles.cuh; 0 for the solve): AB_NOPOLY writes
// -sdn / mu with the mu=0- and pad rows zeroed, no band fix.
template <typename T, int MODE, int AB = 0>
__global__ void __launch_bounds__(32 * ROW_WARPS)
pass_b_band(PassBArgs<T> a, int R) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + warp;
  if (r >= R) return;
  const int Mp = a.Mp, mr = a.mr, slot = a.slot;
  T* sv = reinterpret_cast<T*>(band_smem) + (size_t)warp * (Mp + 32);
  T* spoly = sv + Mp;
  const T* ivdn = a.colc + RC_IVDN * Mp;
  const T* sdn = a.sdn + (size_t)r * Mp;
  if constexpr ((AB & AB_NOPOLY) != 0) {
    T* out = a.fdn + (size_t)r * Mp;
    for (int n = lane; n < Mp; n += 32) out[n] = n >= mr - 1 ? T(0) : -sdn[n] * ivdn[n];
    return;
  }
  for (int n = lane; n < Mp; n += 32) {
    T fv = -sdn[n] * ivdn[n];
    if (n >= mr - 1) fv = T(0);                // mu=0- row and pad rows
    sv[n] = fv;
  }
  __syncwarp();
  const int choice = (int)a.pack[a.pm.pk(PK_CHOICE, r)];
  if (lane < slot) {
    const int row = choice * slot + lane;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < N_TAPS; ++j) {
      T x[3];
      split_x<T, MODE>(sv[a.tap_col[row * N_TAPS + j]], x);
      acc = add_terms<T, MODE>(acc, a.tap_hi[row * N_TAPS + j], a.tap_lo[row * N_TAPS + j], x);
    }
    spoly[lane] = acc;
  }
  __syncwarp();
  T* out = a.fdn + (size_t)r * Mp;
  for (int n = lane; n < Mp; n += 32) {
    T fv = sv[n];
    const int i = mr - 1 - n;
    if (i >= 0 && i < slot && a.pvt[choice * Mp + n] > T(0.5)) fv = split_sum<T, MODE>(spoly[i]);
    out[n] = fv;
  }
}

// dynamic shared memory (elements) of pass_b_up: a row and its NX bf16 parts
template <typename T, int MODE>
__host__ __device__ constexpr int up_smem_elems(int Mp) { return (1 + Parts<MODE>::NX) * Mp; }

// Stage 2: column blockIdx.x, thread n = angle (threads n >= Mp only keep
// the barriers).  AB (0 for the solve): AB_NOLOOPS drops the up carry (r =
// src at every layer), AB_NOFIN the join corrections and the join rows'
// smoothing, AB_NOSMOOTH the join rows' smoothing (d = 0 there); the
// caller then launches no pass_b_smooth.
template <typename T, int MODE, int AB = 0>
__global__ void __launch_bounds__(1024) pass_b_up(PassBArgs<T> a) {
  extern __shared__ __align__(16) unsigned char up_smem[];
  __shared__ int sred[32];
  constexpr int NX = Parts<MODE>::NX, U = WALK_UNROLL;
  const int cl = blockIdx.x, n = threadIdx.x, nw = blockDim.x >> 5;
  const int L = a.pm.L, Cl = a.pm.Cl, Mp = a.Mp, mr = a.mr;
  const bool act = n < Mp;
  T* sv = reinterpret_cast<T*>(up_smem);      // Mp values of a row
  T* sx = sv + Mp;                            // NX * Mp bf16 parts of sv
  const T* colc = a.colc;
  const T ivup = act ? colc[RC_IVUP * Mp + n] : T(0);
  const T emu_up = act ? colc[RC_EMU_UP * Mp + n] : T(0);
  const T muup = act ? colc[RC_MUUP * Mp + n] : T(0);
  auto pk = [&](int row, int t) { return a.pack[a.pm.at(row, t, cl)]; };
  auto at = [&](int t) { return (size_t)(t * Cl + cl) * Mp + n; };

  // surface BC from the deepest layer's band-fixed I_down (stage 1)
  if (act) {
    const T v = a.fdn[at(L - 1)];
    T p[3];
    split_x<T, MODE>(v, p);
    sv[n] = v;
#pragma unroll
    for (int h = 0; h < NX; ++h) sx[h * Mp + n] = p[h];
  }
  __syncthreads();
  T rcar = T(0);
  if (act) {
    if (n == 0) {
      rcar = a.jnup[at(L - 1)];
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

  T q1 = T(0), q2 = T(0);
  const T corr = n >= 1 ? T(1) : T(0);
  for (int t0 = L - 1; t0 >= 0; t0 -= U) {
    T jn[U], hdt[U], cup[U], gs[U];
    int join[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        jn[u] = act ? a.jnup[at(t)] : T(0);
        hdt[u] = pk(PK_HDT_UP, t);
        cup[u] = pk(PK_CUP, t);
        gs[u] = pk(PK_GS, t);
        join[u] = (pk(PK_R1, t) > T(0.5) ? 1 : 0) | (pk(PK_R2, t) > T(0.5) ? 2 : 0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t < 0) break;                      // the same t for the whole block
      // upward recurrence; the mu=0+ row rides along pinned to jn
      const T attu = n == 0 ? T(0) : exp_t(T(2) * hdt[u] * emu_up);
      const T jiv = ivup * jn[u];
      const T src = n == 0 ? jn[u] : cup[u] * jiv;
      const T gsv = gs[u] * jiv;
      if constexpr ((AB & AB_NOLOOPS) != 0) rcar = src;
      else rcar = attu * rcar + src;
      T f = rcar - gsv;
      if constexpr ((AB & AB_NOFIN) == 0) {
        q1 = q1 * attu;
        q2 = q2 * attu;
        f = f + corr * (q1 + q2);
        if (join[u] != 0) {                  // a join row of the block's column
          T sm = f;
          if constexpr ((AB & AB_NOSMOOTH) == 0) {
            __syncthreads();                 // the last readers of sv are done
            if (act) sv[n] = f;
            __syncthreads();
            sm = smooth_up_walk<T>(sv, colc, RC_MUUP * Mp, mr, n, muup, f,
                                   GroupMin{sred, 0, nw});
          }
          const T d = sm - f;
          if (join[u] & 1) q1 = d;
          if (join[u] & 2) q2 = d;
        }
      }
      if (act) a.fup[at(t)] = f;
    }
  }
}

// Stage 3: the mu->0+ smoothing walk (smooth_up_walk's rule) of local field
// row r of fup, in place, for every row, warp-uniform.
template <typename T>
__global__ void __launch_bounds__(32 * ROW_WARPS)
pass_b_smooth(T* fup, const T* __restrict__ colc, int R, int Mp, int mr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + warp;
  if (r >= R) return;
  T* f = fup + (size_t)r * Mp;
  const T* mu = colc + RC_MUUP * Mp;
  const int last = mr - 3;                   // candidates k in [1, last]
  // the first k whose second difference |f[k] - 2 f[k+1] + f[k+2]| <= 1e-4,
  // 32 angles a step: lane l holds k0 + l (cur) and k0 + 32 + l (nxt)
  int cand = BIG_ROW;
  T cur = lane < Mp ? f[lane] : T(0);
  for (int k0 = 0; k0 <= last; k0 += 32) {
    const T nxt = k0 + 32 + lane < Mp ? f[k0 + 32 + lane] : T(0);
    const T v1 = __shfl_sync(FULL, lane == 0 ? nxt : cur, (lane + 1) & 31);
    const T v2 = __shfl_sync(FULL, lane < 2 ? nxt : cur, (lane + 2) & 31);
    const int k = k0 + lane;
    bool ok = false;
    if (k >= 1 && k <= last) ok = abs_t(cur - T(2) * v1 + v2) <= T(1e-4);
    const unsigned found = __ballot_sync(FULL, ok);
    if (found != 0) {
      cand = k0 + __ffs(found) - 1;
      break;
    }
    cur = nxt;
  }
  const int idx = min(cand, last) + 1;
  const T s0 = f[0], si = f[idx], mi = mu[idx];
  for (int n = 1 + lane; n < idx; n += 32) {
    const T w = mu[n] / mi;
    f[n] = (T(1) - w) * s0 + w * si;
  }
}

}  // namespace pb
}  // namespace sos
