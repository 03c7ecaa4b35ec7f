// Hand-written Hopper kernels of the fused engine's two radiance sweeps.
//
// They replace the two Pallas TPU kernels of sos_rt_tpu/ops/pallas_sweeps.py:
//   sos_down_sweep <- _down_kernel  (forward affine recurrence over layers
//                                    for all mu <= 0 columns)
//   sos_up_walk, sos_up_joins, sos_up_rows
//                  <- _up_kernel    (reverse recurrence from the surface BC
//                                    with the quadrature dropped at the two
//                                    region joins, the smoothing deltas of
//                                    the two join rows chained through the
//                                    layers, and the mu -> 0+ smoothing walk
//                                    on every layer row: three kernels)
// Plain PyTorch versions of the same functions live beside their wrappers
// in sos_rt_tpu_torch/ops/fused_sweeps.py; the CPU runs those.
//
// Layout: the engine's own (B, L, M), angles contiguous.  The TPU kernels
// work on (L, bt, M) transposes so that a layer step is one vector tile;
// here a warp reads a run of angles of one (column, layer) row, which is
// coalesced as it stands, so nothing is transposed or padded.  The source
// jn may be a view of a wider (B, L, 2M) tensor: its column and layer
// strides are arguments (the angle stride is 1).  Per-(column, layer)
// scalars are pack (B, L, 8), per-column scalars cpar (B, 8).
//
// Both kernels are bound by bytes: one read of jn and one write of the
// field per call (plus pack), against a few operations and one to three
// exponentials per value.  What the design does about it:
// - down: one thread per (column, angle) keeps S and J_{t-1} in registers
//   and walks the layers in order.  Nothing but the walk is serial, so the
//   loads run ahead of it: a ring of DOWN_RING = 32 registers holds J_t ..
//   J_{t+31}, and the slot J_t leaves is refilled with J_{t+32} at once, so
//   32 loads stay in flight per thread.  Why that many: at the
//   fused_canonical block (B = 64, L = 800, M = 501) the card holds
//   64 x 501 = 32,064 walkers, 7.6 warps an SM, and needs about
//   3.35 TB/s x 0.7 us = 2.3 MB, 18 KB an SM, in flight; a loop unrolled 4
//   deep keeps ~4 KB an SM (29% of the bytes bound there on an H100 80GB
//   HBM3 at 700 W; rings of 8 and 16 were slower than 32 at both main-path
//   blocks, PERF.md).  The w of a layer is the same for the whole column:
//   lane u of a warp loads the w of layer t0 + u once a chunk of 32 layers
//   (the next chunk's while the walk runs this one) and the walk takes it
//   by a shuffle.  Blocks of DOWN_THREADS = 256 angles, whole warps, fewer
//   when M is smaller.  What is left is the layout: a row of 501 floats is
//   only 4-byte aligned, so a warp's loads and stores straddle two 128-byte
//   lines and end in part sectors.
// - up: three launches, split by what depends on the layer below.
//   up_sweep_walk: one thread per (column, angle), on a grid like down's,
//   walks t = L-1 .. 0 with the carry in a register, writes the raw field
//   into the output buffer and the two join rows, picked up by their
//   one-hot lanes, into a (B, 2, M) buffer.  up_sweep_joins: one block per
//   column smooths the two join rows (a block-wide first-index minimum
//   each: warp shuffles, then one value per warp through shared memory) and
//   leaves their deltas d1, d2 in that buffer.  up_sweep_rows: every
//   (column, layer) row alone, one warp a row on every SM: the chained
//   corrections from d1, d2, then the smoothing walk (a warp-wide minimum),
//   in place.  No layer waits for another's smoothing, and no block barrier
//   is left in a layer loop.
// The arithmetic keeps one order of separately rounded operations (built
// with -fmad=false) in the kernel and in the plain version, because the walk
// compares a second difference with 1e-4: a last-bit change can move a
// blend endpoint.
// Every entry point returns cudaGetLastError(); the caller raises on non-0.
#include <cuda_runtime.h>

namespace {

enum { PK_TAU = 0, PK_DROP, PK_CH1, PK_CH2, PK_R1, PK_R2, PK_HDT_DN, PK_HDT_UP, PK_W };
enum { CP_TAU_R1 = 0, CP_TAU_R2 = 1, CP_W = 8 };
constexpr int BIG_LANE = 1 << 30;
constexpr int MAX_WARPS = 32;
constexpr int DOWN_RING = 32;     // J loads in flight per down-sweep thread
constexpr int DOWN_THREADS = 256; // a down-sweep block's angles, at most

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_t(double a, double b) { return fmax(a, b); }

// D layers t0 .. t0+D-1 of the down walk (only those below L when TAIL).
// Layer t takes J_t from ring slot t mod D (t0 is a multiple of D) and
// refills it with J_{t+D}; w_cur holds the chunk's w, lane u layer t0 + u.
// jq points at J_{t0+D}, oq at the output of layer t0; both move on.
template <typename T, int D, bool TAIL>
__device__ __forceinline__ void down_chunk(T (&ring)[D], T& s, T& j_prev, T w_cur, int t0,
                                           int L, const T*& jq, long long jn_ls, T*& oq,
                                           int M, T inv_mu, bool act) {
#pragma unroll
  for (int u = 0; u < D; ++u) {
    if (TAIL && t0 + u >= L) break;          // uniform over the block
    const T w = __shfl_sync(0xffffffffu, w_cur, u);
    const T j_t = ring[u];
    if (t0 + u + D < L) ring[u] = *jq;
    jq += jn_ls;
    const T a = exp_t((T(2) * w) * inv_mu);
    s = a * s + w * (j_prev * a + j_t);
    j_prev = j_t;
    if (act) *oq = -s * inv_mu;
    oq += M;
  }
}

// S_t = a S_{t-1} + w (J_{t-1} a + J_t), a = exp(2 w / mu), I_t = -S_t / mu
// for column blockIdx.x and angle n; w = pack[.., PK_HDT_DN] (0 at t = 0).
// The same operations in the same order as down_sweep_plain: the ring only
// moves the loads earlier.  Lanes past M read angle M-1 (the shuffles need
// the whole warp) and store nothing.
template <typename T>
__global__ void down_sweep(const T* __restrict__ jn, const T* __restrict__ pack,
                           const T* __restrict__ mu, T* __restrict__ out, int L,
                           int M, long long jn_bs, long long jn_ls) {
  constexpr int D = DOWN_RING;
  const int b = blockIdx.x;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool act = n < M;
  const int nc = act ? n : M - 1;
  const T inv_mu = T(1) / mu[nc];
  const T* jq = jn + (size_t)b * jn_bs + nc;
  const T* wp = pack + (size_t)b * L * PK_W + PK_HDT_DN;
  T* oq = out + (size_t)b * L * M + nc;
  T ring[D];
#pragma unroll
  for (int u = 0; u < D; ++u) {
    ring[u] = u < L ? *jq : T(0);
    jq += jn_ls;
  }
  T w_cur = lane < D && lane < L ? wp[(size_t)lane * PK_W] : T(0);
  T s = T(0), j_prev = T(0);
  int t0 = 0;
  for (; t0 + D <= L; t0 += D) {
    const int tn = t0 + D + lane;
    const T w_next = lane < D && tn < L ? wp[(size_t)tn * PK_W] : T(0);
    down_chunk<T, D, false>(ring, s, j_prev, w_cur, t0, L, jq, jn_ls, oq, M, inv_mu, act);
    w_cur = w_next;
  }
  if (t0 < L)
    down_chunk<T, D, true>(ring, s, j_prev, w_cur, t0, L, jq, jn_ls, oq, M, inv_mu, act);
}

// min of v over the block: warp shuffles, then one value per warp through
// sred (nw ints).  Holds one block barrier; the caller alternates between
// two sred buffers, so none is needed after the read.
__device__ __forceinline__ int block_min(int v, int* sred, int nw) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = BIG_LANE;
  for (int w = 0; w < nw; ++w) m = min(m, sred[w]);
  return m;
}

// The mu -> 0+ smoothing walk on the row staged in sv (lane 0 = mu = 0+):
// the first lane k in 1 .. M-3 whose second difference is <= 1e-4 (M-3 when
// none is) gives the blend endpoint idx = k + 1; lanes 1 .. idx-1 become the
// linear blend between sv[0] and sv[idx] with weight mu_n / mu_idx.  Returns
// lane n's value.  All threads of the block call it after a barrier that
// follows the staging.
template <typename T>
__device__ __forceinline__ T smooth_lane(const T* sv, const T* smu, int n, int M,
                                         int* sred, int nw) {
  int cand = BIG_LANE;
  if (n >= 1 && n <= M - 3) {
    const T d = abs_t((sv[n] - sv[n + 1]) - (sv[n + 1] - sv[n + 2]));
    if (d <= T(1e-4)) cand = n;
  }
  const int idx = min(block_min(cand, sred, nw), M - 3) + 1;
  T v = n < M ? sv[n] : T(0);
  if (n >= 1 && n < idx) {
    const T w = smu[n] / smu[idx];
    v = (T(1) - w) * sv[0] + w * sv[idx];
  }
  return v;
}

// Pass 1: thread n = angle lane of column blockIdx.x (lane 0 = mu = 0+,
// where I = jn): the reverse recurrence into out, the join rows into
// rows (B, 2, M).  Slot L-1 is the identity step (drop = 1, w = 0).
template <typename T>
__global__ void up_sweep_walk(const T* __restrict__ jn, const T* __restrict__ pack,
                              const T* __restrict__ mu, const T* __restrict__ bc,
                              T* __restrict__ out, T* __restrict__ rows, int L, int M,
                              long long jn_bs, long long jn_ls) {
  const int b = blockIdx.x;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= M) return;
  const bool lane0 = n == 0;
  const T mu_n = mu[n];
  const T inv_mu = T(1) / (mu_n == T(0) ? T(1) : mu_n);
  const T* pk = pack + (size_t)b * L * PK_W;
  const T* jp = jn + (size_t)b * jn_bs + n;
  T* op = out + (size_t)b * L * M + n;
  T row1 = T(0), row2 = T(0);
  T s = lane0 ? jp[(size_t)(L - 1) * jn_ls] : bc[(size_t)b * M + n];
  T j_next = T(0);
#pragma unroll 4
  for (int t = L - 1; t >= 0; --t) {
    const T* p = pk + (size_t)t * PK_W;
    const T w = p[PK_HDT_UP];
    const T j_t = jp[(size_t)t * jn_ls];
    const T a = exp_t((T(-2) * w) * inv_mu);
    T c = w * inv_mu * (j_t + j_next * a);
    if (p[PK_DROP] > T(0.5)) c = T(0);
    s = a * s + c;
    if (lane0) s = j_t;
    j_next = j_t;
    op[(size_t)t * M] = s;
    row1 = row1 + p[PK_R1] * s;
    row2 = row2 + p[PK_R2] * s;
  }
  rows[(size_t)b * 2 * M + n] = row1;
  rows[((size_t)b * 2 + 1) * M + n] = row2;
}

// The smoothing deltas at the two joins of column blockIdx.x, thread n =
// angle lane: d1 = smooth(row1) - row1 reaches row 2 attenuated, d2 =
// smooth(row2 + d1 att_12) - (row2 + d1 att_12); both overwrite their rows.
// Shared memory: two rows of M values and the mu row.
template <typename T>
__global__ void up_sweep_joins(const T* __restrict__ cpar, const T* __restrict__ mu,
                               T* rows, int M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sred[2][MAX_WARPS];
  T* srow = reinterpret_cast<T*>(smem_raw);       // rows 0 and 1
  T* smu = srow + 2 * M;
  const int b = blockIdx.x, n = threadIdx.x, nw = blockDim.x >> 5;
  const bool act = n < M;
  const T mu_n = act ? mu[n] : T(1);
  if (act) smu[n] = mu_n;
  const T inv_mu = T(1) / (mu_n == T(0) ? T(1) : mu_n);
  T* r1 = rows + (size_t)b * 2 * M;
  T* r2 = r1 + M;
  const T row1 = act ? r1[n] : T(0), row2 = act ? r2[n] : T(0);
  const T tau_r1 = cpar[(size_t)b * CP_W + CP_TAU_R1];
  const T tau_r2 = cpar[(size_t)b * CP_W + CP_TAU_R2];
  if (act) srow[n] = row1;
  __syncthreads();
  const T d1 = smooth_lane<T>(srow, smu, n, M, sred[0], nw) - row1;
  const T att_12 = exp_t(-max_t(tau_r1 - tau_r2, T(0)) * inv_mu);
  const T row2c = row2 + d1 * att_12;
  if (act) srow[M + n] = row2c;
  __syncthreads();
  const T d2 = smooth_lane<T>(srow + M, smu, n, M, sred[1], nw) - row2c;
  if (act) {
    r1[n] = d1;
    r2[n] = d2;
  }
}

constexpr int ROW_WARPS = 8;    // (column, layer) rows of an up_sweep_rows block

// Row r = b*L + t of the up field, one warp: the chained corrections
// ch1 d1 att1 + ch2 d2 att2 (0 on lane 0) added to the raw row, then the
// smoothing walk (smooth_lane's rule: the first lane k in 1 .. M-3 whose
// second difference is <= 1e-4, M-3 when none is, blends lanes 1 .. k with
// weight mu_n / mu_{k+1}), in place.  Shared memory: a row a warp.
template <typename T>
__global__ void __launch_bounds__(32 * ROW_WARPS)
up_sweep_rows(const T* __restrict__ pack, const T* __restrict__ cpar,
              const T* __restrict__ mu, const T* __restrict__ dd, T* out, int B, int L,
              int M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + warp;
  if (r >= B * L) return;
  const int b = r / L;
  T* sv = reinterpret_cast<T*>(smem_raw) + (size_t)warp * M;
  const T* p = pack + (size_t)r * PK_W;
  const T tau_t = p[PK_TAU], ch1 = p[PK_CH1], ch2 = p[PK_CH2];
  const T tau_r1 = cpar[(size_t)b * CP_W + CP_TAU_R1];
  const T tau_r2 = cpar[(size_t)b * CP_W + CP_TAU_R2];
  const T* d1 = dd + (size_t)b * 2 * M;
  const T* d2 = d1 + M;
  T* op = out + (size_t)r * M;
  for (int n = lane; n < M; n += 32) {
    const T mu_n = mu[n];
    const T inv_mu = T(1) / (mu_n == T(0) ? T(1) : mu_n);
    const T att1 = exp_t(-max_t(tau_r1 - tau_t, T(0)) * inv_mu);
    const T att2 = exp_t(-max_t(tau_r2 - tau_t, T(0)) * inv_mu);
    T corr = ch1 * d1[n] * att1 + ch2 * d2[n] * att2;
    if (n == 0) corr = T(0);
    sv[n] = op[n] + corr;
  }
  __syncwarp();
  int cand = BIG_LANE;
  for (int n = lane; n <= M - 3; n += 32) {
    if (n >= 1 && abs_t((sv[n] - sv[n + 1]) - (sv[n + 1] - sv[n + 2])) <= T(1e-4)) {
      cand = n;
      break;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, o));
  const int idx = min(cand, M - 3) + 1;
  const T s0 = sv[0], si = sv[idx], mi = mu[idx];
  for (int n = lane; n < M; n += 32) {
    T v = sv[n];
    if (n >= 1 && n < idx) {
      const T w = mu[n] / mi;
      v = (T(1) - w) * s0 + w * si;
    }
    op[n] = v;
  }
}

// launch up_sweep_rows over the B*L rows
template <typename T>
int launch_rows(const void* pack, const void* cpar, const void* mu, const void* rows,
                void* out, int B, int L, int M, cudaStream_t st) {
  const size_t smem = (size_t)ROW_WARPS * M * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        up_sweep_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nrows = (long long)B * L;
  up_sweep_rows<T><<<(unsigned)((nrows + ROW_WARPS - 1) / ROW_WARPS), 32 * ROW_WARPS, smem,
                     st>>>((const T*)pack, (const T*)cpar, (const T*)mu, (const T*)rows,
                           (T*)out, B, L, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64.  jn_bs / jn_ls: elements between two columns /
// two layers of jn.
int sos_down_sweep(int dtype, const void* jn, const void* pack, const void* mu,
                   void* out, int B, int L, int M, long long jn_bs,
                   long long jn_ls, void* stream) {
  if (B < 1 || L < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const int nt = M >= DOWN_THREADS ? DOWN_THREADS : ((M + 31) / 32) * 32;
  const dim3 grid(B, (M + nt - 1) / nt);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    down_sweep<float><<<grid, nt, 0, st>>>((const float*)jn, (const float*)pack,
                                           (const float*)mu, (float*)out, L, M,
                                           jn_bs, jn_ls);
  } else if (dtype == 1) {
    down_sweep<double><<<grid, nt, 0, st>>>((const double*)jn, (const double*)pack,
                                            (const double*)mu, (double*)out, L, M,
                                            jn_bs, jn_ls);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The up sweep in three launches on one stream; rows: a (B, 2, M) buffer
// that carries the join rows, then their deltas, from one to the next.  The
// caller checks each one's return code.
int sos_up_walk(int dtype, const void* jn, const void* pack, const void* mu, const void* bc,
                void* out, void* rows, int B, int L, int M, long long jn_bs,
                long long jn_ls, void* stream) {
  if (B < 1 || L < 1 || M < 4) return (int)cudaErrorInvalidValue;
  const int nt = M >= 128 ? 128 : ((M + 31) / 32) * 32;
  const dim3 grid(B, (M + nt - 1) / nt);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    up_sweep_walk<float><<<grid, nt, 0, st>>>(
        (const float*)jn, (const float*)pack, (const float*)mu, (const float*)bc,
        (float*)out, (float*)rows, L, M, jn_bs, jn_ls);
  } else if (dtype == 1) {
    up_sweep_walk<double><<<grid, nt, 0, st>>>(
        (const double*)jn, (const double*)pack, (const double*)mu, (const double*)bc,
        (double*)out, (double*)rows, L, M, jn_bs, jn_ls);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int sos_up_joins(int dtype, const void* cpar, const void* mu, void* rows, int B, int M,
                 void* stream) {
  const int nt = ((M + 31) / 32) * 32;
  if (B < 1 || M < 4 || nt > 32 * MAX_WARPS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    up_sweep_joins<float><<<B, nt, 3 * M * sizeof(float), st>>>(
        (const float*)cpar, (const float*)mu, (float*)rows, M);
  } else if (dtype == 1) {
    up_sweep_joins<double><<<B, nt, 3 * M * sizeof(double), st>>>(
        (const double*)cpar, (const double*)mu, (double*)rows, M);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int sos_up_rows(int dtype, const void* pack, const void* cpar, const void* mu,
                const void* rows, void* out, int B, int L, int M, void* stream) {
  if (B < 1 || L < 1 || M < 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_rows<float>(pack, cpar, mu, rows, out, B, L, M, st);
  if (dtype == 1) return launch_rows<double>(pack, cpar, mu, rows, out, B, L, M, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
