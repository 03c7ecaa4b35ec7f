"""The fused engine's two radiance sweeps: kernels, plain versions, pack.

Counterpart of ``sos_rt_tpu/ops/pallas_sweeps.py``.  The wide work of one
scattering order is one read of Jₙ and one write of Iₙ per sweep
direction:

- :func:`down_sweep` — the forward affine recurrence over layers
      S_t = e^{Δτ/µ} S_{t-1} + (Δτ/2)(J_{t-1} e^{Δτ/µ} + J_t),  I_t = −S_t/µ
  for all µ ≤ 0 columns (main_lambertian.py:332-387 telescoped).
- :func:`up_sweep_smooth` — the reverse recurrence from the surface BC with
  the quadrature dropped at the two region joins, the smoothing deltas of
  the two join rows chained through the layers, and the µ→0⁺ smoothing walk
  on every layer row (main_lambertian.py:390-451).  Lane 0 of the up half
  is the µ=0⁺ column (I = Jₙ, no recurrence); lanes 1..M-1 are µ>0.

The narrow small-µ and polyfit-band fixes (a handful of columns) stay
between the two calls, in ``sos_rt_tpu_torch/fused.py``.

Each sweep is a wrapper: on a CUDA tensor it launches the hand-written
kernel of ``csrc/fused_sweeps.cu`` (or raises) and adds one to its
``launches`` count; on a CPU tensor it runs the plain PyTorch version
beside it (:func:`down_sweep_plain`, :func:`up_sweep_smooth_plain`), which
is also what the kernels are held against on the card.  The plain versions
repeat the kernels' arithmetic operation by operation, so that the µ→0⁺
walk's threshold sees the same bits.

Layout: fields are (B, L, M) with angles last, as the engine holds them;
the source may be a view of the (B, L, 2M) Jₙ.  Per-layer scalars are
``pack`` (B, L, 8) = [τ, join-drop, chain1 (t ≤ idx_down), chain2
(t < idx_up), onehot(r1), onehot(r2), Δτ/2 at slot t (down), Δτ/2 of
[t, t+1] at slot t (up)]; per-column scalars ``cparams`` (B, 8) =
[τ_r1, τ_r2, 0...].  Any B and any L run: nothing is padded.
"""
from __future__ import annotations

import torch

from sos_rt_tpu_torch.grids import neighbour_index
from sos_rt_tpu_torch.ops import cuda_build
from sos_rt_tpu_torch.ops.sweeps import SMOOTH_TOL

BIG = 1e9
MAX_UP_ANGLES = 1024        # one thread per angle lane in the join kernel's block

# pack lane indices
PK_TAU, PK_DROP, PK_CH1, PK_CH2, PK_R1, PK_R2, PK_HDT_DN, PK_HDT_UP = range(8)
PK_W = 8

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def build_pack(tau, idx_up, idx_down, dtype):
    """(B, L, 8) per-layer pack + (B, 8) per-column scalars.

    Loop-invariant; built once per solve (see the module docstring for the
    lanes).  DROP is forced to 1 at t = L-1, the up sweep's identity step:
    the reverse recurrence has no interval above the surface row."""
    B, L = tau.shape
    dev = tau.device
    t = torch.arange(L, device=dev)[None, :]
    iu = idx_up[:, None]
    idn = idx_down[:, None]
    drop = ((t == idn) | (t == iu - 1) | (t == L - 1)).to(dtype)
    ch1 = (t <= idn).to(dtype)
    ch2 = (t < iu).to(dtype)
    # the lower join reads the layer below the aerosol layer, as the
    # reference engine reads it: the bottom layer when the aerosol layer
    # reaches it
    r1 = (t == neighbour_index(idn + 1, L)).to(dtype)
    r2 = (t == iu).to(dtype)
    dt = tau[:, 1:] - tau[:, :-1]
    zcol = torch.zeros((B, 1), dtype=dtype, device=dev)
    hdt_dn = torch.cat([zcol, 0.5 * dt], dim=1).to(dtype)
    hdt_up = torch.cat([0.5 * dt, zcol], dim=1).to(dtype)
    pack = torch.stack([tau.to(dtype), drop, ch1, ch2, r1, r2, hdt_dn, hdt_up], dim=-1)
    tau_r1 = torch.sum(r1 * tau, dim=1)
    tau_r2 = torch.sum(r2 * tau, dim=1)
    cparams = torch.stack([tau_r1, tau_r2] + [zcol[:, 0]] * 6, dim=-1).to(dtype)
    return pack.contiguous(), cparams.contiguous()


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def down_sweep_plain(jn_down, pack, mu_down_safe):
    """jn_down (B, L, M); pack (B, L, 8); mu_down_safe (M,), µ=0 → −1.
    Returns I↓ (B, L, M)."""
    L = jn_down.shape[1]
    inv_mu = 1.0 / mu_down_safe[None, :]
    s = torch.zeros_like(jn_down[:, 0])
    j_prev = torch.zeros_like(s)
    out = torch.empty(jn_down.shape, dtype=jn_down.dtype, device=jn_down.device)
    for t in range(L):
        w = pack[:, t, PK_HDT_DN][:, None]
        j_t = jn_down[:, t]
        a = torch.exp((2.0 * w) * inv_mu)
        s = a * s + w * (j_prev * a + j_t)
        j_prev = j_t
        out[:, t] = -s * inv_mu
    return out


def smooth_rows(row, mu_row):
    """µ→0⁺ smoothing walk on (..., M) rows; lane 0 is µ=0⁺ and ``mu_row``
    (M,) holds 0 there.  Walk lanes 1..M-3 for the first second difference
    ≤ 1e-4 (lane M-3 when there is none), take idx one lane further, and
    blend lanes 1..idx-1 linearly in µ between row[0] and row[idx]
    (main_lambertian.py:405-411)."""
    m = row.shape[-1]
    d = torch.abs((row[..., 1:m - 2] - row[..., 2:m - 1])
                  - (row[..., 2:m - 1] - row[..., 3:m]))
    lanes = torch.arange(m, device=row.device)
    first = torch.where(d <= SMOOTH_TOL, lanes[1:m - 2], int(BIG)).amin(dim=-1)
    idx = torch.clamp(first, max=m - 3) + 1                   # (...,)
    onehot = (lanes == idx[..., None]).to(row.dtype)
    i_val = torch.sum(row * onehot, dim=-1)
    mu_idx = torch.sum(mu_row * onehot, dim=-1)
    weight = mu_row / mu_idx[..., None]
    blended = (1.0 - weight) * row[..., 0:1] + weight * i_val[..., None]
    do = (lanes >= 1) & (lanes < idx[..., None])
    return torch.where(do, blended, row)


def up_sweep_smooth_plain(jn_up, pack, cparams, mu_up_row, bc):
    """jn_up (B, L, M), lane 0 the µ=0⁺ column; pack (B, L, 8); cparams
    (B, 8); mu_up_row (M,) with lane 0 = 0; bc (B, M), lane 0 unused.
    Returns the smoothed I↑ (B, L, M)."""
    B, L, m = jn_up.shape
    mu_row = mu_up_row[None, :]
    inv_mu = 1.0 / torch.where(mu_row == 0, 1.0, mu_row)
    lane0 = torch.arange(m, device=jn_up.device)[None, :] == 0

    # reverse recurrence; slot L-1 is the identity step (drop=1, a=1 via
    # w=0); the rows at the two joins (t = idx_down+1 and t = idx_up) are
    # picked up by their one-hot pack lanes
    s = torch.where(lane0, jn_up[:, L - 1], bc)
    j_next = torch.zeros_like(s)
    row1 = torch.zeros_like(s)
    row2 = torch.zeros_like(s)
    raw = torch.empty(jn_up.shape, dtype=jn_up.dtype, device=jn_up.device)
    for t in range(L - 1, -1, -1):
        w = pack[:, t, PK_HDT_UP][:, None]
        drop = pack[:, t, PK_DROP][:, None]
        j_t = jn_up[:, t]
        a = torch.exp((-2.0 * w) * inv_mu)
        c = w * inv_mu * (j_t + j_next * a)
        c = torch.where(drop > 0.5, 0.0, c)
        s = a * s + c
        s = torch.where(lane0, j_t, s)
        j_next = j_t
        raw[:, t] = s
        row1 = row1 + pack[:, t, PK_R1][:, None] * s
        row2 = row2 + pack[:, t, PK_R2][:, None] * s

    # smoothing deltas at the two joins; r2 = idx_up ≤ idx_down = r1-1, so
    # the d1 chain always reaches row r2
    tau_r1 = cparams[:, 0:1]
    tau_r2 = cparams[:, 1:2]
    d1 = smooth_rows(row1, mu_up_row) - row1
    att_12 = torch.exp(-torch.clamp(tau_r1 - tau_r2, min=0.0) * inv_mu)
    row2c = row2 + d1 * att_12
    d2 = smooth_rows(row2c, mu_up_row) - row2c

    # final pass: chaining + smoothing, per layer
    out = torch.empty_like(raw)
    for t in range(L):
        tau_t = pack[:, t, PK_TAU][:, None]
        ch1 = pack[:, t, PK_CH1][:, None]
        ch2 = pack[:, t, PK_CH2][:, None]
        att1 = torch.exp(-torch.clamp(tau_r1 - tau_t, min=0.0) * inv_mu)
        att2 = torch.exp(-torch.clamp(tau_r2 - tau_t, min=0.0) * inv_mu)
        corr = ch1 * d1 * att1 + ch2 * d2 * att2
        corr = torch.where(lane0, 0.0, corr)
        out[:, t] = smooth_rows(raw[:, t] + corr, mu_up_row)
    return out


# --------------------------------------------------------------------------
# Wrappers: the CUDA kernel on a card, the plain version on the CPU
# --------------------------------------------------------------------------

def _check(jn, *dense):
    """Check what the kernels take: one floating dtype and device, ``jn``
    with contiguous angles (it may be a view of the (B, L, 2M) source:
    the kernels are given its column and layer strides), everything else
    contiguous.  Returns (dtype code, stream)."""
    if jn.dtype not in _DTYPE_CODE:
        raise ValueError(f"the sweep kernels take float32 or float64; got {jn.dtype}")
    if jn.dim() != 3 or jn.stride(2) != 1:
        raise ValueError("the source must be (B, L, M) with contiguous angles; "
                         f"got shape {tuple(jn.shape)}, strides {jn.stride()}")
    for t in dense:
        if t.device != jn.device or t.dtype != jn.dtype or not t.is_contiguous():
            raise ValueError(
                f"kernel operand must be a contiguous {jn.dtype} tensor on "
                f"{jn.device}; got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    return _DTYPE_CODE[jn.dtype], torch.cuda.current_stream(jn.device).cuda_stream


def down_sweep(jn_down, pack, mu_down_safe):
    """The downward sweep I↓ (B, L, M) of one order.  Replaces
    sos_rt_tpu/ops/pallas_sweeps.py::_down_kernel.  Bound by bytes (one
    read of Jₙ, one write of I↓); one thread per (column, angle) walks the
    layers with the carry in registers, a ring of 32 registers keeping the
    next layers' loads in flight (csrc/fused_sweeps.cu)."""
    if not jn_down.is_cuda:
        return down_sweep_plain(jn_down, pack, mu_down_safe)
    dt, stream = _check(jn_down, pack, mu_down_safe)
    B, L, M = jn_down.shape
    if pack.shape != (B, L, PK_W) or mu_down_safe.shape != (M,):
        raise ValueError(f"pack {tuple(pack.shape)} / mu {tuple(mu_down_safe.shape)} "
                         f"do not fit the source {tuple(jn_down.shape)}")
    out = torch.empty((B, L, M), dtype=jn_down.dtype, device=jn_down.device)
    lib = cuda_build.library("fused_sweeps")
    with torch.cuda.device(jn_down.device):  # the launch acts on the current device
        cuda_build.check(lib.sos_down_sweep(
            dt, jn_down.data_ptr(), pack.data_ptr(), mu_down_safe.data_ptr(),
            out.data_ptr(), B, L, M, jn_down.stride(0), jn_down.stride(1), stream),
            "sos_down_sweep")
    down_sweep.launches += 1
    return out


def up_sweep_smooth(jn_up, pack, cparams, mu_up_row, bc):
    """The upward sweep with join chaining and smoothing, I↑ (B, L, M).
    Replaces sos_rt_tpu/ops/pallas_sweeps.py::_up_kernel.  Bound by bytes
    (one read of Jₙ, one write of I↑).  Three kernels (csrc/fused_sweeps.cu)
    split it by what depends on the layer below: one thread per (column,
    angle) walks the layers (``sos_up_walk``), one block per column smooths
    the two join rows (``sos_up_joins``; their deltas go through a (B, 2, M)
    buffer), and one warp per (column, layer) row adds the chained
    corrections and smooths it (``sos_up_rows``).  One launch of the sweep
    counts one."""
    if not jn_up.is_cuda:
        return up_sweep_smooth_plain(jn_up, pack, cparams, mu_up_row, bc)
    dt, stream = _check(jn_up, pack, cparams, mu_up_row, bc)
    B, L, M = jn_up.shape
    if (pack.shape != (B, L, PK_W) or cparams.shape != (B, 8)
            or mu_up_row.shape != (M,) or bc.shape != (B, M)):
        raise ValueError("pack / cparams / mu / bc do not fit the source "
                         f"{tuple(jn_up.shape)}")
    if not 4 <= M <= MAX_UP_ANGLES:
        raise ValueError(f"the up kernel takes 4 <= M <= {MAX_UP_ANGLES} angles; got {M}")
    out = torch.empty((B, L, M), dtype=jn_up.dtype, device=jn_up.device)
    rows = torch.empty((B, 2, M), dtype=jn_up.dtype, device=jn_up.device)
    lib = cuda_build.library("fused_sweeps")
    with torch.cuda.device(jn_up.device):
        cuda_build.check(lib.sos_up_walk(
            dt, jn_up.data_ptr(), pack.data_ptr(), mu_up_row.data_ptr(), bc.data_ptr(),
            out.data_ptr(), rows.data_ptr(), B, L, M, jn_up.stride(0), jn_up.stride(1),
            stream), "sos_up_walk")
        cuda_build.check(lib.sos_up_joins(
            dt, cparams.data_ptr(), mu_up_row.data_ptr(), rows.data_ptr(), B, M, stream),
            "sos_up_joins")
        cuda_build.check(lib.sos_up_rows(
            dt, pack.data_ptr(), cparams.data_ptr(), mu_up_row.data_ptr(), rows.data_ptr(),
            out.data_ptr(), B, L, M, stream), "sos_up_rows")
    up_sweep_smooth.launches += 1
    return out


down_sweep.launches = up_sweep_smooth.launches = 0
KERNELS = (down_sweep, up_sweep_smooth)      # the fused engine's kernels
