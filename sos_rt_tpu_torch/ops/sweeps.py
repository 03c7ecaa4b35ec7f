"""Scan-based radiance sweeps and their static stencils.

Counterpart of ``sos_rt_tpu/ops/sweeps.py``.  The reference's per-layer
trapezoid integrals (SOS_Aer_main_lambertian.py:328-451) telescope into one
affine recurrence over layers per sweep direction,

    S_t = a_t S_{t-1} + b_t,   a_t = e^{Δτ_t/µ},
    b_t = (Δτ_t/2)(J_{t-1} a_t + J_t),     I_t = -S_t/µ

(mirrored for the upward sweep, with b=0 at the two region joins), which
:func:`_affine_scan` evaluates as an associative scan in the same pairing
as the TPU package, or as a loop over layers.  Also here:

- the µ→0⁻ polyfit band (SOS_Aer_In_limit.py:113-141) has four possible
  static widths (main_lambertian.py:344-347); its np.polyfit stencils are
  precomputed per width and selected per column by τ thresholds
  (:func:`polyfit_band_variants` / :func:`select_band_choice`,
  :func:`region_band_choices`);
- the small-µ column set (|µ| < 0.01), its Taylor mask and the windowed
  asymptotic integral over it (:func:`small_mu_window`,
  :func:`down_small_mu`);
- the whole µ→0⁻ down-fix of every host-loop engine, :class:`DownFix`, on
  the stencils copied to the device once (:func:`device_stencils`);
- the µ→0⁺ smoothing walk as a first-index reduction and one-hot
  reductions per row (:func:`smooth_up_rows`).

Every function takes a leading (B,) column axis where the TPU package
maps over columns: fields are (B, L, M), τ profiles (B, L), region
indices (B,).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import numpy as np
import torch

from sos_rt_tpu_torch.config import (MU_THRESHOLD, MU_VERY_SMALL_THRESHOLD,
                                     full_precision_matmul)
from sos_rt_tpu_torch.grids import neighbour_index

SMOOTH_TOL = 1e-4   # second-difference walk threshold (main_lambertian.py:406)
EXP_CLAMP = -80.0   # clamp for masked-out exponents


def _band_variants(nb_angles: int) -> Tuple[int, ...]:
    """The four possible polyfit band widths (main_lambertian.py:344-347)."""
    m = nb_angles
    return (int(0.005 * m), int(0.02 * m), int(0.04 * m), int(0.06 * m))


def _polyfit_stencil(mu_down: np.ndarray, band: int):
    """Linear map replicating _improved_limit_mu_down for a static band.

    Returns (src_cols, W) with  poly[i] = Σ_j W[i, j]·row[src_cols[j]]
    for targets i = 0..band-1 (target column = M-1-i), found by probing
    np.polyfit with unit vectors (SOS_Aer_In_limit.py:113-141).
    """
    m = len(mu_down)
    if band == 0:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 0))
    n_points = min(5, band)
    if n_points < 2:
        src = np.array([m - band - 2, m - band - 1], dtype=np.int64)
        w = np.zeros((band, 2))
        x0, x1 = mu_down[m - band - 2], mu_down[m - band - 1]
        for i in range(band):
            s = (mu_down[m - i - 1] - x1) / (x0 - x1)
            w[i] = [s, 1.0 - s]
        return src, w
    src = np.arange(m - band - n_points, m - band, dtype=np.int64)
    x = mu_down[src]
    w = np.zeros((band, n_points))
    if n_points >= 3:
        deg = min(2, n_points - 1)
        for j in range(n_points):
            e = np.zeros(n_points)
            e[j] = 1.0
            coeffs = np.polyfit(x, e, deg)
            for i in range(band):
                w[i, j] = np.polyval(coeffs, float(mu_down[m - i - 1]))
    else:  # n_points == 2 → linear interpolation branch
        for i in range(band):
            f = (mu_down[m - i - 1] - x[0]) / (x[-1] - x[0])
            w[i] = [1.0 - f, f]
    return src, w


@dataclasses.dataclass(frozen=True)
class SweepStencils:
    """Static per-grid data for the sweeps (host-built numpy)."""

    nb_angles: int
    band_max: int
    bands: Tuple[int, ...]
    poly_w: np.ndarray            # (4, band_max, 6) padded stencil weights
    poly_src: np.ndarray          # (4, 6) source columns
    poly_mask: np.ndarray         # (4, band_max) valid targets
    small_cols: np.ndarray        # downward columns with |µ|<0.01
    taylor_mask: np.ndarray       # of small_cols: |µ|<0.001 → Taylor limit


@functools.lru_cache(maxsize=64)
def stencils_for(grid) -> SweepStencils:
    """Per-grid cached stencils."""
    return build_stencils(grid.mu(), grid.nb_angles)


def build_stencils(mu: np.ndarray, nb_angles: int) -> SweepStencils:
    m = nb_angles
    mu_down = np.asarray(mu[:m], dtype=np.float64)
    bands = _band_variants(m)
    band_max = max(max(bands), 1)
    poly_w = np.zeros((4, band_max, 6))
    poly_src = np.zeros((4, 6), dtype=np.int64)
    poly_mask = np.zeros((4, band_max), dtype=bool)
    for c, b in enumerate(bands):
        src, w = _polyfit_stencil(mu_down, b)
        if b:
            poly_src[c, :len(src)] = src
            poly_w[c, :b, :w.shape[1]] = w
            poly_mask[c, :b] = True
    small = np.array([k for k in range(m - 1) if abs(mu_down[k]) < MU_THRESHOLD],
                     dtype=np.int64)
    taylor = np.array([abs(mu_down[k]) < MU_VERY_SMALL_THRESHOLD for k in small],
                      dtype=bool)
    return SweepStencils(nb_angles=m, band_max=band_max, bands=bands,
                         poly_w=poly_w, poly_src=poly_src, poly_mask=poly_mask,
                         small_cols=small, taylor_mask=taylor)


@dataclasses.dataclass(frozen=True)
class DeviceStencils:
    """The arrays of :class:`SweepStencils` as tensors on one device, the
    weights in one compute dtype (cast from float64), and the band's target
    columns M-1, M-2, ... (``band_cols``).  Each band width's weights and
    source columns are a tensor of their own, as the products read them."""

    nb_angles: int
    band_max: int
    has_small: bool
    poly_w: Tuple[torch.Tensor, ...]    # 4 × (band_max, 6)
    poly_src: Tuple[torch.Tensor, ...]  # 4 × (6,) int64
    poly_mask: torch.Tensor       # (4, band_max) bool
    small_cols: torch.Tensor      # (S,) int64
    taylor_mask: torch.Tensor     # (S,) bool
    band_cols: torch.Tensor       # (band_max,) int64


def stencils_on(stencils: SweepStencils, device, dtype) -> DeviceStencils:
    """``stencils`` copied to ``device``, the weights in ``dtype``."""
    on = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    m = stencils.nb_angles
    return DeviceStencils(
        nb_angles=m, band_max=stencils.band_max,
        has_small=stencils.small_cols.size > 0,
        poly_w=tuple(on(w, dtype) for w in stencils.poly_w),
        poly_src=tuple(on(c) for c in stencils.poly_src), poly_mask=on(stencils.poly_mask),
        small_cols=on(stencils.small_cols), taylor_mask=on(stencils.taylor_mask),
        band_cols=m - 1 - torch.arange(stencils.band_max, device=device))


@functools.lru_cache(maxsize=64)
def device_stencils(grid, device, dtype) -> DeviceStencils:
    """The grid's stencils on ``device`` in ``dtype``, copied there once per
    (grid, device, dtype) and shared by every solve after."""
    return stencils_on(stencils_for(grid), device, dtype)


def band_choice(tau_ref):
    """Index into the four band widths (main_lambertian.py:344-347)."""
    return torch.where(tau_ref <= 0.0625, 0,
                       torch.where(tau_ref <= 1.0, 1,
                                   torch.where(tau_ref < 4.0, 2, 3)))


def region_band_choices(tau, idx_up, idx_down):
    """The band choices (B,) of each column's two regions
    (main_lambertian.py:344-349): above the aerosol layer
    band_choice(τ[idx_up − 1]) (read through :func:`~sos_rt_tpu_torch.grids.
    neighbour_index`, as the JAX package reads it), in and below it
    band_choice(τ[idx_down]).  tau (B, L), idx_* (B,)."""
    at = lambda idx: torch.gather(tau, 1, idx[:, None])[:, 0]
    return (band_choice(at(neighbour_index(idx_up - 1, tau.shape[1]))),
            band_choice(at(idx_down)))


def polyfit_band_variants(i_down, stencils: DeviceStencils):
    """Extrapolated band values for all four static band widths.

    ``i_down`` is (..., M) with any leading (column, layer) axes and
    ``stencils`` on its device in its dtype (:func:`device_stencils`).
    Returns (polys (4, ..., band_max), valids (4, band_max)); the caller
    selects by the per-column band choice (:func:`select_band_choice`)."""
    if not isinstance(stencils, DeviceStencils):
        raise TypeError("polyfit_band_variants takes device stencils "
                        "(ops.sweeps.device_stencils), not host arrays")
    full_precision_matmul()
    polys = [i_down[..., stencils.poly_src[c]] @ stencils.poly_w[c].T for c in range(4)]
    return torch.stack(polys), stencils.poly_mask


def select_band_choice(stacked, choice):
    """stacked[choice] for a choice tensor with values in {0..3} that
    broadcasts against stacked[c]."""
    out = stacked[0]
    for c in range(1, 4):
        out = torch.where(choice == c, stacked[c], out)
    return out


# --------------------------------------------------------------------------
# Affine scans
# --------------------------------------------------------------------------

def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along the layer axis (-2)."""
    shape = list(even.shape)
    shape[-2] += odd.shape[-2]
    out = even.new_empty(shape)
    out[..., 0::2, :] = even
    out[..., 1::2, :] = odd
    return out


def _associative_scan(a, b):
    """The TPU package's odd/even associative-scan recursion over axis -2
    with :func:`_combine`: combine adjacent pairs, scan the pairs
    recursively, combine the odd results with the even elements, then
    interleave — so every partial sum is formed from the same pairs, in
    the same order, as the TPU package forms it."""
    n = a.shape[-2]
    if n < 2:
        return a, b
    ra, rb = _combine((a[..., 0:-1:2, :], b[..., 0:-1:2, :]),
                      (a[..., 1::2, :], b[..., 1::2, :]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[..., :-1, :], ob[..., :-1, :]),
                          (a[..., 2::2, :], b[..., 2::2, :]))
    else:
        ea, eb = _combine((oa, ob), (a[..., 2::2, :], b[..., 2::2, :]))
    ea = torch.cat([a[..., :1, :], ea], dim=-2)
    eb = torch.cat([b[..., :1, :], eb], dim=-2)
    return _interleave(ea, oa), _interleave(eb, ob)


def _affine_scan(a, b, reverse: bool = False, method: str = "associative"):
    """I_t = a_t·I_{t-1} + b_t from I_{-1}=0 over the layer axis (-2) of
    (..., L, M) tensors, or the reversed recurrence.

    method='sequential': L steps of (..., M) work; any other value: the
    associative scan (:func:`_associative_scan`; ``reverse`` flips, scans
    and flips back, as the TPU package's scan does).
    """
    if method == "sequential":
        ys = torch.empty_like(b)
        carry = torch.zeros_like(b[..., 0, :])
        steps = range(b.shape[-2] - 1, -1, -1) if reverse else range(b.shape[-2])
        for t in steps:
            carry = a[..., t, :] * carry + b[..., t, :]
            ys[..., t, :] = carry
        return ys
    if reverse:
        a, b = a.flip(-2), b.flip(-2)
    s = _associative_scan(a, b)[1]
    return s.flip(-2) if reverse else s


def down_sweep_scan(jn_down, tau, mu_down, method: str = "associative"):
    """Downward field (B, L, M) for all µ≤0 columns via one forward affine
    scan (main_lambertian.py:332-387 telescoped); the µ=0 column is garbage
    here and replaced downstream by the polyfit band.

    jn_down (B, L, M), tau (B, L), mu_down (M,)."""
    dtau = torch.diff(tau, dim=-1)[..., None]
    safe_mu = torch.where(mu_down == 0, -1.0, mu_down)
    att = torch.exp(dtau / safe_mu)
    a = torch.cat([torch.ones_like(att[..., :1, :]), att], dim=-2)
    b = torch.cat([torch.zeros_like(att[..., :1, :]),
                   0.5 * dtau * (jn_down[..., :-1, :] * att + jn_down[..., 1:, :])],
                  dim=-2)
    return -_affine_scan(a, b, method=method) / safe_mu


def up_sweep_scan(jn_up, tau, mu_up, boundary, idx_up, idx_down,
                  method: str = "associative"):
    """Raw upward field (µ>0, excluding µ=0) via one reverse affine scan.

    I_t = e^{-Δτ_{t+1}/µ} I_{t+1} + c_t, with c zeroed at the two region
    joins t ∈ {idx_down, idx_up-1} (main_lambertian.py:415-421, 435-441).
    jn_up (B, L, M-1), tau (B, L), mu_up (M-1,), ``boundary`` (B, M-1) the
    surface BC row I(τ_{L-1}, µ), idx_up / idx_down (B,)."""
    L = tau.shape[-1]
    dtau = torch.diff(tau, dim=-1)[..., None]
    att = torch.exp(-dtau / mu_up)
    c = 0.5 * dtau / mu_up * (jn_up[..., :-1, :] + jn_up[..., 1:, :] * att)
    t = torch.arange(L - 1, device=tau.device)
    join = (t == idx_down[..., None]) | (t == idx_up[..., None] - 1)
    c = torch.where(join[..., None], 0.0, c)
    a = torch.cat([att, torch.ones_like(att[..., :1, :])], dim=-2)
    b = torch.cat([c, boundary[..., None, :]], dim=-2)
    return _affine_scan(a, b, reverse=True, method=method)


# --------------------------------------------------------------------------
# Small-µ downward asymptotics (|µ| < MU_THRESHOLD)
# --------------------------------------------------------------------------

def small_mu_window(tau, idx_up, idx_down, mu_small):
    """Loop invariants of the windowed/Taylor small-µ values, per column.

    The window of layer t starts at k0 = max(region start, first layer
    with τ ≥ τ_t − 5|µ|), the region starts being 0, idx_up and
    idx_down+1 (main_lambertian.py:336/355/374).  tau (B, L), idx_* (B,),
    mu_small (S,).  Returns (k0 (B, L, S), att_k0 = e^{(τ_t−τ_k0)/µ}
    (B, L, S), prev_t (L,), taylor_den (B, L, 1), taylor_on (B, L, 1)).
    """
    B, L = tau.shape
    t_idx = torch.arange(L, device=tau.device)
    iu, idn = idx_up[:, None], idx_down[:, None]
    region_start = torch.where(t_idx < iu, 0, torch.where(t_idx <= idn, iu, idn + 1))
    cutoff = tau[:, :, None] - 5.0 * torch.abs(mu_small)
    first = torch.searchsorted(tau.contiguous(), cutoff.reshape(B, -1).contiguous(),
                               side="left").reshape(cutoff.shape)
    k0 = torch.minimum(torch.maximum(first, region_start[:, :, None]),
                       t_idx[None, :, None])
    tau_k0 = torch.gather(tau[:, :, None].expand(k0.shape), 1, k0)
    att_k0 = torch.exp(torch.clamp((tau[:, :, None] - tau_k0) / mu_small,
                                   EXP_CLAMP, 0.0))
    prev_t = torch.clamp(t_idx - 1, 0, L - 1)
    taylor_den = torch.where(t_idx[None, :, None] > 0,
                             (tau - tau[:, prev_t])[:, :, None], 1.0)
    taylor_on = (t_idx[None, :] > region_start)[:, :, None]
    return k0, att_k0, prev_t, taylor_den, taylor_on


def small_mu_values(jn_small, raw_small, mu_small, taylor_mask, window):
    """Windowed (|µ| ≥ 0.001) or Taylor (|µ| < 0.001) downward radiance of
    the small-µ columns from the standard scan's values ``raw_small`` and
    the sources ``jn_small`` (B, L, S), with ``window`` from
    :func:`small_mu_window`.

    KEY IDENTITY: the windowed trapezoid is a prefix difference of the full
    telescoped integral, I_window(t) = raw(t) − e^{(τ_t−τ_k0)/µ}·raw(k0);
    the Taylor limit is I ≈ −J + µ dJ/dτ (In_limit.py:79-93)."""
    k0, att_k0, prev_t, taylor_den, taylor_on = window
    windowed = raw_small - att_k0 * torch.gather(raw_small, 1, k0)
    dj = torch.where(taylor_on, (jn_small - jn_small[:, prev_t]) / taylor_den, 0.0)
    taylor = -jn_small + mu_small * dj
    return torch.where(taylor_mask, taylor, windowed)


def down_small_mu(jn_small, raw_small, tau, mu_small, taylor_mask,
                  idx_up, idx_down):
    """Windowed/Taylor downward radiance for the static small-µ columns
    (SOS_Aer_In_limit.py:70-109 with the drivers' region slice starts).
    jn_small / raw_small (B, L, S), tau (B, L), mu_small (S,), taylor_mask
    (S,) bool, idx_* (B,)."""
    window = small_mu_window(tau, idx_up, idx_down, mu_small)
    return small_mu_values(jn_small, raw_small, mu_small, taylor_mask, window)


# --------------------------------------------------------------------------
# The µ→0⁻ down-fix
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DownFix:
    """The µ→0⁻ fixes of one solve's downward fields, written by
    :meth:`apply`: the small-µ columns' windowed value or Taylor limit
    (SOS_Aer_In_limit.py:70-109), the zeroed µ=0⁻ column, and the polyfit
    band of each row's region (SOS_Aer_In_limit.py:113-141).  Its masks are
    loop invariants, built once by :meth:`build`."""

    stencils: DeviceStencils
    choice: Any                   # (B, L, 1) band choice of each row
    band_valid: Any               # (B, L, band_max) the choice's targets
    mu_small: Any = None          # (S,), on grids with small-µ columns
    window: Any = None            # small_mu_window's tuple, likewise

    @classmethod
    def build(cls, stencils: DeviceStencils, tau, idx_up, idx_down, mu,
              choice=None) -> "DownFix":
        """The fix of (B,)-batched columns: ``tau`` (B, L), ``idx_*`` (B,),
        ``mu`` the (2M,) µ row, all in the compute dtype of ``stencils``.
        The rows above the aerosol layer take its first region band choice
        (:func:`region_band_choices`), the others its second; a (B,)
        ``choice`` holds on every row instead (the single-layer slab, which
        has no regions)."""
        B, L = tau.shape
        if choice is None:
            choice_a, choice_bc = region_band_choices(tau, idx_up, idx_down)
            above = torch.arange(L, device=tau.device)[None, :] < idx_up[:, None]
            choice = torch.where(above, choice_a[:, None], choice_bc[:, None])
        else:
            choice = choice[:, None].expand(B, L)
        mu_small = window = None
        if stencils.has_small:
            mu_small = mu[stencils.small_cols]
            window = small_mu_window(tau, idx_up, idx_down, mu_small)
        return cls(stencils, choice[..., None], stencils.poly_mask[choice], mu_small,
                   window)

    def rows(self, own: slice) -> "DownFix":
        """The fix of the layers ``own`` alone (one shard of the layer
        axis).  The small-µ window reads layers outside any one shard, so a
        grid with small-µ columns has no such fix."""
        if self.window is not None:
            raise ValueError("the small-µ window reads layers outside the rows")
        return dataclasses.replace(self, choice=self.choice[:, own],
                                   band_valid=self.band_valid[:, own])

    def apply(self, raw, jn):
        """Write the fixes into ``raw`` (B, L, M), the scan's downward field,
        in place and return it; ``jn`` (B, L, ≥ M) is the order's source,
        whose first M columns are the downward half."""
        st = self.stencils
        if st.has_small:
            c = st.small_cols
            raw[:, :, c] = small_mu_values(jn[:, :, c], raw[:, :, c], self.mu_small,
                                           st.taylor_mask, self.window)
        raw[:, :, st.nb_angles - 1] = 0.0
        polys, _ = polyfit_band_variants(raw, st)       # (4, B, L, band_max)
        poly = select_band_choice(polys, self.choice)
        raw[:, :, st.band_cols] = torch.where(self.band_valid, poly,
                                              raw[:, :, st.band_cols])
        return raw


# --------------------------------------------------------------------------
# µ→0⁺ smoothing
# --------------------------------------------------------------------------

def smooth_up_rows(i_up_rows, mu, nb_angles):
    """Vectorized µ→0⁺ smoothing walk (main_lambertian.py:405-411).

    i_up_rows: (..., 2M) full rows (only columns ≥ M are touched); mu (2M,).
    For each row: find the first m ≥ M+1 whose second difference is
    ≤ 1e-4 (m = 2M−3 when there is none), set idx = m+1, and linearly
    blend columns (M, idx) between I[M] and I[idx] with weight µ/µ_idx.
    The row's values at idx are picked by one-hot reductions over the
    angle axis, as in the TPU package.
    """
    m = nb_angles
    up = i_up_rows
    m2 = up.shape[-1]
    d = torch.abs((up[..., m + 1:m2 - 2] - up[..., m + 2:m2 - 1])
                  - (up[..., m + 2:m2 - 1] - up[..., m + 3:m2]))  # walk at m+1..2M-3
    ok = d <= SMOOTH_TOL
    first = torch.argmax(ok.to(torch.uint8), dim=-1)            # first stop
    stop = torch.where(ok.any(dim=-1), first + m + 1, m2 - 3)
    idx = (stop + 1)[..., None]                                 # blend endpoint
    cols = torch.arange(m2, device=up.device)
    onehot = (cols == idx).to(up.dtype)
    i_val = torch.sum(up * onehot, dim=-1, keepdim=True)
    mu_idx = torch.sum(mu * onehot, dim=-1, keepdim=True)
    weight = mu / mu_idx
    blended = (1.0 - weight) * up[..., m:m + 1] + weight * i_val
    do = (cols >= m + 1) & (cols < idx)
    return torch.where(do, blended, up)
