"""Static sweep stencils (the host-side part of ``sos_rt_tpu/ops/sweeps.py``).

- the µ→0⁻ polyfit band (SOS_Aer_In_limit.py:113-141) has four possible
  static widths (main_lambertian.py:344-347); its np.polyfit stencils are
  precomputed per width and selected per column by τ thresholds;
- the small-µ column set (|µ| < 0.01) and its Taylor mask;
- :func:`polyfit_band_variants` / :func:`select_band_choice`, the band
  extrapolation the fused engine applies between its two sweep kernels.

The scan-based sweeps of the reference engine are a later slice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from sos_rt_tpu_torch.config import (MU_THRESHOLD, MU_VERY_SMALL_THRESHOLD,
                                     full_precision_matmul)

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


def band_choice(tau_ref):
    """Index into the four band widths (main_lambertian.py:344-347)."""
    return torch.where(tau_ref <= 0.0625, 0,
                       torch.where(tau_ref <= 1.0, 1,
                                   torch.where(tau_ref < 4.0, 2, 3)))


def polyfit_band_variants(i_down, stencils: SweepStencils):
    """Extrapolated band values for all four static band widths.

    ``i_down`` is (..., M) with any leading (column, layer) axes.  Returns
    (polys (4, ..., band_max), valids (4, band_max)); the caller selects
    by the per-column band choice (:func:`select_band_choice`)."""
    full_precision_matmul()
    dev = i_down.device
    polys = []
    for c in range(4):
        src = torch.as_tensor(stencils.poly_src[c], device=dev)
        w = torch.as_tensor(stencils.poly_w[c], dtype=i_down.dtype, device=dev)
        polys.append(i_down[..., src] @ w.T)
    return torch.stack(polys), torch.as_tensor(stencils.poly_mask, device=dev)


def select_band_choice(stacked, choice):
    """stacked[choice] for a choice tensor with values in {0..3} that
    broadcasts against stacked[c]."""
    out = stacked[0]
    for c in range(1, 4):
        out = torch.where(choice == c, stacked[c], out)
    return out
