"""Shared scaffolding for phase-function table construction (host, NumPy).

Counterpart of ``sos_rt_tpu/models/phase_common.py`` (reference:
SOS_Aer_phase_func.py:79-199):

1. P0(µ) = azimuth average of the scattering kernel K(µ_diff) between the
   solar direction (µ0, φ0=0) and (µ, φ) over φ ∈ [0, π] (25 points),
   normalized so ∫ P0 dµ = 2.
2. P(µ, µ') = the same average between two stream directions, symmetric
   raw matrix, then each column normalized so ∫ P(:,n) dµ = 4.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from sos_rt_tpu_torch.config import trapz_weights

NB_PHI = 25  # reference value (SOS_Aer_phase_func.py:81 etc.)


def azimuth_p0(kernel: Callable[[np.ndarray], np.ndarray], mu: np.ndarray,
               mu0: float, nb_phi: int = NB_PHI) -> np.ndarray:
    """First-order table P0(µ, µ0), normalized to ∫P0 dµ = 2."""
    mu = np.asarray(mu, dtype=np.float64)
    phi = np.linspace(0.0, np.pi, nb_phi)
    cphi = np.cos(phi)
    s0 = np.sqrt(max(1.0 - mu0 * mu0, 0.0))
    sm = np.sqrt(np.clip(1.0 - mu * mu, 0.0, None))
    md_pos = -(mu[:, None] * mu0 + s0 * sm[:, None] * cphi[None, :])
    md_neg = -(mu[:, None] * mu0 - s0 * sm[:, None] * cphi[None, :])
    vals = kernel(md_pos) + kernel(md_neg)
    p0 = np.trapezoid(vals, phi, axis=1) / (4.0 * np.pi)
    return p0 / np.trapezoid(p0, mu) * 2.0


def azimuth_p_matrix(kernel: Callable[[np.ndarray], np.ndarray],
                     mu: np.ndarray, nb_phi: int = NB_PHI,
                     col_chunk: int = 64) -> np.ndarray:
    """n-th-order table P(µ, µ'), each column normalized to ∫P(:,n) dµ = 4.

    Column-chunked to bound host memory at ~n_mu × chunk × nb_phi doubles.
    """
    mu = np.asarray(mu, dtype=np.float64)
    n_mu = mu.shape[0]
    phi = np.linspace(0.0, np.pi, nb_phi)
    cphi = np.cos(phi)
    sm = np.sqrt(np.clip(1.0 - mu * mu, 0.0, None))

    p = np.empty((n_mu, n_mu), dtype=np.float64)
    for c0 in range(0, n_mu, col_chunk):
        c1 = min(c0 + col_chunk, n_mu)
        cc = mu[:, None, None] * mu[None, c0:c1, None]
        ss = sm[:, None, None] * sm[None, c0:c1, None]
        md_pos = -(cc + ss * cphi[None, None, :])
        md_neg = -(cc - ss * cphi[None, None, :])
        vals = kernel(md_pos) + kernel(md_neg)
        p[:, c0:c1] = np.trapezoid(vals, phi, axis=2) / (2.0 * np.pi)
    # symmetric before the column normalization, as the reference's
    # m >= n fill + mirror
    p = 0.5 * (p + p.T)
    w = trapz_weights(mu)
    norm = p.T @ w
    return 4.0 * p / norm[None, :]


def build_tables(kernel, mu, mu0, nb_phi: int = NB_PHI):
    """(P0, P) pair for a scattering kernel K(µ_diff)."""
    return azimuth_p0(kernel, mu, mu0, nb_phi), azimuth_p_matrix(kernel, mu, nb_phi)
