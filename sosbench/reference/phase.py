"""Phase-function tables on the µ grid, built on the host in NumPy
(SOS_Aer_phase_func.py:68-236).

P0(µ) is the azimuth average of the scattering kernel K(µ_diff) between
the solar direction (µ0, φ0 = 0) and (µ, φ) over φ ∈ [0, π] (25 points),
normalised so ∫P0 dµ = 2; P(µ, µ') the same average between two stream
directions, symmetrised, each column normalised so ∫P(:, n) dµ = 4.

The kernels live one to a file, ``reference/models/<kind>.py`` under the
benchmark's directory, found by the kind that a configuration's ``atm`` or
``aer`` = [kind, params] names (``spec.phase_model``).  A model file
exposes ``kernel(params) -> K``, where K maps an array of µ_diff to the
kernel's values, and imports nothing of the program.  A configuration
brings a new model by adding its file: nothing here changes.
"""
from __future__ import annotations

import numpy as np

from sosbench import spec
from sosbench.reference.grid import trapz_weights

NB_PHI = 25


def p0_table(k, mu: np.ndarray, mu0: float) -> np.ndarray:
    phi = np.linspace(0.0, np.pi, NB_PHI)
    cphi = np.cos(phi)
    s0 = np.sqrt(max(1.0 - mu0 * mu0, 0.0))
    sm = np.sqrt(np.clip(1.0 - mu * mu, 0.0, None))
    md_pos = -(mu[:, None] * mu0 + s0 * sm[:, None] * cphi[None, :])
    md_neg = -(mu[:, None] * mu0 - s0 * sm[:, None] * cphi[None, :])
    p0 = np.trapezoid(k(md_pos) + k(md_neg), phi, axis=1) / (4.0 * np.pi)
    return p0 / np.trapezoid(p0, mu) * 2.0


def p_matrix(k, mu: np.ndarray, col_chunk: int = 64) -> np.ndarray:
    n_mu = mu.shape[0]
    phi = np.linspace(0.0, np.pi, NB_PHI)
    cphi = np.cos(phi)
    sm = np.sqrt(np.clip(1.0 - mu * mu, 0.0, None))
    p = np.empty((n_mu, n_mu), dtype=np.float64)
    for c0 in range(0, n_mu, col_chunk):
        c1 = min(c0 + col_chunk, n_mu)
        cc = mu[:, None, None] * mu[None, c0:c1, None]
        ss = sm[:, None, None] * sm[None, c0:c1, None]
        vals = k(-(cc + ss * cphi)) + k(-(cc - ss * cphi))
        p[:, c0:c1] = np.trapezoid(vals, phi, axis=2) / (2.0 * np.pi)
    p = 0.5 * (p + p.T)
    return 4.0 * p / (p.T @ trapz_weights(mu))[None, :]


def tables(model, mu: np.ndarray, mu0_values, base: str = spec.HERE) -> tuple:
    """(P0 (n, 2M) for each µ0 of ``mu0_values``, P (2M, 2M)) of the phase
    model ``model`` = [kind, params], its file found under ``base``."""
    kind, params = model
    k = spec.phase_model(kind, base).kernel(params)
    return (np.stack([p0_table(k, mu, float(m0)) for m0 in np.atleast_1d(mu0_values)]),
            p_matrix(k, mu))
