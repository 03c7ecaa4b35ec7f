"""Analytic phase functions: isotropic, Rayleigh, Henyey–Greenstein.

Counterpart of ``sos_rt_tpu/models/analytic.py`` (reference:
SOS_Aer_phase_func.py:68-199).
"""
from __future__ import annotations

import numpy as np

from sos_rt_tpu_torch.models.phase_common import build_tables


def isotropic(mu: np.ndarray, mu0: float):
    """P0 ≡ 1, P ≡ 2 (SOS_Aer_phase_func.py:68-76)."""
    n_mu = len(mu)
    return np.ones(n_mu), 2.0 * np.ones((n_mu, n_mu))


def rayleigh(mu: np.ndarray, mu0: float):
    def kernel(md):
        return 0.75 * (1.0 + md * md)

    return build_tables(kernel, mu, mu0)


def henyey_greenstein(mu: np.ndarray, mu0: float, g: float):
    def kernel(md):
        return (1.0 - g * g) / (1.0 + g * g - 2.0 * g * md) ** 1.5

    return build_tables(kernel, mu, mu0)
