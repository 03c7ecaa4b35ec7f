"""Mie-based phase functions: monodisperse and log-normal polydisperse.

Counterpart of ``sos_rt_tpu/models/mie_tables.py`` (host, NumPy float64).

Monodisperse (``mie``): kernel = unpolarized Mie intensity at size
parameter x = 2πr/λ; the P-matrix kernel evaluates each µ_diff rounded to
1e-6 once (the reference's deduplication, so the same evaluation points),
the P0 kernel every µ_diff exactly.

Log-normal (``log_normal_mie``): 100-point radius grid 0.01–10 µm,
log-normal n(r) without its normalization constant (the tables are
renormalized anyway), weights n(r)·Qsca(r), intensity over 6001 scattering
angles.  The radius integral commutes with the linear interpolation in
µ_diff, so the table is integrated over radius once into one 6001-point
weighted kernel table and the (µ, µ', φ) samples interpolate in it.
"""
from __future__ import annotations

import numpy as np

from sos_rt_tpu_torch.models import miecore
from sos_rt_tpu_torch.models.phase_common import NB_PHI, azimuth_p0, azimuth_p_matrix

N_RADII = 100
RADIUS_RANGE = (0.01, 10.0)  # µm
N_DIFF_ANGLES = 6001


def mie(mu: np.ndarray, mu0: float, indx: complex, r: float, lambda0: float):
    """Monodisperse Mie tables; r and λ in the same unit."""
    x = 2.0 * np.pi * r / lambda0

    def kernel_exact(md):
        return miecore.i_unpolarized(indx, x, np.clip(md, -1.0, 1.0)).reshape(md.shape)

    def kernel_dedup(md):
        md_r = np.round(np.clip(md, -1.0, 1.0), 6)
        uniq, inv = np.unique(md_r, return_inverse=True)
        vals = miecore.i_unpolarized(indx, x, uniq)
        return vals[inv].reshape(md.shape)

    p0 = azimuth_p0(kernel_exact, mu, mu0)
    p = azimuth_p_matrix(kernel_dedup, mu)
    return p0, p


def lognormal_weighted_kernel_table(indx: complex, wl: float, r_m: float,
                                    sig: float):
    """Radius-integrated intensity table over the 6001-point µ_diff grid."""
    radii = np.linspace(*RADIUS_RANGE, N_RADII)
    # log-normal size distribution, constant prefactor omitted
    n_r = (1.0 / radii) * np.exp(
        -((np.log(radii) - np.log(r_m)) ** 2) / (2.0 * np.log(sig) ** 2)
    )
    x_list = 2.0 * np.pi * radii / wl
    _, qsca, _, _ = miecore.efficiencies(indx, x_list)
    coef_int = n_r * qsca
    md_grid = np.linspace(-1.0, 1.0, N_DIFF_ANGLES)
    p_list = np.stack([miecore.i_unpolarized(indx, x, md_grid) for x in x_list])
    wtab = np.trapezoid(coef_int[:, None] * p_list, radii, axis=0)
    return md_grid, wtab


def log_normal_mie(mu: np.ndarray, mu0: float, wl: float, indx: complex,
                   n0: float, r_m: float, sig: float):
    """Polydisperse (log-normal) Mie tables — 'eva' / 'wildfire' aerosols.

    ``n0`` (number density) does not affect the normalized tables (the
    prefactor is omitted); accepted for API parity.
    """
    md_grid, wtab = lognormal_weighted_kernel_table(indx, wl, r_m, sig)

    def kernel(md):
        return np.interp(np.clip(md, -1.0, 1.0), md_grid, wtab)

    p0 = azimuth_p0(kernel, mu, mu0, NB_PHI)
    p = azimuth_p_matrix(kernel, mu, NB_PHI)
    return p0, p
