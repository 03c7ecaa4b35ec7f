"""The angular grid, its trapezoid weights and the optical-depth profile
(SOS_Aer_main_lambertian.py:57-61, SOS_Aer_tau_profile.py:5-53)."""
from __future__ import annotations

import numpy as np
import torch

MU_THRESHOLD = 0.01              # switch to asymptotic small-µ handling
MU_EXTREME_THRESHOLD = 1e-8      # extremely small µ → pure Taylor limit
MU_VERY_SMALL_THRESHOLD = 0.001  # very small µ → Taylor limit
MU0_RESONANCE_TOL = 1e-4         # |µ ± µ0| resonance (main_lambertian.py:111)


def mu_grid(nb_angles: int) -> np.ndarray:
    """µ = concat(linspace(-1, 0, M), linspace(0, 1, M)): 2M points with
    µ = 0 at indices M-1 and M."""
    return np.concatenate([np.linspace(-1.0, 0.0, nb_angles),
                           np.linspace(0.0, 1.0, nb_angles)])


def trapz_weights(x: np.ndarray) -> np.ndarray:
    """w such that Σ_k w_k f_k == np.trapezoid(f, x)."""
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2.0
    w[1:] += dx / 2.0
    return w


def tau_profile(tau_star_atm, tau_star_aer, z0, z_up, z_down, nb_layers: int):
    """Cumulative optical depth (B, L), top → bottom, and the aerosol
    layer's bounding indices (B,): a linear molecular τ plus a linear
    aerosol ramp inside [idx_up, idx_down] and τ*_aer below.  The altitude
    grid z0·(1 − i/(L−1)) is evaluated in float64; ties take the first
    index."""
    f64 = lambda x: torch.as_tensor(x).to(torch.float64)
    i64 = torch.arange(nb_layers, dtype=torch.float64, device=f64(z0).device)
    z = f64(z0)[..., None] * (1.0 - i64 / (nb_layers - 1))
    idx_up = torch.argmin(torch.abs(z - f64(z_up)[..., None]), dim=-1)
    idx_down = torch.argmin(torch.abs(z - f64(z_down)[..., None]), dim=-1)
    tau_star_atm = torch.as_tensor(tau_star_atm)
    tau_star_aer = torch.as_tensor(tau_star_aer)
    i = torch.arange(nb_layers, device=tau_star_atm.device)
    iu, idn = idx_up[..., None], idx_down[..., None]
    tau_mol = i * (tau_star_atm[..., None] / (nb_layers - 1))
    dtau_aer = tau_star_aer[..., None] / (idx_down + 1 - idx_up)[..., None]
    aer = torch.where(
        i < iu, torch.zeros_like(dtau_aer),
        torch.where(i <= idn, (i + 1 - iu) * dtau_aer, tau_star_aer[..., None]))
    return tau_mol + aer, idx_up, idx_down


def neighbour_index(idx, nb_layers: int):
    """The layer read at ``idx`` of an (..., L) profile: −1 wraps to L − 1,
    then L clamps to L − 1 (an aerosol layer at the top or bottom edge)."""
    idx = torch.where(idx < 0, idx + nb_layers, idx)
    return torch.clamp(idx, 0, nb_layers - 1)
