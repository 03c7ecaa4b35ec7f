"""Vertical grid: cumulative optical-depth profile.

Counterpart of ``sos_rt_tpu/grids.py`` (reference:
SOS_Aer_tau_profile.py:5-53).  The torch functions take scalars or
(B,)-shaped tensors and broadcast over a trailing layer axis.
"""
from __future__ import annotations

import numpy as np
import torch


def layer_indices(z0, z_up, z_down, nb_layers: int):
    """Aerosol-layer bounding indices on the altitude grid.

    z_profile = z0·(1 − i/(L−1)); idx = argmin|z − z_bound|, ties taking
    the first index (SOS_Aer_tau_profile.py:16-18).  Returns (idx_up,
    idx_down) as int64 tensors of the inputs' batch shape.  The altitude
    grid is evaluated in float64 whatever the inputs' dtype.
    """
    f64 = lambda x: torch.as_tensor(x).to(torch.float64)
    z0 = f64(z0)
    i = torch.arange(nb_layers, dtype=torch.float64, device=z0.device)
    z_profile = z0[..., None] * (1.0 - i / (nb_layers - 1))
    idx_up = torch.argmin(torch.abs(z_profile - f64(z_up)[..., None]), dim=-1)
    idx_down = torch.argmin(torch.abs(z_profile - f64(z_down)[..., None]), dim=-1)
    return idx_up, idx_down


def tau_profile(tau_star_atm, tau_star_aer, z0, z_up, z_down, nb_layers: int):
    """Cumulative optical depth per layer, top → bottom.

    Linear molecular τ over the column plus a linear aerosol ramp inside
    [idx_up, idx_down] and a constant ``tau_star_aer`` below
    (SOS_Aer_tau_profile.py:21-27).  Returns (tau (..., L), idx_up,
    idx_down).  An aerosol layer may reach the top (idx_up = 0) or the
    bottom layer (idx_down = L − 1, whenever z_down lies within half a
    layer of the ground): the neighbour layers idx_up − 1 and idx_down + 1
    are then read through :func:`neighbour_index`.
    """
    tau_star_atm = torch.as_tensor(tau_star_atm)
    tau_star_aer = torch.as_tensor(tau_star_aer)
    idx_up, idx_down = layer_indices(z0, z_up, z_down, nb_layers)
    i = torch.arange(nb_layers, device=tau_star_atm.device)
    iu, idn = idx_up[..., None], idx_down[..., None]
    tau_mol = i * (tau_star_atm[..., None] / (nb_layers - 1))
    dtau_aer = tau_star_aer[..., None] / (idx_down + 1 - idx_up)[..., None]
    aer = torch.where(
        i < iu, torch.zeros_like(dtau_aer),
        torch.where(i <= idn, (i + 1 - iu) * dtau_aer, tau_star_aer[..., None]))
    return tau_mol + aer, idx_up, idx_down


def neighbour_index(idx, nb_layers: int):
    """The layer read at index ``idx`` of an (..., L) profile as the JAX
    package's reference engine reads ``tau[idx]``: −1 wraps to L − 1, then
    L clamps to L − 1.  The neighbour layers idx_up − 1 and idx_down + 1 of
    an aerosol layer in the top or bottom layer both land on L − 1."""
    idx = torch.where(idx < 0, idx + nb_layers, idx)
    return torch.clamp(idx, 0, nb_layers - 1)


def tau_profile_np(tau_star_atm, tau_star_aer, z0, z_up, z_down, nb_layers: int):
    """NumPy twin of :func:`tau_profile` for one column (host use)."""
    z_profile = np.linspace(z0, 0.0, nb_layers)
    idx_up = int(np.argmin(np.abs(z_profile - z_up)))
    idx_down = int(np.argmin(np.abs(z_profile - z_down)))
    tau = np.arange(nb_layers) * tau_star_atm / (nb_layers - 1)
    dtau_aer = tau_star_aer / (idx_down + 1 - idx_up)
    for i in range(idx_up, nb_layers):
        if i <= idx_down:
            tau[i] += (i + 1 - idx_up) * dtau_aer
        else:
            tau[i] += tau_star_aer
    return tau, idx_up, idx_down
