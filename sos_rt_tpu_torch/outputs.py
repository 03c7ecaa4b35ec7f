"""Derived physical outputs: fluxes, diffusivity, heating rate.

Counterpart of ``sos_rt_tpu/outputs.py``: reductions over the radiance
field (no plotting side effects).

The reference uses THREE different direct-beam scalings in its flux
outputs (a documented quirk):
- ``graphe_flux`` / ``graphe_flux_up_down``: beam term F0·e^{-τ/µ0}
  (graphe.py:41, 157-158);
- ``graphe_heating_rate`` and the critical-albedo driver:
  (F0/4π)·e^{-τ/µ0} (graphe.py:77-78, critical_albedo.py:380-381);
- the conservation-consistent scale in this field convention is
  (µ0F0/2π)·e^{-τ/µ0} = ½e^{-τ/µ0} (equal to F0/4π only at µ0=0.5) —
  exposed as ``beam="physical"``.

Fields may carry leading batch axes: i_field (..., L, 2M) with tau
(..., L), and the per-column scalars (mu0, grd_alb, idx_up, idx_down) of
the batch shape (...) or scalars.  The products are float64/float32
``torch.einsum`` at full precision (no TF32).
"""
from __future__ import annotations

import math

import torch

from sos_rt_tpu_torch.config import full_precision_matmul

RHO_AIR = 1.225   # kg m^-3 (graphe.py:71)
C_P = 1004.0      # J kg^-1 K^-1 (graphe.py:72)

_BEAM_SCALES = ("graphe", "heating", "physical")


def _beam_scale(beam, f0, mu0):
    if beam == "graphe":
        return f0
    if beam == "heating":
        return f0 / (4.0 * math.pi)
    if beam == "physical":
        return mu0 * f0 / (2.0 * math.pi)
    raise ValueError(f"beam must be one of {_BEAM_SCALES}")


def _per_column(x):
    """A per-column scalar tensor (...) as (..., 1), to broadcast over the
    layer axis; a Python number stays one."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


def diffusivity(i_field, mu, w_mu):
    """Mean diffusivity µ̄(z) = −∫Iµdµ / ∫Idµ (graphe.py:6-29)."""
    full_precision_matmul()
    num = torch.einsum("...m,m,m->...", i_field, mu, w_mu)
    den = torch.einsum("...m,m->...", i_field, w_mu)
    return -num / den


def flux_up_down(i_field, mu, w_mu, tau, mu0, grd_alb, nb_angles,
                 beam: str = "graphe"):
    """(flux_up, flux_down) profiles (graphe.py:152-181 with beam='graphe';
    graphe.py:68-78 / critical_albedo.py:380-381 with beam='heating').

    i_field: (..., L, 2M); returns two (..., L) tensors.
    """
    full_precision_matmul()
    m = nb_angles
    mu0, grd_alb = _per_column(mu0), _per_column(grd_alb)
    f0 = math.pi / mu0
    scale = _beam_scale(beam, f0, mu0)
    tau_star = tau[..., -1:]
    down_diff = torch.einsum("...tm,m,m->...t", i_field[..., :m], mu[:m], w_mu[:m])
    up_diff = torch.einsum("...tm,m,m->...t", i_field[..., m:], mu[m:], w_mu[m:])
    flux_down = down_diff - scale * torch.exp(-tau / mu0)
    flux_up = up_diff + grd_alb * scale * torch.exp(-(2 * tau_star - tau) / mu0)
    return flux_up, flux_down


def net_flux(i_field, mu, w_mu, tau, mu0, grd_alb, beam: str = "graphe"):
    """Net flux profile (graphe.py:37-60 convention with beam='graphe')."""
    full_precision_matmul()
    mu0, grd_alb = _per_column(mu0), _per_column(grd_alb)
    f0 = math.pi / mu0
    scale = _beam_scale(beam, f0, mu0)
    tau_star = tau[..., -1:]
    diff = torch.einsum("...tm,m,m->...t", i_field, mu, w_mu)
    return (diff - scale * torch.exp(-tau / mu0)
            + grd_alb * scale * torch.exp(-(2 * tau_star - tau) / mu0))


def heating_rate(i_field, mu, w_mu, tau, z_profile, mu0, grd_alb, nb_angles,
                 idx_up, idx_down, erase_pics: bool = True):
    """Heating-rate profile −(1/ρc_p)·dF/dz (graphe.py:68-112).

    Reproduces the boundary-spike erasure at the aerosol-layer edges
    (graphe.py:88-91) behind ``erase_pics``: layers idx_up−1 and idx_down
    take the value of the layer above.
    """
    fu, fd = flux_up_down(i_field, mu, w_mu, tau, mu0, grd_alb, nb_angles,
                          beam="heating")
    flux = fu + fd
    dz = z_profile[..., 1:] - z_profile[..., :-1]
    hr_body = -(flux[..., 1:] - flux[..., :-1]) / (RHO_AIR * C_P * dz)
    hr = torch.cat([hr_body, hr_body[..., -1:]], dim=-1)
    if erase_pics:
        t = torch.arange(hr.shape[-1], device=hr.device)
        iu, idn = _per_column(idx_up), _per_column(idx_down)
        prev = torch.where((t == iu - 1) | (t == idn), t - 1, t)
        hr = torch.gather(hr, -1, prev.expand(hr.shape))
    return hr


def toa_net_flux(i_field, mu, w_mu, tau, mu0, grd_alb, nb_angles):
    """−flux_down(0) − flux_up(0), as the critical-albedo driver defines
    the TOA net flux (critical_albedo.py:377-382)."""
    fu, fd = flux_up_down(i_field, mu, w_mu, tau, mu0, grd_alb, nb_angles,
                          beam="heating")
    return -fd[..., 0] - fu[..., 0]


def per_order_diffusivity(i_orders, mu, w_mu):
    """µ̄(z) per scattering order (graphe.py:118-149).

    i_orders: (N, L, 2M) stacked per-order fields.
    """
    return diffusivity(i_orders, mu, w_mu)
