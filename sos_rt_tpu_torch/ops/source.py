"""Source-function operator (counterpart of ``sos_rt_tpu/ops/source.py``).

The reference's per-layer trapezoid (SOS_Aer_main_lambertian.py:317-325)

    Jn[t,m] = (ω/4) Σ_k w_k P[m, 2M-1-k] In_1[t,k]

is a product with the trapz-weighted flipped phase operator
(:func:`source_operator`); :func:`source_function` blends the two species'
Jₙ inside the aerosol layer.  The engines compute the same blend inline.
"""
from __future__ import annotations

import torch


def source_operator(p, w_mu):
    """A[k, m] = w_k · P[m, 2M-1-k]  so that  Jn = (ω/4)·(In_1 @ A)."""
    return w_mu[:, None] * torch.flip(p, dims=(1,)).T


def source_function(in_prev, a_atm, a_aer, alb_atm, alb_aer, w_atm, w_aer,
                    idx_up, idx_down):
    """Jₙ over all layers; blended inside the aerosol layer.

    in_prev: (L, 2M); a_*: (2M, 2M) operators from :func:`source_operator`.
    """
    jn_atm = (alb_atm / 4.0) * (in_prev @ a_atm)
    jn_aer = (alb_aer / 4.0) * (in_prev @ a_aer)
    t = torch.arange(in_prev.shape[0], device=in_prev.device)
    in_layer = ((t >= idx_up) & (t <= idx_down))[:, None]
    return torch.where(in_layer, w_atm * jn_atm + w_aer * jn_aer, jn_atm)
