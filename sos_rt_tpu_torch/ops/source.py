"""Source-function operator (counterpart of ``sos_rt_tpu/ops/source.py``).

The reference's per-layer trapezoid (SOS_Aer_main_lambertian.py:317-325)

    Jn[t,m] = (ω/4) Σ_k w_k P[m, 2M-1-k] In_1[t,k]

is a product with the trapz-weighted flipped phase operator.
"""
from __future__ import annotations

import torch


def source_operator(p, w_mu):
    """A[k, m] = w_k · P[m, 2M-1-k]  so that  Jn = (ω/4)·(In_1 @ A)."""
    return w_mu[:, None] * torch.flip(p, dims=(1,)).T
