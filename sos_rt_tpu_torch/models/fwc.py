"""FWC ("Full Width Cloud") tabulated phase function.

Counterpart of ``sos_rt_tpu/models/fwc.py``.  The measured table (1001
points, µ ∈ [−1, 1] step 0.002) ships as ``data/fwc.npz``, the data the
reference embeds in SOS_Aer_fwc_data.py; the kernel interpolates it
linearly (SOS_Aer_phase_func.py:202-236).
"""
from __future__ import annotations

import functools
import os

import numpy as np

from sos_rt_tpu_torch.models.phase_common import build_tables

_DATA = os.path.join(os.path.dirname(__file__), "data", "fwc.npz")


@functools.lru_cache(maxsize=1)
def fwc_table():
    with np.load(_DATA) as z:
        return z["mu"].copy(), z["phase"].copy()


def fwc_kernel(md: np.ndarray) -> np.ndarray:
    """Linear interpolation of the FWC table, clipped to [-1, 1]."""
    mu_tab, p_tab = fwc_table()
    return np.interp(np.clip(md, -1.0, 1.0), mu_tab, p_tab)


def fwc(mu: np.ndarray, mu0: float):
    return build_tables(fwc_kernel, mu, mu0)
