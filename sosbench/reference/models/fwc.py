"""The FWC cloud's measured phase function (SOS_Aer_fwc_data.py): the
table ``reference/data/fwc.npz`` (1001 points, µ ∈ [−1, 1]), interpolated
linearly in µ_diff."""
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "fwc.npz")


def kernel(params: dict):
    with np.load(DATA) as z:
        mu_tab, p_tab = z["mu"].copy(), z["phase"].copy()
    return lambda md: np.interp(np.clip(md, -1.0, 1.0), mu_tab, p_tab)
