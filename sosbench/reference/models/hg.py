"""Henyey–Greenstein: K(µ_diff) = (1 − g²) / (1 + g² − 2g µ_diff)^(3/2),
asymmetry ``g`` (SOS_Aer_phase_func.py)."""


def kernel(params: dict):
    g = float(params["g"])
    return lambda md: (1.0 - g * g) / (1.0 + g * g - 2.0 * g * md) ** 1.5
