"""Rayleigh scattering: K(µ_diff) = 3/4 (1 + µ_diff²) (SOS_Aer_phase_func.py)."""


def kernel(params: dict):
    return lambda md: 0.75 * (1.0 + md * md)
