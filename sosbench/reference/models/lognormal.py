"""Log-normal polydisperse Mie scattering (SOS_Aer_phase_func.py:398-753,
``log_normal_mie``), from Bohren & Huffman's BHMIE (Absorption and
Scattering of Light by Small Particles, 1983, appendix A), NumPy float64.

For each sphere of size parameter x = 2πr/λ and relative index m:

- the logarithmic derivative D_n(mx) by downward recurrence from
  D_nmx = 0, nmx = max(n_stop, |mx|) + 15;
- the Riccati–Bessel functions ψ_n, χ_n by upward recurrence, ξ_n = ψ_n − iχ_n;
- a_n = ((D_n/m + n/x) ψ_n − ψ_{n−1}) / ((D_n/m + n/x) ξ_n − ξ_{n−1}), b_n
  the same with m·D_n, for n = 1 .. n_stop;
- S1, S2 from the angular functions π_n, τ_n; Qext, Qsca from the a_n, b_n.

``m`` is used exactly as the configuration gives it: in BH's convention
(time factor e^{−iωt}) Im m > 0 is an absorbing sphere.

The source's discretisation of the size distribution: radii
linspace(0.01, 10, 100) µm; n(r) = r⁻¹·exp(−(ln r − ln r_m)² / (2 ln²σ)),
with no constant; per radius the unpolarised intensity normalised as the
source's miepython call does ("albedo": i(µ) = (|S1|² + |S2|²) /
(2π x² Qext), whose integral over 4π is Qsca/Qext); weights n(r)·Qsca(r);
the trapezoid over radius on 6,001 points of µ_diff ∈ [−1, 1]; K(µ_diff)
the linear interpolation in that table.

Departures from the source:

- n_stop = ⌊x + 4.05 x^(1/3) + 2⌋ + 1 (Wiscombe's criterion for
  8 < x < 4200, which miepython takes at every x); BHMIE's is
  x + 4 x^(1/3) + 2.
- The radius integral is taken once on the 6,001-point table, and the
  (µ, µ', φ) samples interpolate in the integrated table; the source
  interpolates each radius's table and integrates after.  Both are linear
  in the table, so they agree to rounding.
- ``n0`` (the number density) scales every weight alike and drops out of
  the normalised tables; it is read and not used.
"""
from __future__ import annotations

import numpy as np

N_RADII = 100
RADIUS_UM = (0.01, 10.0)
N_DIFF = 6001


def n_stop(x: float) -> int:
    return int(x + 4.05 * x ** (1.0 / 3.0) + 2.0) + 1


def coefficients(m: complex, x: float):
    """BHMIE's a_n, b_n (n = 1 .. n_stop) of a sphere of index ``m`` and
    size parameter ``x``."""
    m, x = complex(m), float(x)
    nstop = n_stop(x)
    y = m * x
    nmx = max(nstop, int(abs(y))) + 15
    d = np.zeros(nmx + 1, dtype=np.complex128)
    for n in range(nmx, 0, -1):
        d[n - 1] = n / y - 1.0 / (d[n] + n / y)
    a = np.empty(nstop, dtype=np.complex128)
    b = np.empty(nstop, dtype=np.complex128)
    psi0, psi1 = np.cos(x), np.sin(x)
    chi0, chi1 = -np.sin(x), np.cos(x)
    xi1 = complex(psi1, -chi1)
    for n in range(1, nstop + 1):
        psi = (2 * n - 1) * psi1 / x - psi0
        chi = (2 * n - 1) * chi1 / x - chi0
        xi = complex(psi, -chi)
        ta = d[n] / m + n / x
        tb = m * d[n] + n / x
        a[n - 1] = (ta * psi - psi1) / (ta * xi - xi1)
        b[n - 1] = (tb * psi - psi1) / (tb * xi - xi1)
        psi0, psi1 = psi1, psi
        chi0, chi1 = chi1, chi
        xi1 = xi
    return a, b


def _ext_sca(a, b, x: float):
    n = np.arange(1, len(a) + 1, dtype=np.float64)
    qext = 2.0 / x ** 2 * np.sum((2 * n + 1) * (a.real + b.real))
    qsca = 2.0 / x ** 2 * np.sum((2 * n + 1) * (np.abs(a) ** 2 + np.abs(b) ** 2))
    return float(qext), float(qsca)


def efficiencies(m: complex, x: float):
    """(Qext, Qsca, Qback) of one sphere."""
    a, b = coefficients(m, x)
    n = np.arange(1, len(a) + 1, dtype=np.float64)
    qback = np.abs(np.sum((2 * n + 1) * (-1.0) ** n * (a - b))) ** 2 / x ** 2
    return (*_ext_sca(a, b, x), float(qback))


def amplitudes(a, b, mu: np.ndarray):
    """S1(µ), S2(µ) from the coefficients, µ = cos θ."""
    s1 = np.zeros(mu.shape, dtype=np.complex128)
    s2 = np.zeros(mu.shape, dtype=np.complex128)
    pi0, pi1 = np.zeros_like(mu), np.ones_like(mu)
    for n in range(1, len(a) + 1):
        tau = n * mu * pi1 - (n + 1) * pi0
        f = (2 * n + 1) / (n * (n + 1))
        s1 += f * (a[n - 1] * pi1 + b[n - 1] * tau)
        s2 += f * (a[n - 1] * tau + b[n - 1] * pi1)
        pi0, pi1 = pi1, ((2 * n + 1) * mu * pi1 - (n + 1) * pi0) / n
    return s1, s2


def intensity(m: complex, x: float, mu: np.ndarray):
    """(i(µ), Qsca): the unpolarised intensity in the "albedo" normalisation,
    i = (|S1|² + |S2|²) / (2π x² Qext), and the sphere's Qsca."""
    a, b = coefficients(m, x)
    qext, qsca = _ext_sca(a, b, x)
    s1, s2 = amplitudes(a, b, mu)
    return (np.abs(s1) ** 2 + np.abs(s2) ** 2) / (2.0 * np.pi * x ** 2 * qext), qsca


def table(m: complex, wavelength: float, r_m: float, sigma: float):
    """(µ_diff grid, the radius-integrated intensity on it)."""
    radii = np.linspace(*RADIUS_UM, N_RADII)
    n_r = np.exp(-(np.log(radii) - np.log(r_m)) ** 2 / (2.0 * np.log(sigma) ** 2)) / radii
    md = np.linspace(-1.0, 1.0, N_DIFF)
    rows, qsca = zip(*(intensity(m, 2.0 * np.pi * r / wavelength, md) for r in radii))
    weighted = (n_r * np.array(qsca))[:, None] * np.stack(rows)
    return md, np.trapezoid(weighted, radii, axis=0)


def kernel(params: dict):
    md, tab = table(params["indx"], float(params["lambda0"]), float(params["r_m"]),
                    float(params["sig"]))
    return lambda x: np.interp(np.clip(x, -1.0, 1.0), md, tab)
