"""Mie scattering core — Bohren–Huffman series, NumPy float64, host-side.

Counterpart of ``sos_rt_tpu/models/miecore.py``.  Phase tables are built
once per scenario on the host, so this never runs on the card; the native
core (``models/_native.py``, ``csrc/miecore.cpp``) computes the same
series, and this NumPy version is its fallback.

Normalization matches ``miepython.i_unpolarized``'s default 'albedo'
normalization: the scattered intensity integrates over 4π steradians to the
single-scattering albedo Qsca/Qext, i.e.

    i(µ) = (|S1|² + |S2|²) / (2 π x² Qext).
"""
from __future__ import annotations

import numpy as np

from sos_rt_tpu_torch.models import _native


def _nstop(x: float) -> int:
    """Wiscombe series-truncation criterion."""
    return int(np.ceil(x + 4.05 * x ** (1.0 / 3.0) + 2.0))


def mie_ab(m: complex, x: float):
    """Mie coefficients a_n, b_n for n = 1..nstop.

    Uses the downward recurrence for the logarithmic derivative D_n(mx)
    and upward recurrence for the Riccati–Bessel functions ψ_n, ξ_n.
    ``m`` is used exactly as passed (the wildfire preset passes 1.7+0.03j,
    as the reference does); pass n - ik for an absorbing sphere in the
    usual convention.
    """
    x = float(x)
    if x <= 0:
        raise ValueError("size parameter x must be > 0")
    m = complex(m)
    nmax = _nstop(x)
    if _native.get_lib() is not None:
        return _native.native_ab(m, x, nmax)
    mx = m * x
    nmx = max(nmax, int(abs(mx))) + 16

    # Downward recurrence for D_n(mx) = ψ'_n(mx)/ψ_n(mx).
    d = np.zeros(nmx + 1, dtype=np.complex128)
    for n in range(nmx, 0, -1):
        d[n - 1] = n / mx - 1.0 / (d[n] + n / mx)

    a = np.zeros(nmax, dtype=np.complex128)
    b = np.zeros(nmax, dtype=np.complex128)
    psi_nm1, psi_n = np.cos(x), np.sin(x)          # ψ_{-1}, ψ_0
    chi_nm1, chi_n = -np.sin(x), np.cos(x)         # χ_{-1}, χ_0
    xi_n = psi_n - 1j * chi_n
    for n in range(1, nmax + 1):
        psi = (2 * n - 1) / x * psi_n - psi_nm1
        chi = (2 * n - 1) / x * chi_n - chi_nm1
        xi = psi - 1j * chi
        da = d[n] / m + n / x
        db = d[n] * m + n / x
        a[n - 1] = (da * psi - psi_n) / (da * xi - xi_n)
        b[n - 1] = (db * psi - psi_n) / (db * xi - xi_n)
        psi_nm1, psi_n = psi_n, psi
        chi_nm1, chi_n = chi_n, chi
        xi_n = xi
    return a, b


def efficiencies_single(m: complex, x: float):
    """(Qext, Qsca, Qback, g) for one sphere."""
    a, b = mie_ab(m, x)
    if _native.get_lib() is not None:
        return _native.native_efficiencies(a, b, x)
    n = np.arange(1, len(a) + 1, dtype=np.float64)
    qext = (2.0 / x**2) * np.sum((2 * n + 1) * (a.real + b.real))
    qsca = (2.0 / x**2) * np.sum((2 * n + 1) * (np.abs(a) ** 2 + np.abs(b) ** 2))
    qback = (1.0 / x**2) * np.abs(np.sum((2 * n + 1) * (-1.0) ** n * (a - b))) ** 2
    asym = np.sum(
        n[:-1] * (n[:-1] + 2) / (n[:-1] + 1)
        * (a[:-1] * np.conj(a[1:]) + b[:-1] * np.conj(b[1:])).real
    ) + np.sum((2 * n + 1) / (n * (n + 1)) * (a * np.conj(b)).real)
    g = (4.0 / x**2) * asym / qsca if qsca > 0 else 0.0
    return qext, qsca, qback, g


def efficiencies(m: complex, x):
    """Vectorized (Qext, Qsca, Qback, g) over an array of size parameters.

    Signature of ``miepython.efficiencies`` minus the unused wavelength
    argument.
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    out = np.array([efficiencies_single(m, xi) for xi in x])
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3]


def s1_s2(m: complex, x: float, mu):
    """Scattering amplitudes S1(µ), S2(µ), un-normalized (BH convention)."""
    mu = np.atleast_1d(np.asarray(mu, dtype=np.float64))
    a, b = mie_ab(m, x)
    if _native.get_lib() is not None:
        return _native.native_s1s2(a, b, mu)
    nmax = len(a)
    s1 = np.zeros(mu.shape, dtype=np.complex128)
    s2 = np.zeros(mu.shape, dtype=np.complex128)
    pi_nm1 = np.zeros_like(mu)   # π_0
    pi_n = np.ones_like(mu)      # π_1
    for n in range(1, nmax + 1):
        tau_n = n * mu * pi_n - (n + 1) * pi_nm1
        f = (2 * n + 1) / (n * (n + 1))
        s1 += f * (a[n - 1] * pi_n + b[n - 1] * tau_n)
        s2 += f * (a[n - 1] * tau_n + b[n - 1] * pi_n)
        pi_next = ((2 * n + 1) * mu * pi_n - (n + 1) * pi_nm1) / n
        pi_nm1, pi_n = pi_n, pi_next
    return s1, s2


def i_unpolarized(m: complex, x: float, mu):
    """Unpolarized scattered intensity, 'albedo'-normalized, as
    ``miepython.i_unpolarized(m, x, mu)``: ∫ i dΩ = Qsca/Qext over the
    sphere."""
    s1, s2 = s1_s2(m, x, mu)
    qext, _, _, _ = efficiencies_single(m, x)
    return (np.abs(s1) ** 2 + np.abs(s2) ** 2) / (2.0 * np.pi * x**2 * qext)
