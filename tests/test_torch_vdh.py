"""The port's single-layer solve against van de Hulst / Chandrasekhar theory
and against the JAX package (CPU, float64).

Mirrors tests/test_vdh.py on ``sos_rt_tpu_torch.single_layer`` and
``sos_rt_tpu_torch.validation``: the H-function against its published
values and exact identities, the doubling solver's energy balance and its
thick-slab limit, the single-layer SOS solve against the semi-infinite law
and against doubling (the same cases and tolerances as test_vdh.py), its
first order against the closed form, and ``vdh_extract``.  Each solve is
also held against ``sos_rt_tpu.single_layer.solve_single_layer`` on the
same tables: equal order counts and validity, every field within rtol 1e-9
(atol 1e-11·scale), with both ``scan_impl`` values where that is cheap;
the port's anchors equal the JAX package's.
"""
import dataclasses

import numpy as np
import pytest

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.single_layer import solve_single_layer as j_solve
from sos_rt_tpu.validation import vdh as j_vdh
from sos_rt_tpu_torch import convert
from sos_rt_tpu_torch.models import build_phase_tables
from sos_rt_tpu_torch.single_layer import (first_order_single, solve_single_layer,
                                           vdh_extract)
from sos_rt_tpu_torch.validation import (chandrasekhar_h, doubling_slab, gauss_mu,
                                         hg_azimuth_avg, semi_infinite_reflection)

from torch_cases import assert_close_scaled

VDH_MU = np.array([0.1, 0.3, 0.5, 0.7, 0.9, 1.0])


# ---------------------------------------------------------------------------
# the anchors: published values, identities, and the JAX package's copy
# ---------------------------------------------------------------------------

def test_h_function_published_conservative():
    """Chandrasekhar 1950, Table XI (ω=1, isotropic): H(1) = 2.9078."""
    assert abs(chandrasekhar_h([1.0], omega=1.0)[0] - 2.9078) < 2e-3


def test_h_function_exact_moments_conservative():
    """Exact moments for ω=1: ∫₀¹H dµ = 2, ∫₀¹H µ dµ = 2/√3."""
    g, w = gauss_mu(256)
    h = chandrasekhar_h(g, omega=1.0)
    assert abs(np.sum(w * h) - 2.0) < 1e-4
    assert abs(np.sum(w * g * h) - 2.0 / np.sqrt(3.0)) < 1e-4


def test_h_function_zeroth_moment_identity():
    """(ω/2)·∫₀¹H dµ = 1 − √(1−ω) (exact for every ω)."""
    g, w = gauss_mu(256)
    for omega in (0.3, 0.8, 0.95):
        lhs = 0.5 * omega * np.sum(w * chandrasekhar_h(g, omega=omega))
        assert abs(lhs - (1.0 - np.sqrt(1.0 - omega))) < 1e-10


def test_h_function_raises_when_not_converged():
    with pytest.raises(RuntimeError, match="not converged"):
        chandrasekhar_h([0.5], omega=1.0, iters=3)


def test_doubling_conserves_energy_conservative():
    """ω=1: plane albedo + diffuse transmission + direct = 1."""
    out = doubling_slab(tau_star=1.0, omega=1.0, mu0=0.5, g=0.0)
    assert abs(out["albedo"] + out["trans_diffuse"] + out["t_direct"] - 1.0) < 1e-7


def test_doubling_matches_semi_infinite():
    """Thick-slab doubling → the H-function law (independent formulations)."""
    mu0, omega = 0.6, 0.9
    out = doubling_slab(tau_star=64.0, omega=omega, mu0=mu0, g=0.0)
    want = semi_infinite_reflection(out["mu"], mu0, omega)
    sel = out["mu"] >= 0.05
    assert np.allclose(out["i_up"][sel], want[sel], rtol=2e-5)


def test_anchors_equal_jax():
    mu = np.linspace(0.0, 1.0, 11)
    np.testing.assert_array_equal(chandrasekhar_h(mu, 0.9), j_vdh.chandrasekhar_h(mu, 0.9))
    np.testing.assert_array_equal(semi_infinite_reflection(mu[1:], 0.5, 0.8),
                                  j_vdh.semi_infinite_reflection(mu[1:], 0.5, 0.8))
    np.testing.assert_array_equal(hg_azimuth_avg(mu, -mu, 0.75),
                                  j_vdh.hg_azimuth_avg(mu, -mu, 0.75))
    got = doubling_slab(1.0, 0.97, 0.5, g=0.75, n_quad=32)
    want = j_vdh.doubling_slab(1.0, 0.97, 0.5, g=0.75, n_quad=32)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the single-layer solve against the anchors and against the JAX package
# ---------------------------------------------------------------------------

def _iso_tables(grid):
    return build_phase_tables("iso", grid.mu(), 0.5)


def _solve(grid, opts, mu0, tau_star, omega, tables, scan_impls=("associative",)):
    """The port's solve (each ``scan_impl``) held against JAX's; returns
    the port's total field (numpy) and solution."""
    ref = j_solve(mu0, tau_star, tables, grid, opts, alb=omega)
    scale = float(np.abs(np.asarray(ref.i_total)).max())
    for impl in scan_impls:
        popts = dataclasses.replace(convert.options_from(opts), scan_impl=impl)
        sol = solve_single_layer(mu0, tau_star, tables, convert.grid_from(grid), popts,
                                 alb=omega, device="cpu")
        assert bool(sol.converged) and bool(ref.converged)
        assert int(sol.n_orders) == int(ref.n_orders)
        np.testing.assert_array_equal(sol.order_valid.numpy(), np.asarray(ref.order_valid))
        for got, want in ((sol.i_total, ref.i_total), (sol.i_orders, ref.i_orders)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                       atol=1e-11 * scale)
    return sol.i_total.numpy(), sol


def test_single_layer_vs_semi_infinite_iso():
    """Thick isotropic slab at van de Hulst's angles against
    (ω/4)H(µ)H(µ0)/(µ+µ0), at µ ≥ 0.3 (below it the µ→0⁺ smoothing blends
    the field, as the reference does); test_vdh.py's rtol 1e-3."""
    grid = JGrid(nb_angles=96, nb_layers=2400)
    opts = JOpts(max_orders=120, dtype="float64")
    mu0, omega, tau_star = 0.5, 0.8, 25.0
    field, _ = _solve(grid, opts, mu0, tau_star, omega, _iso_tables(grid))
    up, _ = vdh_extract(field, convert.grid_from(grid), mu_values=VDH_MU)
    want = semi_infinite_reflection(VDH_MU, mu0, omega)
    sel = VDH_MU >= 0.3
    np.testing.assert_allclose(up[sel], want[sel], rtol=1e-3)


@pytest.mark.parametrize("omega,g,mu0,rtol,nb_phi", [
    (1.0, 0.0, 0.5, 2e-3, None),    # conservative isotropic
    (0.9, 0.0, 0.7, 2e-3, None),    # absorbing isotropic
    (0.97, 0.75, 0.5, 8e-3, 25),    # HG with the reference's 25-point-φ tables
    (0.97, 0.75, 0.5, 5e-3, 401),   # HG with a 401-point-φ table
])
def test_single_layer_vs_doubling(omega, g, mu0, rtol, nb_phi):
    """Finite slab (τ*=1): SOS reflection/transmission against doubling,
    with test_vdh.py's tolerances (µ ≥ 0.25, and 5% / 15% over the whole
    range, where the µ→0⁺ blend flattens the field by construction)."""
    grid = JGrid(nb_angles=96, nb_layers=400)
    opts = JOpts(max_orders=150, dtype="float64")
    tau_star = 1.0
    if g == 0.0:
        tables = _iso_tables(grid)
    elif nb_phi == 25:
        tables = build_phase_tables("hg", grid.mu(), mu0, g=g)
    else:
        from sos_rt_tpu_torch.models.phase_common import azimuth_p0, azimuth_p_matrix

        kern = lambda c: (1 - g * g) / (1 + g * g - 2 * g * c) ** 1.5
        tables = (azimuth_p0(kern, grid.mu(), mu0, nb_phi=nb_phi),
                  azimuth_p_matrix(kern, grid.mu(), nb_phi=nb_phi))
    impls = ("associative", "sequential") if nb_phi is None and omega == 1.0 else (
        "associative",)
    field, _ = _solve(grid, opts, mu0, tau_star, omega, tables, scan_impls=impls)
    dbl = doubling_slab(tau_star=tau_star, omega=omega, mu0=mu0, g=g)
    m = grid.nb_angles
    mu = np.asarray(grid.mu(), np.float64)
    sel = dbl["mu"] >= 0.25
    up = np.interp(dbl["mu"][sel], mu[m:], field[0, m:])
    dn = np.interp(-dbl["mu"][sel][::-1], mu[:m], field[-1, :m])[::-1]
    np.testing.assert_allclose(up, dbl["i_up"][sel], rtol=rtol)
    np.testing.assert_allclose(dn, dbl["i_down"][sel], rtol=rtol)
    all_up = np.interp(dbl["mu"], mu[m:], field[0, m:])
    np.testing.assert_allclose(all_up, dbl["i_up"], rtol=5e-2 if g == 0.0 else 1.5e-1)


def test_single_layer_first_order_closed_form():
    """I₁ of the solve against the closed form at an interior point, and
    first_order_single against JAX's."""
    import jax.numpy as jnp

    from sos_rt_tpu.single_layer import first_order_single as j_first

    grid = JGrid(nb_angles=64, nb_layers=200)
    opts = JOpts(max_orders=2, dtype="float64")
    mu0, omega, tau_star = 0.5, 0.9, 0.7
    tables = _iso_tables(grid)
    sol = solve_single_layer(mu0, tau_star, tables, convert.grid_from(grid),
                             convert.options_from(opts), alb=omega, device="cpu")
    i1 = sol.i_orders[0].numpy()
    tau = np.linspace(0.0, tau_star, grid.nb_layers)
    m = grid.nb_angles
    mu = np.asarray(grid.mu(), np.float64)
    t = 77
    mm = mu[m + 20]
    want_up = (omega / (4 * np.pi)) * (mu0 / (mu0 + mm)) * (
        np.exp(-tau[t] / mu0)
        - np.exp(-tau_star / mu0) * np.exp(-(tau_star - tau[t]) / mm))
    assert np.isclose(i1[t, m + 20], want_up * np.pi / mu0, rtol=1e-12)
    md = mu[30]
    want_dn = (omega / (4 * np.pi)) * (mu0 / (mu0 + md)) * (
        np.exp(-tau[t] / mu0) - np.exp(tau[t] / md))
    assert np.isclose(i1[t, 30], want_dn * np.pi / mu0, rtol=1e-12)
    import torch

    mu_t = torch.as_tensor(mu)
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    got = first_order_single(torch.as_tensor(tau), mu_t, m, f64(mu0), f64(omega),
                             torch.as_tensor(tables[0]))
    ref = j_first(jnp.asarray(tau), jnp.asarray(mu), m, mu0, omega,
                  jnp.asarray(tables[0]))
    assert np.isfinite(got.numpy()).all()
    assert_close_scaled(got.numpy(), np.asarray(ref), rtol=1e-12, atol_scale=1e-15)


def test_vdh_extract_angles():
    grid = convert.grid_from(JGrid(nb_angles=96, nb_layers=16))
    field = np.tile(np.asarray(grid.mu(), np.float64), (16, 1))
    up, down = vdh_extract(field, grid)
    np.testing.assert_allclose(up, [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0], atol=1e-12)
    np.testing.assert_allclose(down, [0.0, -0.1, -0.3, -0.5, -0.7, -0.9, -1.0],
                               atol=1e-12)
