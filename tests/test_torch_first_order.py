"""The port's batched closed-form first order against the JAX package's.

``sos_rt_tpu_torch.ops.first_order.first_order`` (written over a leading
batch axis) against ``jax.vmap`` of ``sos_rt_tpu.ops.first_order.
first_order`` on the same numpy inputs, float64, rtol 1e-12 / atol
1e-14·scale (both evaluate the same closed form; only the order of a few
sums differs).  Both surfaces; µ0 = 0.5 on GridSpec(51, 32), where µ0 lies
on the grid and both resonance branches (|µ ± µ0| < 1e-4) are taken, and
µ0 = 0.437, where neither is; shared (2M,) and per-column (B, 2M) P0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid
from sos_rt_tpu.grids import tau_profile as j_tau_profile
from sos_rt_tpu.models import build_phase_tables
from sos_rt_tpu.ops.first_order import first_order as j_first_order
from sos_rt_tpu_torch.ops import first_order as fo

from torch_cases import assert_close_scaled, jax_scenes, jax_tables

GRID = JGrid(51, 32)
# name → per-column µ0 (a scalar: one shared P0 table)
MU0 = {"resonant": 0.5, "off_grid": 0.437,
       "per_column": np.array([0.5, 0.437, 0.8])}


def _problem(mu0, batch=3):
    """Numpy inputs of first_order for ``batch`` columns, and the in_axes
    of the two P0 tables under vmap."""
    L, M = GRID.nb_layers, GRID.nb_angles
    scenes = jax_scenes(batch, mu0=mu0)
    tau, iu, idn = jax.vmap(
        lambda ta, tr, z0, zu, zd: j_tau_profile(ta, tr, z0, zu, zd, L))(
        scenes.tau_star_atm, scenes.tau_star_aer, scenes.z0, scenes.z_up,
        scenes.z_down)
    dtau_aer = scenes.tau_star_aer / (idn + 1 - iu)
    dtau_atm = scenes.tau_star_atm / L
    w_atm = dtau_atm / (dtau_atm + dtau_aer)
    w_aer = dtau_aer / (dtau_atm + dtau_aer)
    if np.ndim(mu0) == 0:
        t = jax_tables(GRID, mu0=float(mu0))
        p0a, p0r, p0_axis = t.p0_atm, t.p0_aer, None
    else:
        t = jax_tables(GRID)
        p0 = lambda kind, **kw: np.stack([
            build_phase_tables(kind, GRID.mu(), float(m), cache=False, **kw)[0]
            for m in mu0])
        p0a, p0r, p0_axis = p0("rayleigh"), p0("hg", g=0.7), 0
    per_column = [tau, scenes.mu0, scenes.grd_alb, scenes.alb_atm, scenes.alb_aer,
                  iu, idn, w_atm, w_aer]
    return ([np.array(x) for x in per_column], np.array(p0a), np.array(p0r),
            np.array(t.p_atm), np.array(t.p_aer), p0_axis)


def _jax_first_order(surface, problem):
    cols, p0a, p0r, pa, pr, p0_axis = problem
    mu = jnp.asarray(GRID.mu())
    w_mu = jnp.asarray(GRID.trapz_weights())
    fn = jax.vmap(
        lambda tv, mu0, ra, aa, ar, iu, idn, wa, wr, a0, r0: j_first_order(
            surface, tv, mu, GRID.nb_angles, mu0, ra, aa, ar, a0, jnp.asarray(pa),
            r0, jnp.asarray(pr), iu, idn, wa, wr, w_mu),
        in_axes=(0,) * 9 + (p0_axis, p0_axis))
    return np.asarray(fn(*(jnp.asarray(c) for c in cols), jnp.asarray(p0a),
                         jnp.asarray(p0r)))


def _port_first_order(surface, problem):
    cols, p0a, p0r, pa, pr, _ = problem
    tv, mu0, ra, aa, ar, iu, idn, wa, wr = (torch.as_tensor(c) for c in cols)
    t = torch.as_tensor
    return fo.first_order(surface, tv, t(GRID.mu()), GRID.nb_angles, mu0, ra, aa, ar,
                          t(p0a), t(pa), t(p0r), t(pr), iu, idn, wa, wr,
                          t(GRID.trapz_weights()))


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("mu0", list(MU0))
def test_first_order_matches_vmapped_jax(surface, mu0):
    problem = _problem(MU0[mu0])
    want = _jax_first_order(surface, problem)
    got = _port_first_order(surface, problem)
    assert got.dtype == torch.float64
    assert tuple(got.shape) == want.shape == (3, GRID.nb_layers, 2 * GRID.nb_angles)
    assert np.isfinite(want).all()
    assert_close_scaled(got.numpy(), want, rtol=1e-12, atol_scale=1e-14)


def test_resonance_branches_are_taken():
    """µ0 = 0.5 sits on GridSpec(51, 32)'s µ grid on both halves; 0.437 on
    neither: the cases above cover both branches of both selects."""
    mu = GRID.mu()
    m = GRID.nb_angles
    on = lambda v: bool((np.abs(v) < 1e-4).any())
    assert on(mu[:m - 1] + 0.5) and on(mu[m + 1:] - 0.5)
    assert not on(mu[:m - 1] + 0.437) and not on(mu[m + 1:] - 0.437)


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
def test_chunks_of_columns_give_the_same_field(surface, monkeypatch):
    problem = _problem(MU0["per_column"])
    whole = _port_first_order(surface, problem)
    # one (L, M) float64 plane per chunk: three chunks of one column
    monkeypatch.setattr(fo, "FIRST_ORDER_PLANE_BYTES",
                        GRID.nb_layers * GRID.nb_angles * 8)
    chunked = _port_first_order(surface, problem)
    assert_close_scaled(chunked.numpy(), whole.numpy(), rtol=1e-13, atol_scale=1e-15)
