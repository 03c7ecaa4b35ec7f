"""The port's outputs.py, forcing.py and the ``run`` / ``critical-albedo``
commands against the JAX package's, on the CPU.

- outputs: every function on the same float64 field, single column and
  batched, within rtol 1e-12 of JAX's (the heating rate, a difference of
  neighbouring fluxes, with an absolute floor of 1e-12 of its largest
  value: the two packages sum the flux quadratures in another order);
- forcing: ``radiative_forcing_batch(engine='mega')`` = the port's
  ``radiative_forcing`` (the reference engine) = JAX's per-column forcing,
  rtol 1e-9 / atol 1e-12; ``critical_albedo`` and ``critical_albedo_batch``
  (engines mega, reference, fused) give JAX's bisection results;
- commands: ``run`` (with ``--save-orders`` and ``--plot``) and
  ``critical-albedo`` through ``cli.main`` with ``--device cpu`` on a small
  grid write what JAX's commands write (npz within rtol 1e-9 / atol
  1e-12·scale, equal order counts; equal albedo curves).  JAX's own
  ``critical-albedo --engine reference`` stops with a broadcasting error in
  its full-field flux (a (B, L) τ against a (B,) µ0), so the port's
  ``--engine reference`` is held to JAX's ``--engine column`` curve.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sos_rt_tpu.presets as j_presets
from sos_rt_tpu import outputs as jout
from sos_rt_tpu.cli import main as j_main
from sos_rt_tpu.config import GridSpec as JGrid, Scene as JScene, SolverOptions as JOpts
from sos_rt_tpu.forcing import critical_albedo as j_critical_albedo
from sos_rt_tpu.forcing import radiative_forcing as j_radiative_forcing
from sos_rt_tpu.solver import solve_column as j_solve_column
from sos_rt_tpu_torch import outputs, presets
from sos_rt_tpu_torch.cli import main
from sos_rt_tpu_torch.config import GridSpec
from sos_rt_tpu_torch.forcing import (critical_albedo, critical_albedo_batch,
                                      radiative_forcing, radiative_forcing_batch)

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(32, 48)
M, L = GRID.nb_angles, GRID.nb_layers
MU, W = GRID.mu(), GRID.trapz_weights()
T = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def field():
    """A JAX float64 solution of one specular column and its scene."""
    tables = jax_tables(GRID)
    scene = JScene(grd_alb=0.15)
    opts = JOpts(surface="specular", dtype="float64")
    sol = jax.jit(j_solve_column, static_argnums=(2, 3))(scene, tables, GRID, opts)
    return sol, scene


def _close(got, want, rtol=1e-12, atol_scale=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


@pytest.mark.parametrize("beam", ["graphe", "heating", "physical"])
def test_fluxes_match_jax(field, beam):
    sol, scene = field
    i, tau = np.asarray(sol.i_total), np.asarray(sol.tau)
    fu, fd = outputs.flux_up_down(T(i), T(MU), T(W), T(tau), 0.5, 0.15, M, beam=beam)
    jfu, jfd = jout.flux_up_down(sol.i_total, jnp.asarray(MU), jnp.asarray(W), sol.tau,
                                 scene.mu0, scene.grd_alb, M, beam=beam)
    _close(fu, jfu), _close(fd, jfd)
    nf = outputs.net_flux(T(i), T(MU), T(W), T(tau), 0.5, 0.15, beam=beam)
    _close(nf, jout.net_flux(sol.i_total, jnp.asarray(MU), jnp.asarray(W), sol.tau,
                             scene.mu0, scene.grd_alb, beam=beam))


def test_diffusivity_heating_rate_toa_net_match_jax(field):
    sol, scene = field
    i, tau = np.asarray(sol.i_total), np.asarray(sol.tau)
    jmu, jw = jnp.asarray(MU), jnp.asarray(W)
    _close(outputs.diffusivity(T(i), T(MU), T(W)), jout.diffusivity(sol.i_total, jmu, jw))
    z = np.linspace(120.0, 0.0, L)
    for erase in (True, False):
        hr = outputs.heating_rate(T(i), T(MU), T(W), T(tau), T(z), 0.5, 0.15, M,
                                  int(sol.idx_up), int(sol.idx_down), erase_pics=erase)
        _close(hr, jout.heating_rate(sol.i_total, jmu, jw, sol.tau, jnp.asarray(z),
                                     scene.mu0, scene.grd_alb, M, sol.idx_up,
                                     sol.idx_down, erase_pics=erase), atol_scale=1e-12)
    iu, idn = int(sol.idx_up), int(sol.idx_down)
    assert hr[iu - 1] != hr[iu - 2] and hr[idn] != hr[idn - 1]   # erase_pics=False
    _close(outputs.toa_net_flux(T(i), T(MU), T(W), T(tau), 0.5, 0.15, M),
           jout.toa_net_flux(sol.i_total, jmu, jw, sol.tau, scene.mu0, scene.grd_alb, M))
    orders = np.stack([i, 0.5 * i, 0.25 * i])
    _close(outputs.per_order_diffusivity(T(orders), T(MU), T(W)),
           jout.per_order_diffusivity(jnp.asarray(orders), jmu, jw))
    with pytest.raises(ValueError, match="beam"):
        outputs.net_flux(T(i), T(MU), T(W), T(tau), 0.5, 0.15, beam="other")


def test_outputs_take_batched_columns(field):
    """(B, L, 2M) fields with (B,) per-column scalars: each column as
    JAX's function gives it for that column alone."""
    sol, scene = field
    i, tau = np.asarray(sol.i_total), np.asarray(sol.tau)
    ib, taub = np.stack([i, 0.7 * i]), np.stack([tau, 1.3 * tau])
    mu0, grd, iu, idn = [0.5, 0.7], [0.15, 0.4], [5, 8], [10, 20]
    z = np.linspace(120.0, 0.0, L)
    hr = outputs.heating_rate(T(ib), T(MU), T(W), T(taub), T(z), T(mu0), T(grd), M,
                              T(iu), T(idn))
    net = outputs.toa_net_flux(T(ib), T(MU), T(W), T(taub), T(mu0), T(grd), M)
    jmu, jw = jnp.asarray(MU), jnp.asarray(W)
    for k in range(2):
        _close(hr[k], jout.heating_rate(jnp.asarray(ib[k]), jmu, jw, jnp.asarray(taub[k]),
                                        jnp.asarray(z), mu0[k], grd[k], M, iu[k], idn[k]),
               atol_scale=1e-12)
        _close(net[k], jout.toa_net_flux(jnp.asarray(ib[k]), jmu, jw, jnp.asarray(taub[k]),
                                         mu0[k], grd[k], M))


@pytest.fixture(scope="module")
def forcing_case():
    """Three columns, their JAX per-column forcings and critical albedos."""
    tables = jax_tables(GRID)
    opts = JOpts(surface="lambertian", dtype="float64")
    scenes = jax_scenes(3, grd_alb=np.linspace(0.05, 0.4, 3),
                        tau_star_aer=np.linspace(0.05, 0.3, 3),
                        alb_aer=np.linspace(0.8, 1.0, 3))
    f = jax.jit(j_radiative_forcing, static_argnums=(2, 3))
    col = lambda k: jax.tree_util.tree_map(lambda x: x[k], scenes)
    forcing = np.array([float(f(col(k), tables, GRID, opts)) for k in range(3)])
    albedo = np.asarray(j_critical_albedo(scenes, tables, GRID, opts))
    return port_inputs(scenes, tables, GRID, opts), forcing, albedo


def test_radiative_forcing_matches_jax(forcing_case):
    port, want, _ = forcing_case
    for got in (radiative_forcing(*port, device="cpu"),
                radiative_forcing_batch(*port, engine="mega", device="cpu"),
                radiative_forcing_batch(*port, engine="fused", device="cpu")):
        assert got.shape == (3,) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    # one column with scalar fields
    scenes = port[0].map(lambda x: x[1])
    one = radiative_forcing(scenes, *port[1:], device="cpu")
    assert one.shape == ()
    np.testing.assert_allclose(float(one), want[1], rtol=1e-9, atol=1e-12)
    none = dataclasses.replace(scenes, tau_star_aer=0.0)
    assert abs(float(radiative_forcing(none, *port[1:], device="cpu"))) < 1e-12


@pytest.mark.parametrize("engine", ["column", "mega", "reference", "fused"])
def test_critical_albedo_matches_jax(forcing_case, engine):
    port, _, want = forcing_case
    if engine == "column":
        got = critical_albedo(*port, device="cpu")
    else:
        got = critical_albedo_batch(*port, engine=engine, device="cpu")
    assert got.shape == (3,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    assert ((got > 0) & (got < 1)).all()


@pytest.fixture
def small_hg(monkeypatch):
    """The hg preset on GRID in both packages."""
    for mod, grid_cls in ((j_presets, JGrid), (presets, GridSpec)):
        small = dataclasses.replace(mod.PRESETS["hg"], grid=grid_cls(M, L))
        monkeypatch.setitem(mod.PRESETS, "hg", small)


@pytest.mark.parametrize("extra", [
    ["--save-orders", "--plot"],
    ["--surface", "specular", "--mu0", "0.6", "--alb-aer", "0.9"],
])
def test_run_cmd_matches_jax(tmp_path, monkeypatch, extra):
    monkeypatch.chdir(tmp_path)
    argv = ["run", "--preset", "hg", "--nb-angles", str(M), "--nb-layers", str(L)] + extra
    j_main(argv + ["-o", "jax.npz"])
    main(argv + ["-o", "port.npz", "--device", "cpu"])
    with np.load("jax.npz") as zj, np.load("port.npz") as zp:
        assert sorted(zp.files) == sorted(zj.files)
        assert int(zp["n_orders"]) == int(zj["n_orders"]) >= 2
        for k in zj.files:
            assert zp[k].shape == zj[k].shape and np.isfinite(zp[k]).all(), k
            assert_close_scaled(zp[k], zj[k], rtol=1e-9, atol_scale=1e-12)
    if "--save-orders" in extra:
        with np.load("jax_orders.npz") as zj, np.load("port_orders.npz") as zp:
            assert sorted(zp.files) == sorted(zj.files)
            assert zp["I_orders"].shape == zj["I_orders"].shape
            for k in zj.files:
                assert_close_scaled(zp[k], zj[k], rtol=1e-9, atol_scale=1e-12)
        assert os.path.getsize("port_orders.png") > 0 and os.path.getsize("port.png") > 0


def test_critical_albedo_cmd_matches_jax(tmp_path, monkeypatch, small_hg):
    monkeypatch.chdir(tmp_path)
    argv = ["critical-albedo", "--preset", "hg", "--tau-aer", "0.05,0.3", "--num", "3"]
    j_main(argv + ["--engine", "column", "-o", "jax_column.json"])
    j_main(argv + ["--engine", "mega", "-o", "jax_mega.json"])
    def load(path):
        with open(path) as f:
            return json.load(f)

    for engine, want in (("column", "jax_column.json"), ("reference", "jax_column.json"),
                         ("mega", "jax_mega.json")):
        out = f"port_{engine}.json"
        main(argv + ["--engine", engine, "--device", "cpu", "-o", out]
             + (["--plot"] if engine == "mega" else []))
        got, ref = load(out), load(want)
        assert got["preset"] == "hg" and list(got["critical_albedo"]) == list(
            ref["critical_albedo"])
        np.testing.assert_allclose(list(got["critical_albedo"].values()),
                                   list(ref["critical_albedo"].values()), rtol=1e-9)
    assert os.path.getsize("port_mega.png") > 0
