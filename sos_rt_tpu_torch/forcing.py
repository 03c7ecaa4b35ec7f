"""Radiative forcing and the Haywood critical-albedo search.

Counterpart of ``sos_rt_tpu/forcing.py`` (reference:
SOS_Aer_critical_albedo.py:20-410).  Two deviations, both documented
reference defects:

1. The reference's "aerosol-free" baseline call passes *identical*
   arguments except the ``tauStar_aer`` flag (critical_albedo.py:388) —
   the baseline solve equals the perturbed solve, so ΔF ≡ 0 and the
   bisection always terminates immediately.  Here the baseline is a real
   aerosol-free solve (``tau_star_aer = 0`` → pure molecular profile).
2. The reference reads the module-global ``tauStar_tot`` inside the
   function (critical_albedo.py:39 vs 486) — everything is passed
   explicitly here.

The bisection stays a host loop (its trip count is tiny and data
dependent); each evaluation solves the whole batch of scenes at once on
the device: through the reference engine (:func:`radiative_forcing`, the
default per-column path) or through a production engine
(:func:`make_batched_forcing_fn`, :func:`critical_albedo_batch`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from sos_rt_tpu_torch.config import (SCENE_FIELDS, GridSpec, Scene, SolverOptions,
                                     full_precision_matmul, resolve_device)
from sos_rt_tpu_torch.outputs import _beam_scale, toa_net_flux
from sos_rt_tpu_torch.solver import PhaseTables, solve_batch_reference

FORCING_TOL = 1e-3       # |ΔF| acceptance (critical_albedo.py:402)
BRACKET_TOL = 0.1        # bisection bracket width (critical_albedo.py:397)


def _aerosol_free(scene: Scene) -> Scene:
    return dataclasses.replace(
        scene, tau_star_aer=torch.zeros_like(torch.as_tensor(scene.tau_star_aer,
                                                             dtype=torch.float64)))


def _batch_shape(scene: Scene):
    """The batch shape the scene's fields broadcast to (() for one column)."""
    return torch.broadcast_shapes(*(torch.as_tensor(getattr(scene, f)).shape
                                    for f in SCENE_FIELDS))


def _grid_weights(grid: GridSpec, like):
    as_t = lambda x: torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return as_t(grid.mu()), as_t(grid.trapz_weights())


def _toa_net(scene: Scene, tables: PhaseTables, grid: GridSpec,
             opts: SolverOptions, device):
    """TOA net flux of every column through the reference engine; scene
    fields of any one batch shape (() for one column)."""
    shape = _batch_shape(scene)
    sol = solve_batch_reference(scene, tables, grid, opts, device=device)
    mu, w_mu = _grid_weights(grid, sol.i_total)
    col = lambda x: torch.as_tensor(x, dtype=torch.float64,
                                    device=device).expand(shape).reshape(-1)
    net = toa_net_flux(sol.i_total, mu, w_mu, sol.tau, col(scene.mu0),
                       col(scene.grd_alb), grid.nb_angles)
    return net.reshape(shape)


def radiative_forcing(scene: Scene, tables: PhaseTables, grid: GridSpec,
                      opts: SolverOptions, device=None):
    """ΔF = net TOA flux (with aerosol) − net TOA flux (aerosol-free), per
    column, through the reference engine.  ``scene`` fields are scalars
    (one column) or share one batch shape (B,); ``device`` defaults to
    CUDA."""
    device = resolve_device(device)
    return (_toa_net(scene, tables, grid, opts, device)
            - _toa_net(_aerosol_free(scene), tables, grid, opts, device))


def toa_net_from_summary(summ, scenes: Scene, grid: GridSpec):
    """TOA net flux (critical-albedo convention, critical_albedo.py:
    377-382) from a :class:`sos_rt_tpu_torch.fused.SweepSummary` — only the
    TOA radiance row is needed, so the summary path suffices."""
    full_precision_matmul()
    m = grid.nb_angles
    mu, w_mu = _grid_weights(grid, summ.i_toa)
    on = lambda x: torch.as_tensor(x, dtype=summ.i_toa.dtype, device=summ.i_toa.device)
    mu0 = on(scenes.mu0)
    f0 = math.pi / mu0
    scale = _beam_scale("heating", f0, mu0)
    tau_star = summ.tau[:, -1]
    down_diff = torch.einsum("bm,m,m->b", summ.i_toa[:, :m], mu[:m], w_mu[:m])
    up_diff = torch.einsum("bm,m,m->b", summ.i_toa[:, m:], mu[m:], w_mu[m:])
    flux_down0 = down_diff - scale                      # e^{-0/µ0} = 1
    flux_up0 = up_diff + on(scenes.grd_alb) * scale * torch.exp(-2.0 * tau_star / mu0)
    return -flux_down0 - flux_up0


def _net_generic(sol, scenes: Scene, grid: GridSpec):
    """TOA net flux from either a SweepSummary or a full solution."""
    if hasattr(sol, "i_toa"):
        return toa_net_from_summary(sol, scenes, grid)
    mu, w_mu = _grid_weights(grid, sol.i_total)
    return toa_net_flux(sol.i_total, mu, w_mu, sol.tau, scenes.mu0,
                        scenes.grd_alb, grid.nb_angles)


def _solve_net(scenes: Scene, tables: PhaseTables, grid: GridSpec,
               opts: SolverOptions, engine: str, device):
    from sos_rt_tpu_torch.fused import scene_on
    from sos_rt_tpu_torch.parallel import solve_batch

    scenes = scene_on(scenes, device)
    sol = solve_batch(scenes, tables, grid, opts, engine=engine,
                      outputs="summary" if engine == "mega" else "full",
                      device=device)
    return _net_generic(sol, scenes, grid)


def radiative_forcing_batch(scenes: Scene, tables: PhaseTables,
                            grid: GridSpec, opts: SolverOptions,
                            engine: str = "mega", device=None):
    """Batched ΔF of (B,)-batched ``scenes`` through a production engine:
    two solves (with aerosol / aerosol-free), summary rows for the mega
    engine.  ``device`` defaults to CUDA."""
    device = resolve_device(device)
    return (_solve_net(scenes, tables, grid, opts, engine, device)
            - _solve_net(_aerosol_free(scenes), tables, grid, opts, engine, device))


def make_batched_forcing_fn(engine: str = "mega", device=None):
    """A ``forcing_fn`` for :func:`critical_albedo` built on the batched
    engines (:func:`sos_rt_tpu_torch.parallel.solve_batch`): each
    evaluation is one batched solve, and the aerosol-free baseline, which
    does not depend on the bisection variable ω_aer, is solved once on the
    first call and reused for every later step.  The closure keeps that
    baseline: build a fresh one per :func:`critical_albedo` call (the CLI
    and :func:`critical_albedo_batch` do)."""
    device = resolve_device(device)
    cache = {}

    def forcing_fn(trial: Scene, tables: PhaseTables, grid: GridSpec,
                   opts: SolverOptions):
        if "net0" not in cache:
            cache["net0"] = _solve_net(_aerosol_free(trial), tables, grid, opts,
                                       engine, device)
        return _solve_net(trial, tables, grid, opts, engine, device) - cache["net0"]

    return forcing_fn


def critical_albedo_batch(scenes: Scene, tables: PhaseTables,
                          grid: GridSpec, opts: SolverOptions,
                          engine: str = "mega", device=None):
    """Haywood critical-albedo search over a (B,)-lane scene batch through
    a production engine: one batched solve per bisection step plus one
    baseline solve in all.  The per-column :func:`critical_albedo` default
    path (the reference engine) is its verification twin."""
    device = resolve_device(device)
    return critical_albedo(scenes, tables, grid, opts,
                           forcing_fn=make_batched_forcing_fn(engine, device),
                           device=device)


def critical_albedo(scene: Scene, tables: PhaseTables, grid: GridSpec,
                    opts: SolverOptions, forcing_fn=None, device=None):
    """Bisection on the aerosol single-scattering albedo ω_aer ∈ [0, 1]
    until |ΔF| < 1e-3 or the bracket narrows below 0.1
    (critical_albedo.py:394-410).  Works on batched scenes: each lane keeps
    its own bracket; every step is one batched forcing solve
    (``forcing_fn``, default :func:`radiative_forcing`).  Returns float64
    albedos of the scene's batch shape on ``device`` (default CUDA)."""
    device = resolve_device(device)
    if forcing_fn is None:
        # the TPU package keeps one compiled forcing function per (grid,
        # options) here (_forcing_fn_cached); nothing is compiled in the
        # port, so there is nothing to cache
        forcing_fn = lambda s, t, g, o: radiative_forcing(s, t, g, o, device=device)
    shape = _batch_shape(scene)
    alb_min = torch.zeros(shape, dtype=torch.float64, device=device)
    alb_max = torch.ones(shape, dtype=torch.float64, device=device)
    result = torch.full(shape, math.nan, dtype=torch.float64, device=device)
    # the bracket halves each step: ≤ ceil(log2(1/0.1)) + 1 = 5 steps
    while True:
        width = alb_max - alb_min
        if not bool(((width > BRACKET_TOL) & torch.isnan(result)).any()):
            break
        alb_test = 0.5 * (alb_max + alb_min)
        trial = dataclasses.replace(scene, alb_aer=alb_test)
        delta_f = forcing_fn(trial, tables, grid, opts)
        hit = (torch.abs(delta_f) < FORCING_TOL) & torch.isnan(result)
        result = torch.where(hit, alb_test, result)
        alb_min = torch.where(delta_f > 0, alb_test, alb_min)
        alb_max = torch.where(delta_f <= 0, alb_test, alb_max)
    return torch.where(torch.isnan(result), 0.5 * (alb_max + alb_min), result)
