"""The frozen reference against the port's own CPU solves in float64 at a
small grid: equal order counts and flags, rows within rtol 1e-9."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from sosbench import check, spec, traffic_gen
from sosbench.reference import grid as ref_grid
from sosbench.reference import phase

GRIDS = [{"nb_angles": 16, "nb_layers": 32}, {"nb_angles": 24, "nb_layers": 40}]


def port_solve(cfg, scenes, p0_mu0, engine):
    from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.solver import PhaseTables

    g = GridSpec(**cfg["grid"])
    tables = PhaseTables.from_models_batched_mu0(g, p0_mu0, atm=tuple(cfg["atm"]),
                                                 aer=tuple(cfg["aer"]), device="cpu", cache=False)
    opts = SolverOptions(surface=cfg["surface"], dtype="float64", tol=cfg["tol"],
                         max_orders=cfg["max_orders"])
    sc = Scene(**{k: torch.as_tensor(v) for k, v in scenes.items()})
    sol = solve_batch(sc, tables, g, opts, engine=engine,
                      outputs="summary" if engine == "mega" else "full", device="cpu")
    rows = ((sol.i_toa, sol.i_surface) if engine == "mega"
            else (sol.i_total[:, 0], sol.i_total[:, -1]))
    return {"i_toa": rows[0].numpy(), "i_surface": rows[1].numpy(),
            "n_orders": sol.n_orders.numpy(), "converged": sol.converged.numpy()}


@pytest.mark.parametrize("grid", GRIDS, ids=["16x32", "24x40"])
@pytest.mark.parametrize("cfg_name,engine", [("hg_canonical", "reference"),
                                             ("fwc_sweep", "mega")])
def test_reference_is_the_ports_float64_solve(cfg_name, engine, grid):
    cfg = dict(spec.config(cfg_name), grid=grid)
    rng = np.random.default_rng(7)
    scenes = traffic_gen.scenes(cfg, spec.traffic("closed_b256"), rng, 6)
    mu0 = rng.choice(np.linspace(0.2, 0.95, 8), 6)
    scenes["mu0"] = mu0
    ref = check.reference(cfg, scenes, mu0, torch.device("cpu"))
    got = port_solve(cfg, scenes, mu0, engine)
    np.testing.assert_array_equal(got["n_orders"], ref["n_orders"])
    np.testing.assert_array_equal(got["converged"], ref["converged"])
    for k in check.ROWS:
        scale = np.abs(ref[k]).max()
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, atol=1e-11 * scale)


def test_reference_tables_are_the_ports():
    from sos_rt_tpu_torch.models import build_phase_tables

    mu = ref_grid.mu_grid(16)
    for spec_ in (["rayleigh", {}], ["hg", {"g": 0.7}], ["fwc", {}]):
        p0, p = phase.tables(spec_, mu, [0.37])
        q0, q = build_phase_tables(spec_[0], mu, 0.37, cache=False, **spec_[1])
        np.testing.assert_allclose(p0[0], q0, rtol=1e-13)
        np.testing.assert_allclose(p, q, rtol=1e-13)


def test_sweep_scenes_are_the_sweeps():
    """The benchmark's re-make of a sweep's scenes from its seed is the
    scene batch the port's sweep builds."""
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.sweep import build_sweep_batch

    cfg = dict(spec.config("fwc_sweep"), batch=50)
    p = get_preset("fwc_sweep")
    p = dataclasses.replace(p, grid=type(p.grid)(nb_angles=16, nb_layers=32))
    scenes, tables = build_sweep_batch(p, 50, seed=2 ** 40 + 3, mu0_pool=64, device="cpu")
    mine, pool, idx = traffic_gen.sweep_scenes(cfg, 2 ** 40 + 3)
    for k in traffic_gen.SCENE_KEYS:
        np.testing.assert_array_equal(getattr(scenes, k).numpy(), mine[k])
    assert np.array_equal(pool, np.linspace(0.2, 0.95, 64))
