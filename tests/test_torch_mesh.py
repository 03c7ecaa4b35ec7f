"""Column sharding over a mesh of gloo ranks, held to the unsharded solve
and to the JAX package.

One launch of four processes (``torch_cases.start_ranks``: a gloo group on
a file store, one thread a rank, each importing only ``sos_rt_tpu_torch``
and asserting that it imported no JAX) runs every case on the mesh shapes
(4, 1), (2, 2) and (1, 4) of the same four ranks, as the counterpart of
tests/test_sharding.py: every rank passes the global batch to
``solve_batch(mesh=)`` and writes what it got back.  The parent holds each
rank's result to the port's unsharded solve (rtol 1e-12 / atol 1e-14 with
equal order counts; 1e-11 / 1e-13 where ``shard_tables`` splits the source
products) and to ``sos_rt_tpu.parallel.solve_batch(engine='reference')``
(rtol 1e-9 / atol 1e-11·scale, equal counts), checks that every rank holds
the same global result, that the refused calls raise ``ValueError`` on every
rank, and that a batch whose aerosol layer reaches the ground in one
column sends every rank to the fused engine.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.parallel import solve_batch as j_solve_batch
from sos_rt_tpu.solver import PhaseTables as JTables
from sos_rt_tpu_torch.config import SCENE_FIELDS
from sos_rt_tpu_torch.parallel import solve_batch

from torch_cases import (assert_close_scaled, jax_scenes, jax_tables, port_inputs,
                         start_ranks, wait_ranks)

TABLE_KEYS = ("p0_atm", "p_atm", "p0_aer", "p_aer")
# name → the grid, surface, solve_batch's keywords, the mesh shape, and the
# scene's overrides (batch 8 but where said)
CASES = {
    "reference": ((31, 60), "specular", dict(engine="reference"), (4, 1), {}),
    "mega_full": ((32, 32), "lambertian", dict(engine="mega"), (4, 1), {}),
    "mega_summary": ((32, 32), "lambertian", dict(engine="mega", outputs="summary"),
                     (4, 1), {}),
    "fused": ((31, 32), "specular", dict(engine="fused"), (4, 1), {}),
    # per-column µ0 tables (B, 2M), sharded with their columns
    "mu0_tables": ((32, 32), "lambertian", dict(engine="mega"), (4, 1),
                   dict(mu0=[0.3, 0.5, 0.8, 0.5] * 2)),
    # column 0's aerosol layer ends in the bottom layer: the whole batch
    # goes to the fused engine, though ranks 1-3 hold no such column
    "bottom": ((32, 32), "lambertian", dict(engine="mega"), (4, 1),
               dict(z_down=[0.1] + [17.0] * 7)),
    "tp_2x2": ((31, 60), "specular", dict(engine="reference", shard_tables=True),
               (2, 2), {}),
    "tp_2x2_buckets": ((31, 60), "specular",
                       dict(engine="reference", shard_tables=True, buckets=4), (2, 2), {}),
    # 2M = 62 on a model axis of 4: slices of 16 columns, the last padded
    "tp_1x4": ((31, 32), "specular", dict(engine="reference", shard_tables=True),
               (1, 4), {}),
}
# calls every rank must refuse with ValueError (message part)
ERRORS = {
    "indivisible": ((32, 32), "lambertian", dict(engine="mega"), (4, 1),
                    dict(batch=6), "not divisible"),
    "tp_mega": ((32, 32), "lambertian", dict(engine="mega", shard_tables=True), (2, 2),
                {}, "shard_tables"),
    "tp_fused": ((31, 32), "specular", dict(engine="fused", shard_tables=True), (2, 2),
                 {}, "shard_tables"),
}

BODY = """
import dataclasses
from sos_rt_tpu_torch import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.parallel import make_mesh, solve_batch
from sos_rt_tpu_torch.solver import PhaseTables

z = np.load(cfg["inputs"])
meshes = {}
for name, grid, surface, kw, shape in cfg["cases"]:
    t = lambda k: torch.from_numpy(z[name + "." + k])
    scenes = Scene(**{f: t(f) for f in cfg["scene_keys"]})
    tables = PhaseTables(*(t(k) for k in cfg["table_keys"]))
    if tuple(shape) not in meshes:      # the same order on every rank
        meshes[tuple(shape)] = make_mesh(tuple(shape))
    try:
        sol = solve_batch(scenes, tables, GridSpec(*grid),
                          SolverOptions(surface=surface, dtype="float64"),
                          mesh=meshes[tuple(shape)], **kw)
    except ValueError as e:
        OUT[name + ".error"] = np.array(str(e))
        continue
    for f in dataclasses.fields(sol):
        if getattr(sol, f.name) is not None:
            OUT[name + "." + f.name] = getattr(sol, f.name).numpy()
"""


def _inputs(grid, over):
    over = dict(over)
    batch = over.pop("batch", 8)
    jgrid = JGrid(*grid)
    scenes = jax_scenes(batch, **over)
    if "mu0" in over:
        tables = JTables.from_models_batched_mu0(jgrid, np.asarray(over["mu0"]),
                                                 atm=("rayleigh", {}),
                                                 aer=("hg", {"g": 0.7}))
    else:
        tables = jax_tables(jgrid)
    return scenes, tables, jgrid


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case on the four ranks, and meanwhile in this process the
    port's unsharded solve and the JAX package's reference engine of each:
    (each rank's OUT, {case: (port, jax)})."""
    tmp = tmp_path_factory.mktemp("mesh")
    every = {**CASES, **{k: v[:5] for k, v in ERRORS.items()}}
    arrays, inputs = {}, {}
    for name, (grid, surface, kw, shape, over) in every.items():
        scenes, tables, jgrid = inputs[name] = _inputs(grid, over)
        for k in SCENE_FIELDS:
            arrays[f"{name}.{k}"] = np.asarray(getattr(scenes, k), np.float64)
        for k in TABLE_KEYS:
            arrays[f"{name}.{k}"] = np.asarray(getattr(tables, k), np.float64)
    np.savez(tmp / "inputs.npz", **arrays)
    procs = start_ranks(tmp, 4, BODY, inputs=str(tmp / "inputs.npz"),
                        scene_keys=SCENE_FIELDS, table_keys=TABLE_KEYS,
                        cases=[(n, g, s, kw, m) for n, (g, s, kw, m, _) in every.items()])
    try:
        truth = {}
        for name, (grid, surface, kw, shape, over) in CASES.items():
            scenes, tables, jgrid = inputs[name]
            jopts = JOpts(surface=surface, dtype="float64")
            port = port_inputs(scenes, tables, jgrid, jopts)
            plain = {k: v for k, v in kw.items() if k != "shard_tables"}
            truth[name] = (solve_batch(*port, device="cpu", **plain),
                           j_solve_batch(scenes, tables, jgrid, jopts))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return wait_ranks(procs, tmp), truth


def _rows(out, name):
    """(TOA rows, surface rows) of a rank's result, full or summary."""
    if f"{name}.i_toa" in out:
        return out[f"{name}.i_toa"], out[f"{name}.i_surface"]
    return out[f"{name}.i_total"][:, 0], out[f"{name}.i_total"][:, -1]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_equals_unsharded(run, name):
    outs, truth = run
    plain = truth[name][0]
    tight = not CASES[name][2].get("shard_tables")
    rtol, atol = (1e-12, 1e-14) if tight else (1e-11, 1e-13)
    got = outs[0]
    np.testing.assert_array_equal(got[f"{name}.n_orders"], plain.n_orders.numpy())
    np.testing.assert_array_equal(got[f"{name}.converged"], plain.converged.numpy())
    if hasattr(plain, "i_toa"):
        pairs = [(f"{name}.i_toa", plain.i_toa), (f"{name}.i_surface", plain.i_surface)]
    else:
        pairs = [(f"{name}.i_total", plain.i_total)]
    for key, want in pairs:
        np.testing.assert_allclose(got[key], want.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_equals_jax_reference(run, name):
    outs, truth = run
    ref = truth[name][1]
    got = outs[0]
    np.testing.assert_array_equal(got[f"{name}.n_orders"], np.asarray(ref.n_orders))
    assert bool(got[f"{name}.converged"].all())
    toa, srf = _rows(got, name)
    assert_close_scaled(toa, np.asarray(ref.i_total)[:, 0], rtol=1e-9, atol_scale=1e-11)
    assert_close_scaled(srf, np.asarray(ref.i_total)[:, -1], rtol=1e-9, atol_scale=1e-11)
    if f"{name}.i_total" in got:
        assert_close_scaled(got[f"{name}.i_total"], ref.i_total, rtol=1e-9,
                            atol_scale=1e-11)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_global_batch(run, name):
    outs, _ = run
    keys = sorted(k for k in outs[0] if k.startswith(name + "."))
    batch = CASES[name][4].get("batch", 8)
    assert keys and all(outs[0][k].shape[0] == batch for k in keys)
    for out in outs[1:]:
        assert sorted(k for k in out if k.startswith(name + ".")) == keys
        for k in keys:
            np.testing.assert_array_equal(out[k], outs[0][k])


@pytest.mark.parametrize("name", list(ERRORS))
def test_mesh_refuses(run, name):
    outs, _ = run
    for out in outs:
        assert ERRORS[name][5] in str(out[f"{name}.error"])
        assert not [k for k in out if k.startswith(name + ".") and k != f"{name}.error"]


def test_bottom_layer_sends_every_rank_to_fused(run):
    """The fused engine returns I₁, the mega kernels' full solution none:
    every rank took the fused engine for the batch whose column 0 reaches
    the ground, and the mega kernels where no column does."""
    outs, truth = run
    for out in outs:
        assert "bottom.i1" in out and "mega_full.i1" not in out
        assert int(out["bottom.idx_down"][0]) == 31
        assert (out["bottom.idx_down"][1:] < 31).all()
    assert truth["bottom"][0].i1 is not None and truth["mega_full"][0].i1 is None
    assert torch.equal(torch.from_numpy(outs[0]["bottom.n_orders"]),
                       truth["bottom"][0].n_orders)
