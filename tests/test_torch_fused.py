"""The port's fused engine, solve_batch(engine='fused'), against the JAX package.

On the CPU (the plain versions of the two sweep kernels), in float64, the
port must equal both ``sos_rt_tpu.fused.solve_batch_fused(interpret=True)``
and ``sos_rt_tpu.parallel.solve_batch(engine='reference')``: equal order
counts and flags, ``i_total`` and ``i1`` to rtol 1e-9 / atol 1e-11·scale,
the JAX package's own engine contract (tests/test_fused.py).  Cases: both
surfaces on a uniform grid, a grid with one windowed small-µ column, a
Gauss grid with small-µ columns of which one takes the Taylor branch (and
for which ``mega_small_ok`` is false), a batch that no block size divides,
a layer count that is no multiple of 8 (the reference engine only: the
Pallas kernels need a multiple), per-column P0 tables, and an order cap that
is reached.  One float32 'bf16x3' case against the JAX fused engine in
float32: equal order counts, rows within 1e-5 of scale (both sum the same
split products, in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_fused as j_solve_batch_fused
from sos_rt_tpu.models import build_phase_tables as j_build
from sos_rt_tpu.parallel import solve_batch as j_solve_batch
from sos_rt_tpu.parallel.mesh import mega_small_ok as j_mega_small_ok
from sos_rt_tpu.solver import PhaseTables as JTables
from sos_rt_tpu_torch.fused import solve_batch_fused
from sos_rt_tpu_torch.ops.sweeps import stencils_for
from sos_rt_tpu_torch.parallel import solve_batch
from sos_rt_tpu_torch.parallel.mesh import mega_small_ok

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GAUSS = JGrid(51, 24, spacing="gauss")
PER_COLUMN_MU0 = np.array([0.8, 0.4, 0.6])

# name → (grid, surface, batch, solver options, per-column µ0 or None)
CASES = {
    "lambertian": (JGrid(51, 64), "lambertian", 4, {}, None),
    "specular": (JGrid(51, 64), "specular", 4, {}, None),
    "windowed_m201": (JGrid(201, 16), "specular", 2, {}, None),
    "gauss_taylor": (GAUSS, "lambertian", 3, {}, None),
    "batch_10": (JGrid(24, 32), "lambertian", 10, {}, None),
    "per_column_p0": (JGrid(24, 32), "lambertian", 3, {}, PER_COLUMN_MU0),
    "order_cap": (JGrid(24, 32), "lambertian", 3, {"max_orders": 4}, None),
    "layers_30": (JGrid(24, 30), "specular", 3, {}, None),
}
PALLAS_CASES = [c for c in CASES if c != "layers_30"]


def _inputs(name):
    grid, surface, batch, kw, mu0 = CASES[name]
    opts = JOpts(surface=surface, dtype="float64", **kw)
    tables = jax_tables(grid)
    over = {}
    if mu0 is not None:
        p0 = lambda kind, **k: jnp.asarray(np.stack(
            [j_build(kind, grid.mu(), float(m), cache=False, **k)[0] for m in mu0]))
        tables = JTables(p0_atm=p0("rayleigh"), p_atm=tables.p_atm,
                         p0_aer=p0("hg", g=0.7), p_aer=tables.p_aer)
        over["mu0"] = mu0
    return jax_scenes(batch, **over), tables, grid, opts


@pytest.fixture(scope="module")
def solved():
    """name → (port solution, JAX inputs), solved once per case."""
    cache = {}

    def get(name):
        if name not in cache:
            inputs = _inputs(name)
            cache[name] = (solve_batch(*port_inputs(*inputs), engine="fused",
                                       device="cpu"), inputs)
        return cache[name]

    return get


def _assert_equal_solutions(got, ref, tau_rtol=0.0):
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-9, atol_scale=1e-11)
    assert_close_scaled(got.i1.numpy(), ref.i1, rtol=1e-9, atol_scale=1e-11)
    np.testing.assert_array_equal(got.idx_up.numpy(), np.asarray(ref.idx_up))
    np.testing.assert_array_equal(got.idx_down.numpy(), np.asarray(ref.idx_down))
    np.testing.assert_allclose(got.tau.numpy(), np.asarray(ref.tau), rtol=tau_rtol,
                               atol=0.0)


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_fused_matches_jax_fused(solved, name):
    got, inputs = solved(name)
    ref = j_solve_batch_fused(*inputs, block_b=4, interpret=True)
    _assert_equal_solutions(got, ref)
    assert got.n_orders.dtype == torch.int32 and got.converged.dtype == torch.bool
    grid, batch = CASES[name][0], CASES[name][2]
    assert tuple(got.i_total.shape) == (batch, grid.nb_layers, 2 * grid.nb_angles)
    assert bool(torch.isfinite(got.i_total).all())


@pytest.mark.parametrize("name", list(CASES))
def test_fused_matches_reference(solved, name):
    got, inputs = solved(name)
    ref = j_solve_batch(*inputs, engine="reference")
    # the reference engine's compiled τ profile rounds a product another way
    _assert_equal_solutions(got, ref, tau_rtol=1e-15)
    if name == "order_cap":
        assert not bool(got.converged.any()) and set(got.n_orders.tolist()) == {4}
    else:
        assert bool(got.converged.all())


def test_cases_reach_the_small_mu_branches():
    """What the grids above exercise: one windowed column at M = 201; on
    the Gauss grid three small-µ columns, the last on the Taylor branch,
    that the narrowest band of a thin column does not cover."""
    st = stencils_for(port_inputs(*_inputs("windowed_m201"))[2])
    assert st.small_cols.tolist() == [199] and st.taylor_mask.tolist() == [False]
    scenes, _, grid, _ = port_inputs(*_inputs("gauss_taylor"))
    st = stencils_for(grid)
    assert st.small_cols.tolist() == [47, 48, 49]
    assert st.taylor_mask.tolist() == [False, False, True]
    assert not mega_small_ok(scenes, grid)
    assert not j_mega_small_ok(_inputs("gauss_taylor")[0], GAUSS)
    assert stencils_for(port_inputs(*_inputs("lambertian"))[2]).small_cols.size == 0


def test_float32_bf16x3_matches_jax_fused():
    grid = JGrid(51, 32)
    opts = JOpts(surface="lambertian", dtype="float32", mm="bf16x3")
    scenes, tables = jax_scenes(3), jax_tables(grid)
    t32 = JTables(*(jnp.asarray(x, jnp.float32) for x in
                    (tables.p0_atm, tables.p_atm, tables.p0_aer, tables.p_aer)))
    ref = j_solve_batch_fused(scenes, t32, grid, opts, block_b=4, interpret=True)
    got = solve_batch_fused(*port_inputs(scenes, t32, grid, opts, dtype=torch.float32),
                            device="cpu")
    assert got.i_total.dtype == torch.float32
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert bool(got.converged.all())
    for rows in (0, grid.nb_layers - 1):
        assert_close_scaled(got.i_total[:, rows].numpy(), ref.i_total[:, rows],
                            rtol=0.0, atol_scale=1e-5)
