"""The port's reference engine against the JAX package's.

``solve_batch(engine='reference')`` (the default), ``solve_column``,
``solve_column_orders`` and ``solve_batch_orders`` of the port, on the CPU,
against ``sos_rt_tpu``'s on the same numpy-made inputs:

- float64: equal order counts and convergence flags, I_total and I₁ within
  rtol 1e-9 / atol 1e-11·scale (the engines' contract,
  tests/test_megastream.py), for both ``scan_impl`` values, both surfaces,
  a grid with small-µ columns whose bands cover them, a batch whose bands
  do not (``mega_small_ok`` false), per-column µ0 tables, and buckets with
  the predicted sort;
- float32 (scene and tables in float32 on both sides): equal order counts;
  values within F32_LIMITS, measured here at p50 3.3e-7, p99 3.7e-5 and at
  most 0.12% of values off by more than 1e-5 of scale (max 6.3e-3 of scale:
  a last bit that moves a µ→0⁺ smoothing endpoint; XLA contracts
  ``a*b + c`` into one FMA and torch does not);
- the scans: ``_affine_scan`` to the bit against the JAX package's, in
  process (its associative scan run op by op) and in a process of its own
  where XLA:CPU has no FMA (``--xla_cpu_max_isa=SSE4_2``), for both
  methods, odd and even L, forward and reverse; the sweep functions and the
  smoothing walk against JAX's, and the walk against the fused engine's
  ``smooth_rows`` on the same rows.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, Scene as JScene, SolverOptions as JOpts
from sos_rt_tpu.models import build_phase_tables as j_build
from sos_rt_tpu.ops import sweeps as jsw
from sos_rt_tpu.parallel import solve_batch as j_solve_batch
from sos_rt_tpu.parallel.mesh import mega_small_ok as j_mega_small_ok
from sos_rt_tpu.solver import PhaseTables as JTables
from sos_rt_tpu.solver import solve_batch_orders as j_solve_batch_orders
from sos_rt_tpu.solver import solve_column as j_solve_column
from sos_rt_tpu.solver import solve_column_orders as j_solve_column_orders
from sos_rt_tpu_torch import convert
from sos_rt_tpu_torch.ops import fused_sweeps as fs
from sos_rt_tpu_torch.ops import sweeps as sw
from sos_rt_tpu_torch.parallel import solve_batch
from sos_rt_tpu_torch.parallel.mesh import mega_small_ok
from sos_rt_tpu_torch.solver import (_ratio, solve_batch_orders, solve_column,
                                     solve_column_orders)

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = JGrid(56, 64)
SMALL_MU = JGrid(201, 48)
# float32 port against float32 JAX, over all values of I_total: p50 and
# p99 relative difference, the share of values off by more than 1e-5 of
# scale, and the largest difference of scale
F32_LIMITS = {"p50": 1e-6, "p99": 1e-4, "frac_off": 3e-3, "max": 2e-2}


def _mu0_tables(grid, mu0):
    """Rayleigh + HG (g=0.7) tables with one P0 row per column's µ0."""
    mu = grid.mu()
    p0 = lambda kind, **kw: np.stack([j_build(kind, mu, m, cache=False, **kw)[0]
                                      for m in mu0])
    base = jax_tables(grid)
    return JTables(p0_atm=jnp.asarray(p0("rayleigh")), p_atm=base.p_atm,
                   p0_aer=jnp.asarray(p0("hg", g=0.7)), p_aer=base.p_aer)


# name → (grid, surface, scenes, tables)
CASES = {
    "lambertian": lambda: (GRID, "lambertian", jax_scenes(4), jax_tables(GRID)),
    "specular": lambda: (GRID, "specular", jax_scenes(4), jax_tables(GRID)),
    "small_mu": lambda: (SMALL_MU, "lambertian", jax_scenes(3), jax_tables(SMALL_MU)),
    "small_mu_uncovered": lambda: (SMALL_MU, "specular",
                                   jax_scenes(3, tau_star_atm=0.01, tau_star_aer=0.005),
                                   jax_tables(SMALL_MU)),
    "mu0_tables": lambda: (GRID, "lambertian", jax_scenes(3, mu0=np.array([0.8, 0.4, 0.6])),
                           _mu0_tables(GRID, [0.8, 0.4, 0.6])),
}


@pytest.fixture(scope="module")
def solved():
    """JAX reference solves, one per (case, scan_impl, dtype), shared by the
    file's tests."""
    cache = {}

    def get(name, scan_impl="associative", dtype="float64", mm=None):
        key = (name, scan_impl, dtype, mm)
        if key not in cache:
            grid, surface, scenes, tables = CASES[name]()
            opts = JOpts(surface=surface, dtype=dtype, scan_impl=scan_impl, mm=mm)
            if dtype == "float32":
                f32 = lambda t: jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), t)
                ref = j_solve_batch(f32(scenes), f32(tables), grid, opts)
            else:
                ref = j_solve_batch(scenes, tables, grid, opts)
            port = port_inputs(scenes, tables, grid, opts, dtype=getattr(torch, dtype))
            cache[key] = (ref, port, scenes, grid)
        return cache[key]

    return get


def _assert_matches(got, ref):
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert got.i_total.dtype == torch.float64
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-9, atol_scale=1e-11)
    assert_close_scaled(got.i1.numpy(), ref.i1, rtol=1e-9, atol_scale=1e-11)
    assert_close_scaled(got.tau.numpy(), ref.tau, rtol=1e-14, atol_scale=0.0)
    np.testing.assert_array_equal(got.idx_up.numpy(), np.asarray(ref.idx_up))
    np.testing.assert_array_equal(got.idx_down.numpy(), np.asarray(ref.idx_down))


@pytest.mark.parametrize("scan_impl", ["associative", "sequential"])
@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_jax(solved, name, scan_impl):
    ref, port, _, _ = solved(name, scan_impl)
    got = solve_batch(*port, device="cpu")            # the default engine
    _assert_matches(got, ref)
    assert bool(got.converged.all())


def test_cases_cover_the_small_mu_routes(solved):
    _, port, scenes, grid = solved("small_mu_uncovered")
    assert not mega_small_ok(port[0], port[2]) and not j_mega_small_ok(scenes, grid)
    _, port, scenes, grid = solved("small_mu")
    assert mega_small_ok(port[0], port[2]) and j_mega_small_ok(scenes, grid)
    assert sw.stencils_for(port[2]).small_cols.size > 0


def test_buckets_and_predicted_sort(solved, monkeypatch):
    import sos_rt_tpu_torch.fused as fz

    monkeypatch.setattr(fz, "PREDICT_MIN_BATCH", 1)     # the predictor runs
    ref, port, _, _ = solved("lambertian")
    for kw in (dict(buckets=2, sort="predict"), dict(buckets=2), dict(sort="predict")):
        got = solve_batch(*port, engine="reference", device="cpu", **kw)
        _assert_matches(got, ref)
    with pytest.raises(ValueError, match="divisible"):
        solve_batch(*port, engine="reference", buckets=3, device="cpu")


@pytest.mark.parametrize("mm", [None, "bf16x3"])
@pytest.mark.parametrize("name", ["lambertian", "specular", "small_mu"])
def test_float32_order_counts_match_jax(solved, name, mm):
    ref, port, _, _ = solved(name, dtype="float32", mm=mm)
    got = solve_batch(*port, device="cpu")
    assert got.i_total.dtype == torch.float32
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    want = np.asarray(ref.i_total)
    diff = np.abs(got.i_total.numpy() - want)
    scale = np.abs(want).max()
    keep = np.abs(want) > 1e-12 * scale
    rel = diff[keep] / np.abs(want)[keep]
    measured = {"p50": np.median(rel), "p99": np.percentile(rel, 99),
                "frac_off": float((diff > 1e-5 * scale).mean()),
                "max": float(diff.max() / scale)}
    for k, limit in F32_LIMITS.items():
        assert measured[k] <= limit, measured


def test_solve_column_matches_jax():
    """One column with scalar Scene fields: JAX's signature, unbatched
    results."""
    tables = jax_tables(GRID)
    scene = JScene(grd_alb=0.3, alb_aer=0.9)
    opts = JOpts(surface="specular", dtype="float64")
    ref = jax.jit(j_solve_column, static_argnums=(2, 3))(scene, tables, GRID, opts)
    from sos_rt_tpu_torch.config import Scene

    got = solve_column(Scene(grd_alb=0.3, alb_aer=0.9), convert.tables_from(tables, device="cpu"),
                       convert.grid_from(GRID), convert.options_from(opts), device="cpu")
    assert got.i_total.shape == (64, 112) and got.tau.shape == (64,)
    assert got.n_orders.shape == () and got.converged.shape == ()
    assert int(got.n_orders) == int(ref.n_orders) and bool(got.converged)
    assert int(got.idx_up) == int(ref.idx_up) and int(got.idx_down) == int(ref.idx_down)
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-9, atol_scale=1e-11)
    # (1,) fields give the same column
    one = solve_column(convert.scene_from(jax_scenes(1), device="cpu"),
                       convert.tables_from(tables, device="cpu"), convert.grid_from(GRID),
                       convert.options_from(opts), device="cpu")
    assert one.i_total.shape == (64, 112)


@pytest.mark.parametrize("save_rows", [None, (0, -1), (5, 0, -2)])
def test_solve_column_orders_matches_jax(save_rows):
    tables = jax_tables(GRID)
    scene = JScene(grd_alb=0.6, tau_star_aer=0.3)
    opts = JOpts(surface="lambertian", dtype="float64", max_orders=20)
    j_orders = jax.jit(j_solve_column_orders, static_argnums=(2, 3, 4, 5))
    sol_j, buf_j, valid_j = j_orders(scene, tables, GRID, opts, None, save_rows)
    from sos_rt_tpu_torch.config import Scene

    sol, buf, valid = solve_column_orders(
        Scene(grd_alb=0.6, tau_star_aer=0.3), convert.tables_from(tables, device="cpu"),
        convert.grid_from(GRID), convert.options_from(opts), save_rows=save_rows,
        device="cpu")
    assert buf.shape == tuple(buf_j.shape) and valid.shape == (20,)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    assert int(sol.n_orders) == int(sol_j.n_orders) == int(valid.sum())
    assert_close_scaled(buf.numpy(), buf_j, rtol=1e-9, atol_scale=1e-11)
    assert not buf[int(valid.sum()):].any()            # zeros past the last order
    if save_rows is None:                               # the orders sum to the total
        np.testing.assert_allclose(buf.sum(0).numpy(), sol.i_total.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("rows", [(0, -1), None])
def test_solve_batch_orders_matches_jax(rows):
    """Per-column µ0 tables, columns that stop at different orders, and a
    column that reaches max_orders."""
    mu0 = np.array([0.8, 0.4, 0.6])
    tables = _mu0_tables(GRID, mu0)
    scenes = jax_scenes(3, mu0=mu0)
    opts = JOpts(surface="specular", dtype="float64", max_orders=12)
    sol_j, orders_j, valid_j = jax.jit(j_solve_batch_orders, static_argnums=(2, 3, 4))(
        scenes, tables, GRID, opts, rows)
    sol, orders, valid = solve_batch_orders(*port_inputs(scenes, tables, GRID, opts),
                                            rows=rows, device="cpu")
    assert orders.shape == tuple(orders_j.shape) and valid.shape == (3, 12)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(sol.n_orders.numpy(), np.asarray(sol_j.n_orders))
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(sol_j.converged))
    assert not bool(sol.converged.all()) and int(sol.n_orders.max()) == 12
    assert_close_scaled(orders.numpy(), orders_j, rtol=1e-9, atol_scale=1e-11)
    assert_close_scaled(sol.i_total.numpy(), sol_j.i_total, rtol=1e-9, atol_scale=1e-11)


def test_ratio_counts_zero_over_zero_as_converged():
    i_tot = torch.zeros((2, 4, 8), dtype=torch.float64)
    i_tot[0, 0, 4:] = 2.0
    i_tot[0, -1, :4] = 4.0
    cur = torch.ones_like(i_tot)
    r = _ratio(cur, i_tot, 4)
    assert r.tolist() == [0.5, 0.0]
    assert float(_ratio(cur[0], i_tot[0], 4)) == 0.5


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [1, 2, 7, 64, 65, 100])
def test_associative_scan_bits_equal_jax(L, reverse):
    """The associative scan pairs as the JAX package's does: to the bit
    against it run op by op (no fused multiply-add)."""
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, (L, 5))
    b = rng.uniform(-1.0, 1.0, (L, 5))
    want = np.asarray(jsw._affine_scan(jnp.asarray(a), jnp.asarray(b), reverse=reverse))
    got = sw._affine_scan(torch.as_tensor(a)[None], torch.as_tensor(b)[None],
                          reverse=reverse)[0].numpy()
    np.testing.assert_array_equal(got, want)
    seq = sw._affine_scan(torch.as_tensor(a), torch.as_tensor(b), reverse=reverse,
                          method="sequential").numpy()
    np.testing.assert_allclose(seq, want, rtol=1e-13, atol=1e-15)


_NO_FMA_SCANS = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from sos_rt_tpu.ops.sweeps import _affine_scan
out = {}
for L in (7, 64, 65):
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, (L, 5)); b = rng.uniform(-1.0, 1.0, (L, 5))
    for reverse in (False, True):
        for method in ("associative", "sequential"):
            f = jax.jit(_affine_scan, static_argnums=(2, 3))
            y = f(jnp.asarray(a), jnp.asarray(b), reverse, method)
            out[f"{L}-{reverse}-{method}"] = np.asarray(y).tolist()
json.dump(out, sys.stdout)
"""


def test_affine_scan_bits_equal_jitted_jax_without_fma():
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _NO_FMA_SCANS], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    want = json.loads(res.stdout)
    assert len(want) == 12
    for key, ys in want.items():
        L, reverse, method = key.split("-")
        rng = np.random.default_rng(int(L))
        a = torch.as_tensor(rng.uniform(0.5, 1.0, (int(L), 5)))
        b = torch.as_tensor(rng.uniform(-1.0, 1.0, (int(L), 5)))
        got = sw._affine_scan(a, b, reverse=reverse == "True", method=method)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ys), err_msg=key)


def _sweep_inputs(B=3, L=40, M=12, seed=7):
    rng = np.random.default_rng(seed)
    tau = np.cumsum(rng.uniform(0.0, 0.02, (B, L)), axis=1)
    jn = rng.uniform(0.0, 1.0, (B, L, 2 * M))
    mu = JGrid(M, L).mu()
    iu = np.array([5, 10, 12])[:B]
    idn = np.array([15, 20, 30])[:B]
    return tau, jn, mu, iu, idn


def test_sweep_functions_match_jax():
    tau, jn, mu, iu, idn = _sweep_inputs()
    M = jn.shape[-1] // 2
    T = torch.as_tensor
    for method in ("associative", "sequential"):
        want = np.stack([np.asarray(jsw.down_sweep_scan(
            jnp.asarray(jn[i, :, :M]), jnp.asarray(tau[i]), jnp.asarray(mu[:M]), method))
            for i in range(3)])
        got = sw.down_sweep_scan(T(jn[:, :, :M]), T(tau), T(mu[:M]), method)
        assert_close_scaled(got.numpy(), want, rtol=1e-12, atol_scale=1e-14)
        bc = jn[:, -1, M + 1:] * 0.3
        want = np.stack([np.asarray(jsw.up_sweep_scan(
            jnp.asarray(jn[i, :, M + 1:]), jnp.asarray(tau[i]), jnp.asarray(mu[M + 1:]),
            jnp.asarray(bc[i]), iu[i], idn[i], method)) for i in range(3)])
        got = sw.up_sweep_scan(T(jn[:, :, M + 1:]), T(tau), T(mu[M + 1:]), T(bc), T(iu),
                               T(idn), method)
        assert_close_scaled(got.numpy(), want, rtol=1e-12, atol_scale=1e-14)
    # the small-µ values on a grid that has small-µ columns (|µ| < 0.01)
    mu_s = np.array([-0.008, -0.004, -0.0005])
    taylor = np.abs(mu_s) < 1e-3
    raw = jn[:, :, :3] * 2.0
    want = np.stack([np.asarray(jsw.down_small_mu(
        jnp.asarray(jn[i, :, :3]), jnp.asarray(raw[i]), jnp.asarray(tau[i]),
        jnp.asarray(mu_s), jnp.asarray(taylor), iu[i], idn[i])) for i in range(3)])
    got = sw.down_small_mu(T(jn[:, :, :3]), T(raw), T(tau), T(mu_s), T(taylor), T(iu), T(idn))
    assert_close_scaled(got.numpy(), want, rtol=1e-13, atol_scale=1e-15)


def _smooth_rows_input(m=64, rows=12, seed=5):
    """Rows with a sharp µ→0⁺ feature, so that the walk blends, and flat
    rows, where it takes its last lane."""
    mu = JGrid(m, 8).mu()
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.2, 2.0, (rows, 1))
    width = rng.uniform(0.01, 0.05, (rows, 1))
    up = amp * np.exp(-mu[m:][None, :] / width) + 0.01 * mu[m:][None, :]
    up[-2:] = rng.uniform(0.0, 1.0, (2, m))               # rough rows: no stop
    return np.concatenate([rng.uniform(0, 1, up.shape), up], axis=1), mu


def test_smooth_up_rows_matches_jax_and_fused_smooth_rows():
    m = 64
    rows, mu = _smooth_rows_input(m)
    want = np.asarray(jsw.smooth_up_rows(jnp.asarray(rows), jnp.asarray(mu), m))
    got = sw.smooth_up_rows(torch.as_tensor(rows), torch.as_tensor(mu), m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-16)
    assert not np.array_equal(want, rows)               # the walk did blend
    np.testing.assert_array_equal(got.numpy()[:, :m], rows[:, :m])
    # batched (B, L, 2M) rows give the same rows
    got3 = sw.smooth_up_rows(torch.as_tensor(rows).reshape(3, 4, 2 * m),
                             torch.as_tensor(mu), m)
    assert torch.equal(got3.reshape(-1, 2 * m), got)
    # the fused engine's walk over the up half (lane 0 = µ=0⁺) takes the
    # same stops and blends
    mu_row = torch.as_tensor(np.concatenate([[0.0], mu[m + 1:]]))
    fused = fs.smooth_rows(torch.as_tensor(rows[:, m:]), mu_row)
    np.testing.assert_allclose(fused.numpy(), got.numpy()[:, m:], rtol=1e-14, atol=1e-16)


def test_scan_impl_option_reaches_the_engine(monkeypatch):
    """Each value of scan_impl takes its scan, as the JAX package's (any
    value but 'sequential' is associative)."""
    seen = []
    real = sw._affine_scan

    def spy(a, b, reverse=False, method="associative"):
        seen.append(method)
        return real(a, b, reverse=reverse, method=method)

    import sos_rt_tpu_torch.solver as solver

    monkeypatch.setattr(solver, "_affine_scan", spy)
    opts = JOpts(surface="lambertian", dtype="float64", max_orders=3)
    port = port_inputs(jax_scenes(2), jax_tables(JGrid(16, 12)), JGrid(16, 12), opts)
    for impl in ("sequential", "other"):
        seen.clear()
        solve_batch(*port[:3], dataclasses.replace(port[3], scan_impl=impl),
                    device="cpu")
        assert set(seen) == {impl} and len(seen) == 4   # two orders, two sweeps
    a = torch.rand(2, 9, 3, dtype=torch.float64)
    b = torch.rand(2, 9, 3, dtype=torch.float64)
    assert torch.equal(sw._affine_scan(a, b, method="other"), sw._affine_scan(a, b))
