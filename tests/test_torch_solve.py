"""The port's slice, solve_batch(engine='mega'), against the JAX package.

On the CPU (the plain versions of the kernels), in float64, the port must
equal ``sos_rt_tpu.parallel.solve_batch(engine='reference')`` with equal
order counts and rtol 1e-9 / atol 1e-11·scale — the contract of
tests/test_megastream.py — for both surfaces, a ragged batch, an odd
angle count and a canonical-like small-µ grid.  Also: summary rows equal
full rows, results do not depend on the sort or the block size, every
route runs (the reference engine, the default, and the fused engine equal
the mega engine, the fused engine takes what the mega path cannot, and a
world-size-1 gloo mesh equals the unsharded solve), and the package imports
neither jax nor sos_rt_tpu.  (The comparisons with the JAX mega engine in float32 and
with its order-count predictor are in tests/test_torch_jax_mega.py.)
"""
import dataclasses
import inspect
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.parallel import solve_batch as j_solve_batch
from sos_rt_tpu.parallel.mesh import mega_small_ok as j_mega_small_ok
from sos_rt_tpu_torch import SolverOptions, convert
from sos_rt_tpu_torch.fused import solve_batch_mega
from sos_rt_tpu_torch.parallel import solve_batch
from sos_rt_tpu_torch.parallel.mesh import mega_small_ok

from torch_cases import (assert_close_scaled, jax_scenes, jax_tables, port_inputs,
                         world_of_one)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = JGrid(56, 64)

# name → (grid, surface, batch, cols_per_block)
CASES = {
    "lambertian": (GRID, "lambertian", 4, 2),
    "specular": (GRID, "specular", 4, 2),
    "ragged": (GRID, "lambertian", 3, 2),
    "odd_m53": (JGrid(53, 64), "specular", 3, 3),
    "canonical_like": (JGrid(201, 48), "lambertian", 3, 3),
}


@pytest.fixture(scope="module")
def tables56():
    return jax_tables(GRID)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    grid, surface, batch, cpb = CASES[request.param]
    tables = jax_tables(grid)
    opts = JOpts(surface=surface, dtype="float64")
    scenes = jax_scenes(batch)
    ref = j_solve_batch(scenes, tables, grid, opts)
    port = port_inputs(scenes, tables, grid, opts)
    got = solve_batch(*port, engine="mega", cols_per_block=cpb, device="cpu")
    return request.param, ref, got, port, (scenes, grid)


def test_mega_matches_reference(case):
    name, ref, got, _, _ = case
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert bool(got.converged.all())
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-9, atol_scale=1e-11)
    np.testing.assert_array_equal(got.idx_up.numpy(), np.asarray(ref.idx_up))
    np.testing.assert_array_equal(got.idx_down.numpy(), np.asarray(ref.idx_down))


def test_mega_small_ok_agrees(case):
    _, _, _, port, (scenes, grid) = case
    assert mega_small_ok(port[0], port[2]) == j_mega_small_ok(scenes, grid) is True


def test_summary_rows_equal_full_rows(case):
    name, _, full, port, _ = case
    summ = solve_batch(*port, engine="mega", outputs="summary",
                       cols_per_block=CASES[name][3], device="cpu")
    assert torch.equal(summ.n_orders, full.n_orders)
    assert torch.equal(summ.converged, full.converged)
    assert torch.equal(summ.i_toa, full.i_total[:, 0, :])
    assert torch.equal(summ.i_surface, full.i_total[:, -1, :])


def test_independent_of_sort_and_block_size(tables56):
    opts = JOpts(surface="lambertian", dtype="float64")
    port = port_inputs(jax_scenes(4), tables56, GRID, opts)
    base = solve_batch_mega(*port, cols_per_block=2, device="cpu")
    for kw in (dict(sort=False, cols_per_block=1), dict(sort=False, cols_per_block=4),
               dict(sort=True, cols_per_block=3)):
        other = solve_batch_mega(*port, device="cpu", **kw)
        assert torch.equal(other.n_orders, base.n_orders), kw
        assert_close_scaled(other.i_total.numpy(), base.i_total.numpy(),
                            rtol=1e-13, atol_scale=1e-15)


def test_buckets_match_single_solve(tables56):
    opts = JOpts(surface="lambertian", dtype="float64")
    port = port_inputs(jax_scenes(4), tables56, GRID, opts)
    one = solve_batch(*port, engine="mega", outputs="summary", device="cpu")
    two = solve_batch(*port, engine="mega", outputs="summary", buckets=2, device="cpu")
    assert torch.equal(one.n_orders, two.n_orders)
    assert_close_scaled(two.i_toa.numpy(), one.i_toa.numpy(), rtol=1e-13, atol_scale=1e-15)


def test_predict_sort_keeps_results(tables56, monkeypatch):
    import sos_rt_tpu_torch.fused as fz

    monkeypatch.setattr(fz, "PREDICT_MIN_BATCH", 1)
    opts = JOpts(surface="lambertian", dtype="float64")
    port = port_inputs(jax_scenes(4), tables56, GRID, opts)
    plain = solve_batch_mega(*port, cols_per_block=2, sort=False, device="cpu")
    pred = solve_batch_mega(*port, cols_per_block=2, sort="predict", device="cpu")
    assert torch.equal(pred.n_orders, plain.n_orders)
    assert_close_scaled(pred.i_total.numpy(), plain.i_total.numpy(),
                        rtol=1e-13, atol_scale=1e-15)


def test_entry_points_need_cuda_or_cpu(tables56, monkeypatch):
    from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
    from sos_rt_tpu_torch.parallel import broadcast_scene
    from sos_rt_tpu_torch.solver import PhaseTables

    opts = JOpts(surface="lambertian", dtype="float64")
    port = port_inputs(jax_scenes(2), tables56, GRID, opts)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_batch(*port)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_batch_mega(*port)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        broadcast_scene(Scene(), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PhaseTables.from_models(GridSpec(16, 8), 0.5, cache=False)
    with pytest.raises(RuntimeError):
        solve_batch(*port, device="cuda")
    assert isinstance(SolverOptions(), SolverOptions)


def test_routes_outside_the_slice_raise(tables56):
    from sos_rt_tpu_torch.models import build_phase_tables

    opts = JOpts(surface="lambertian", dtype="float64")
    port = port_inputs(jax_scenes(2), tables56, GRID, opts)
    # the reference engine is ported and the default: it runs, and equals
    # the mega engine; so does the fused engine
    mega = solve_batch(*port, engine="mega", device="cpu")
    for engine in ("reference", None, "fused"):
        kw = {} if engine is None else dict(engine=engine)
        other = solve_batch(*port, device="cpu", **kw)
        assert torch.equal(other.n_orders, mega.n_orders) and other.i1 is not None
        assert_close_scaled(other.i_total.numpy(), mega.i_total.numpy(), rtol=1e-9,
                            atol_scale=1e-11)
    with pytest.raises(ValueError, match="summary"):
        solve_batch(*port, outputs="summary", device="cpu")
    # the mesh is ported: a world-size-1 gloo mesh runs every engine and
    # equals the unsharded solve (sort="score", as the mesh route sorts);
    # anything but a DeviceMesh is refused
    with world_of_one() as mesh:
        for engine in ("mega", "fused", "reference"):
            plain = solve_batch(*port, engine=engine, sort="score", device="cpu")
            meshed = solve_batch(*port, engine=engine, mesh=mesh)
            assert torch.equal(meshed.n_orders, plain.n_orders)
            assert torch.equal(meshed.i_total, plain.i_total), engine
    for engine in ("mega", "fused"):
        with pytest.raises((TypeError, ValueError), match="DeviceMesh"):
            solve_batch(*port, engine=engine, mesh=object(), device="cpu")
    # the resident execution is ported: it runs, and equals the streamed one
    resident = solve_batch_mega(*port, stream=False, device="cpu")
    streamed = solve_batch_mega(*port, stream=True, device="cpu")
    assert bool(resident.converged.all())
    assert torch.equal(resident.n_orders, streamed.n_orders)
    # so is the first order from the host: it runs, returns I₁, and equals
    # the in-kernel one
    host = solve_batch_mega(*port, i1="host", device="cpu")
    assert torch.equal(host.n_orders, mega.n_orders) and host.i1 is not None
    assert_close_scaled(host.i_total.numpy(), mega.i_total.numpy(), rtol=1e-12,
                        atol_scale=1e-14)
    # a small-µ grid without the band-coverage grant (mega_supported false)
    # goes to the fused engine as a whole: a full solution with its i1
    small = JGrid(201, 48)
    port_small = port_inputs(jax_scenes(2), jax_tables(small), small, opts)
    by_fused = solve_batch_mega(*port_small, device="cpu")
    assert by_fused.i1 is not None and bool(by_fused.converged.all())
    # a batch whose thin τ leaves the small-µ columns uncovered does too
    thin = jax_scenes(3, tau_star_atm=0.01, tau_star_aer=0.005)
    port_thin = port_inputs(thin, jax_tables(small), small, opts)
    assert not mega_small_ok(port_thin[0], port_thin[2])
    assert not j_mega_small_ok(thin, small)
    got = solve_batch(*port_thin, engine="mega", device="cpu")
    ref = j_solve_batch(thin, jax_tables(small), small, opts)
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-9, atol_scale=1e-11)
    assert got.i1 is not None
    # the Mie models are ported: the tables equal the JAX package's
    from sos_rt_tpu.models import build_phase_tables as j_build

    for kind in ("mie", "lognormal", "eva", "wildfire"):
        kw = dict(indx=1.5, r=0.1, lambda0=0.55, n0=1.0, r_m=0.1, sig=1.2)
        for a, b in zip(build_phase_tables(kind, GRID.mu(), 0.5, cache=False, **kw),
                        j_build(kind, GRID.mu(), 0.5, cache=False, **kw)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.0)
    with pytest.raises(ValueError):
        solve_batch(*port, engine="other", device="cpu")
    with pytest.raises(ValueError):
        solve_batch_mega(*port, outputs="rows", device="cpu")


def test_solve_batch_parameters_bind_as_jax():
    """The port's solve_batch takes JAX's parameters in JAX's places up to
    ``sort`` (``shard_tables`` right after ``mesh``), then ``device``: a
    positional call binds the same names on both."""
    jax_params = list(inspect.signature(j_solve_batch).parameters)
    port_params = list(inspect.signature(solve_batch).parameters)
    assert jax_params[-1] == "sort"
    assert port_params == jax_params + ["device"]
    args = ("s", "t", "g", "o", None, False, 2)
    for fn in (j_solve_batch, solve_batch):
        bound = inspect.signature(fn).bind(*args).arguments
        assert bound["mesh"] is None and bound["shard_tables"] is False
        assert bound["buckets"] == 2


def test_options_carry_across():
    for o in (JOpts(), JOpts(surface="specular", dtype="float32", mm="bf16x5",
                              max_orders=7, tol=1e-5)):
        t = convert.options_from(o)
        assert (t.surface, t.max_orders, t.tol, t.dtype, t.scan_impl, t.mm) == (
            o.surface, o.max_orders, o.tol, o.dtype, o.scan_impl, o.mm)
    seq = convert.options_from(JOpts(scan_impl="sequential"))
    assert seq.scan_impl == "sequential" and SolverOptions().scan_impl == "associative"
    with pytest.raises(ValueError):
        dataclasses.replace(convert.options_from(JOpts()), mm="bf16x4")


def test_package_imports_no_jax():
    code = ("import pkgutil, sys, importlib, sos_rt_tpu_torch\n"
            "for m in pkgutil.walk_packages(sos_rt_tpu_torch.__path__, 'sos_rt_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'sos_rt_tpu' or m.startswith('sos_rt_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_package_sources_name_no_jax():
    pat = re.compile(r"\bjax\b|sos_rt_tpu\.")
    pkg = os.path.join(REPO, "sos_rt_tpu_torch")
    hits = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, f), encoding="utf-8") as fh:
                    hits += [f"{f}:{i}" for i, ln in enumerate(fh, 1) if pat.search(ln)]
    assert not hits, hits


def test_per_column_mu0_tables():
    """A µ0 sweep: P0 tables with a leading batch axis, one row per
    column (PhaseTables.from_models_batched_mu0), through sort and padding."""
    from sos_rt_tpu.models import build_phase_tables as j_build
    from sos_rt_tpu.solver import PhaseTables as JTables
    from sos_rt_tpu_torch.solver import PhaseTables

    mu0 = np.array([0.8, 0.4, 0.6])
    mu = GRID.mu()
    p0 = lambda kind, **kw: np.stack([j_build(kind, mu, m, cache=False, **kw)[0]
                                      for m in mu0])
    base = jax_tables(GRID)
    tables = JTables(p0_atm=jnp.asarray(p0("rayleigh")), p_atm=base.p_atm,
                     p0_aer=jnp.asarray(p0("hg", g=0.7)), p_aer=base.p_aer)
    scenes = jax_scenes(3, mu0=mu0)
    opts = JOpts(surface="lambertian", dtype="float64")
    ref = j_solve_batch(scenes, tables, GRID, opts)
    port = port_inputs(scenes, tables, GRID, opts)
    got = solve_batch(*port, engine="mega", cols_per_block=2, device="cpu")
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-9, atol_scale=1e-11)
    built = PhaseTables.from_models_batched_mu0(
        convert.grid_from(GRID), mu0, aer=("hg", {"g": 0.7}), device="cpu", cache=False)
    np.testing.assert_array_equal(built.p0_aer.numpy(), np.asarray(tables.p0_aer))
    np.testing.assert_array_equal(built.p_atm.numpy(), np.asarray(tables.p_atm))
