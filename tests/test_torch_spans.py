"""The port's program spans (``sos_rt_tpu_torch/spans.py``) on the CPU.

Under ``torch.profiler`` (CPU activity): a chunked ``run_sweep`` records
``sos.sweep.tables`` once, ``sos.sweep.solve`` and ``sos.sweep.shard``
once a chunk and ``sos.sweep.load`` once, and returns their seconds as
``stages_s``, and on a mesh one ``sos.mesh.gather`` a chunk and one
``sos.sweep.barrier``; the streamed mega solve and the fused engine record one
``sos.order`` an order of each block (the block's largest order count − 1)
and one ``sos.loop_cond`` more a block, and one ``sos.first_order`` a
block around passI; the streamed loop's gathers of a block's running
columns (``solve_block.compactions``) each record ``sos.order.compact``
inside ``sos.order``; the mega route's sort, predictor, preparation and
solve spans nest as their calls do; a phase-table build that the cache
does not answer records ``sos.tables.build`` and counts in
``build_phase_tables.builds``, a cached one counts in ``.cache_hits``.
Every result is the same to the bit with the profiler on and off.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sos_rt_tpu_torch import presets, spans
from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import predict_order_count, solve_batch_fused, solve_batch_mega
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.parallel import broadcast_scene
from sos_rt_tpu_torch.solver import PhaseTables
from sos_rt_tpu_torch.sweep import load_sweep, run_sweep

from torch_cases import world_of_one

GRID = GridSpec(24, 32)
SWEEP_STAGES = (spans.SWEEP_TABLES, spans.SWEEP_SOLVE, spans.SWEEP_SHARD, spans.SWEEP_LOAD)


def traced(fn):
    """(fn's result, {span name: [(start, end), ...]}) of one call under
    the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    found = {}
    for e in prof.events():
        if e.name.startswith("sos."):
            found.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out, found


def calls(found, name):
    return len(found.get(name, []))


@pytest.fixture(scope="module")
def inputs():
    tables = PhaseTables.from_models(GRID, 0.5, atm=("rayleigh", {}),
                                     aer=("hg", {"g": 0.7}), device="cpu")
    scenes = broadcast_scene(Scene(), 8, device="cpu").map(lambda x: x.clone())
    scenes.grd_alb[:] = torch.linspace(0.0, 0.9, 8, dtype=scenes.grd_alb.dtype)
    scenes.tau_star_aer[:] = torch.linspace(0.4, 0.02, 8, dtype=scenes.tau_star_aer.dtype)
    opts = SolverOptions(surface="lambertian", dtype="float64", max_orders=30)
    return scenes, tables, opts


@pytest.mark.parametrize("chunk", [4, 10])
def test_sweep_stages(tmp_path, chunk):
    p = dataclasses.replace(presets.PRESETS["fwc_sweep"], grid=GRID,
                            opts=SolverOptions(surface="lambertian", dtype="float32",
                                               max_orders=40))
    kw = dict(seed=1, mu0_pool=2, chunk=chunk, device="cpu", sort="score")
    n_chunks = -(-10 // chunk)
    m, found = traced(lambda: run_sweep(p, 10, out_dir=str(tmp_path / "on"), **kw))
    assert calls(found, spans.SWEEP_TABLES) == 1 and calls(found, spans.SWEEP_LOAD) == 1
    assert calls(found, spans.SWEEP_SOLVE) == calls(found, spans.SWEEP_SHARD) == n_chunks
    assert calls(found, spans.SWEEP_BARRIER) == 0 and calls(found, spans.MESH_GATHER) == 0
    assert sorted(m["stages_s"]) == sorted(SWEEP_STAGES)
    assert all(v > 0 for v in m["stages_s"].values())
    # the solve calls alone: wall_s is the solve stage's seconds
    assert m["wall_s"] == pytest.approx(m["stages_s"][spans.SWEEP_SOLVE], rel=0.05, abs=1e-3)
    off = run_sweep(p, 10, out_dir=str(tmp_path / "off"), **kw)
    assert sorted(off["stages_s"]) == sorted(SWEEP_STAGES)
    a, b = load_sweep(str(tmp_path / "on")), load_sweep(str(tmp_path / "off"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_mesh_sweep_spans(tmp_path):
    """On a world-size-1 gloo mesh: one gather a chunk, the closing
    barrier once, and the shards of the plain sweep sorted by the score."""
    p = dataclasses.replace(presets.PRESETS["fwc_sweep"], grid=GRID)
    kw = dict(seed=2, mu0_pool=2, chunk=4, device="cpu")
    with world_of_one() as mesh:
        m, found = traced(lambda: run_sweep(p, 8, out_dir=str(tmp_path / "mesh"),
                                            mesh=mesh, **kw))
    assert calls(found, spans.MESH_GATHER) == calls(found, spans.SWEEP_SOLVE) == 2
    assert calls(found, spans.SWEEP_BARRIER) == 1
    assert inside(found, spans.MESH_GATHER, spans.SWEEP_SOLVE)
    assert sorted(m["stages_s"]) == sorted(SWEEP_STAGES)
    run_sweep(p, 8, out_dir=str(tmp_path / "plain"), sort="score", **kw)
    a, b = load_sweep(str(tmp_path / "mesh")), load_sweep(str(tmp_path / "plain"))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_unchunked_sweep_stages():
    p = dataclasses.replace(presets.PRESETS["fwc_sweep"], grid=GRID)
    m = run_sweep(p, 6, mu0_pool=2, device="cpu", sort="score")
    assert sorted(m["stages_s"]) == [spans.SWEEP_SOLVE, spans.SWEEP_TABLES]


def block_orders(n_orders, block):
    """Σ over contiguous blocks of (the block's largest order count − 1)."""
    n = torch.as_tensor(n_orders)
    return sum(int(n[i:i + block].max()) - 1 for i in range(0, len(n), block))


@pytest.mark.parametrize("block", [2, 4, 8])
def test_streamed_order_spans(inputs, block):
    scenes, tables, opts = inputs
    solve = lambda: solve_batch_mega(scenes, tables, GRID, opts, cols_per_block=block,
                                     sort=False, stream=True, outputs="full", device="cpu")
    off = solve()
    ms.reset_launches()
    on, found = traced(solve)
    orders = block_orders(on.n_orders, block)
    assert len(set(on.n_orders.tolist())) > 1 and orders > 0
    assert calls(found, spans.ORDER) == orders
    assert calls(found, spans.LOOP_COND) == orders + 8 // block
    assert calls(found, spans.ORDER_COMPACT) == ms.solve_block.compactions > 0
    assert inside(found, spans.ORDER_COMPACT, spans.ORDER)
    assert calls(found, spans.MEGA_PREPARE) == calls(found, spans.MEGA_SOLVE) == 1
    assert calls(found, spans.MEGA_SORT) == 0
    for f in ("i_total", "n_orders", "converged"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_fused_order_spans(inputs):
    scenes, tables, opts = inputs
    solve = lambda: solve_batch_fused(scenes, tables, GRID, opts, device="cpu")
    off = solve()
    on, found = traced(solve)
    orders = int(on.n_orders.max()) - 1
    assert calls(found, spans.ORDER) == orders == calls(found, spans.SOURCE_JN)
    assert calls(found, spans.LOOP_COND) == orders + 1
    assert inside(found, spans.SOURCE_JN, spans.ORDER)
    for f in ("i_total", "i1", "n_orders", "converged"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def within(iv, outer):
    """Whether the interval ``iv`` lies inside one of ``outer``'s."""
    return any(a <= iv[0] and iv[1] <= b for a, b in outer)


def inside(found, inner, outer):
    return all(within(iv, found[outer]) for iv in found[inner])


@pytest.mark.parametrize("sort", ["score", "predict"])
def test_mega_route_spans(inputs, monkeypatch, sort):
    """The sort, with the predictor's coarse pre-solve inside it (its own
    preparation and resident solve nested in ``sos.mega.predict``), then the
    fine solve's preparation and loop."""
    import sos_rt_tpu_torch.fused as fused

    scenes, tables, opts = inputs
    monkeypatch.setattr(fused, "PREDICT_MIN_BATCH", 1)
    solve = lambda: solve_batch_mega(scenes, tables, GRID, opts, sort=sort,
                                     outputs="summary", device="cpu")
    off = solve()
    on, found = traced(solve)
    assert calls(found, spans.MEGA_SORT) == 1
    predicted = sort == "predict"
    assert calls(found, spans.MEGA_PREDICT) == predicted
    assert calls(found, spans.MEGA_PREPARE) == calls(found, spans.MEGA_SOLVE) == 1 + predicted
    if predicted:
        assert inside(found, spans.MEGA_PREDICT, spans.MEGA_SORT)
        nested = [within(iv, found[spans.MEGA_PREDICT]) for iv in found[spans.MEGA_PREPARE]]
        assert sorted(nested) == [False, True]
    for f in ("i_toa", "i_surface", "n_orders", "converged"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_predictor_span_only_where_it_predicts(inputs):
    scenes, tables, opts = inputs
    key, found = traced(lambda: predict_order_count(scenes, tables, GRID, opts,
                                                    min_batch=16, device="cpu"))
    assert key is None and calls(found, spans.MEGA_PREDICT) == 0
    key, found = traced(lambda: predict_order_count(scenes, tables, GRID, opts,
                                                    min_batch=1, device="cpu"))
    assert key.shape == (8,) and calls(found, spans.MEGA_PREDICT) == 1
    assert inside(found, spans.MEGA_SOLVE, spans.MEGA_PREDICT)


def test_span_adds_its_seconds_into():
    stages = {}
    for _ in range(2):
        with spans.span(spans.SWEEP_LOAD, into=stages):
            pass
    with pytest.raises(ValueError):
        with spans.span(spans.SWEEP_SHARD, into=stages):
            raise ValueError
    assert sorted(stages) == [spans.SWEEP_LOAD, spans.SWEEP_SHARD]
    assert all(v >= 0 for v in stages.values())


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
def test_first_order_span_once_a_block_around_passI(inputs, monkeypatch, surface):
    import sos_rt_tpu_torch.ops.megastream as ms
    from torch.profiler import record_function

    scenes, tables, opts = inputs
    opts = dataclasses.replace(opts, surface=surface)
    inner = ms.passI

    def passI(*a, **kw):
        with record_function("test.passI"):
            return inner(*a, **kw)

    monkeypatch.setattr(ms, "passI", passI)
    solve = lambda: solve_batch_mega(scenes, tables, GRID, opts, cols_per_block=4,
                                     sort=False, stream=True, outputs="summary", device="cpu")
    off = solve()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = solve()
    found = {}
    for e in prof.events():
        found.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert calls(found, spans.FIRST_ORDER) == calls(found, "test.passI") == 2
    assert inside(found, "test.passI", spans.FIRST_ORDER)
    assert not any(within(iv, found[spans.ORDER]) for iv in found[spans.FIRST_ORDER])
    for f in ("i_toa", "i_surface", "n_orders", "converged"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_tables_build_span_and_counters(tmp_path, monkeypatch):
    """A cold build records ``sos.tables.build`` and counts a build; the
    same tables again come from the cache, record no span and count a hit;
    all three are the same bits."""
    from sos_rt_tpu_torch.models import build_phase_tables

    monkeypatch.setenv("SOS_RT_CACHE_DIR", str(tmp_path))
    mu = GRID.mu()
    build = lambda **kw: build_phase_tables("hg", mu, 0.5, g=0.7, **kw)
    builds, hits = build_phase_tables.builds, build_phase_tables.cache_hits
    cold, found = traced(build)
    assert calls(found, spans.TABLES_BUILD) == 1
    assert (build_phase_tables.builds, build_phase_tables.cache_hits) == (builds + 1, hits)
    cached, found = traced(build)
    assert calls(found, spans.TABLES_BUILD) == 0
    assert (build_phase_tables.builds, build_phase_tables.cache_hits) == (builds + 1, hits + 1)
    uncached = build(cache=False)
    assert (build_phase_tables.builds, build_phase_tables.cache_hits) == (builds + 2, hits + 1)
    for a, b in ((cold, cached), (cold, uncached)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
