"""The port's resident whole-loop solve against the JAX package.

``sos_rt_tpu_torch.fused.solve_batch_mega(stream=False)`` — on the CPU the
plain version ``mega_plain`` of the resident kernel, tile by tile —
against ``sos_rt_tpu.fused.solve_batch_mega(stream=False, interpret=True)``
(the Pallas ``_mega_kernel`` in interpreter mode, about 20 s a case) at
GridSpec(56, 64), B=4, ``cols_per_block=2``, float64: equal order counts
and flags, rtol 1e-12 with a floor of 1e-14 of scale (the two run the same
arithmetic, with the products summed in another order), for both
surfaces, full and summary outputs, after 1 and 2 orders and to
convergence.  Against ``solve_batch(engine='reference')``: rtol 1e-9.  In
float32 bf16x3: the JAX resident engine's order counts, rows within rtol
1e-4.  In the port: resident equals streamed per column whatever the tile
size; ``stream=None`` picks by grid; the predict-sort key clamps its
score.
"""
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu.parallel import solve_batch as j_solve_batch
from sos_rt_tpu_torch import convert, fused
from sos_rt_tpu_torch.fused import prepare_batch, resolve_stream, solve_batch_mega
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.ops import megastream as ms

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(56, 64)
# (surface, max_orders, outputs) run through the JAX resident kernel
JAX_CASES = [("lambertian", 100, "full"), ("specular", 100, "summary"),
             ("lambertian", 1, "summary"), ("specular", 2, "full")]


@pytest.fixture(scope="module")
def tables():
    return jax_tables(GRID)


def _rows(sol, outputs):
    if outputs == "summary":
        return sol.i_toa, sol.i_surface
    return (sol.i_total,)


@pytest.fixture(scope="module", params=JAX_CASES,
                ids=[f"{s}-{n}-{o}" for s, n, o in JAX_CASES])
def pair(request, tables):
    surface, max_orders, outputs = request.param
    opts = JOpts(surface=surface, dtype="float64", max_orders=max_orders)
    scenes = jax_scenes(4)
    ref = j_solve_mega(scenes, tables, GRID, opts, cols_per_block=2,
                       interpret=True, stream=False, outputs=outputs)
    ms.reset_launches()
    got = solve_batch_mega(*port_inputs(scenes, tables, GRID, opts),
                           cols_per_block=2, outputs=outputs, stream=False,
                           device="cpu")
    return ref, got, max_orders, outputs


def test_resident_matches_jax_resident(pair):
    ref, got, max_orders, outputs = pair
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    if max_orders < 100:
        assert int(got.n_orders.max()) == max_orders
        assert not bool(got.converged.any())
    else:
        assert bool(got.converged.all())
    for g, r in zip(_rows(got, outputs), _rows(ref, outputs)):
        assert g.shape == r.shape
        assert_close_scaled(g.numpy(), r, rtol=1e-12, atol_scale=1e-14)
    np.testing.assert_array_equal(got.tau.numpy(), np.asarray(ref.tau))


def test_cpu_runs_mega_plain_without_launches(pair):
    assert [k.launches for k in ms.ALL_KERNELS] == [0] * len(ms.ALL_KERNELS)
    assert mk.mega_call in ms.ALL_KERNELS and set(ms.KERNELS) <= set(ms.ALL_KERNELS)


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
def test_resident_matches_reference_engine(tables, surface):
    opts = JOpts(surface=surface, dtype="float64")
    scenes = jax_scenes(4)
    ref = j_solve_batch(scenes, tables, GRID, opts)
    got = solve_batch_mega(*port_inputs(scenes, tables, GRID, opts),
                           cols_per_block=2, stream=False, device="cpu")
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert bool(got.converged.all())
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-9, atol_scale=1e-11)


def test_float32_order_counts_match_jax_resident(tables):
    """float32 bf16x3 against the JAX resident engine in float32: the same
    split products, summed in another order."""
    opts = JOpts(surface="lambertian", dtype="float32")
    scenes = jax_scenes(4)
    ref = j_solve_mega(scenes, tables, GRID, opts, cols_per_block=2,
                       interpret=True, stream=False, outputs="summary")
    got = solve_batch_mega(*port_inputs(scenes, tables, GRID, opts),
                           cols_per_block=2, outputs="summary", stream=False,
                           device="cpu")
    assert got.i_toa.dtype == torch.float32
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert_close_scaled(got.i_toa.numpy(), ref.i_toa, rtol=1e-4, atol_scale=1e-6)
    assert_close_scaled(got.i_surface.numpy(), ref.i_surface, rtol=1e-4, atol_scale=1e-6)


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("outputs", ["summary", "full"])
def test_resident_equals_streamed_whatever_the_tile(tables, surface, outputs):
    """Per column the resident solve equals the streamed one (the same
    plain passes, the same gating), for any tile size and a ragged batch."""
    opts = JOpts(surface=surface, dtype="float64")
    port = port_inputs(jax_scenes(5), tables, GRID, opts)
    want = solve_batch_mega(*port, cols_per_block=2, outputs=outputs, stream=True,
                            device="cpu")
    for cpb in (1, 2, 4, None):
        got = solve_batch_mega(*port, cols_per_block=cpb, outputs=outputs,
                               stream=False, device="cpu")
        assert torch.equal(got.n_orders, want.n_orders), cpb
        assert torch.equal(got.converged, want.converged), cpb
        for g, w in zip(_rows(got, outputs), _rows(want, outputs)):
            assert_close_scaled(g.numpy(), w.numpy(), rtol=1e-13, atol_scale=1e-15)


def test_mega_plain_shares_one_loop_but_gates_per_column(tables):
    """mega_plain on the whole batch (one shared loop) and mega_call tile
    by tile give each column the same rows, order count and flag."""
    opts = JOpts(surface="lambertian", dtype="float64")
    scenes, tbl, grid, o = port_inputs(jax_scenes(4), tables, GRID, opts)
    sb = prepare_batch(fused.scene_on(scenes, "cpu"), tbl, grid, o,
                       cols_per_block=4, device=torch.device("cpu"))
    kw = dict(tol=o.tol, max_orders=o.max_orders, full=False)
    whole = mk.mega_plain(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    tiled = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, cols_per_tile=1, **kw)
    assert len(whole) == len(tiled) == 5
    assert whole[-1].shape == (3, 4)
    assert torch.equal(whole[-1][mk.ST_N], tiled[-1][mk.ST_N])
    assert len(set(whole[-1][mk.ST_N].tolist())) > 1     # columns stop apart
    for w, t in zip(whole, tiled):
        assert_close_scaled(t.numpy(), w.numpy(), rtol=1e-13, atol_scale=1e-15)
    with pytest.raises(ValueError, match="multiple"):
        mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, cols_per_tile=3, **kw)


def test_stream_none_picks_by_grid():
    """The rule only: resident where a column's four planes fit the budget."""
    from sos_rt_tpu_torch.config import GridSpec

    sweep, canon = GridSpec(64, 128), GridSpec(501, 800)
    for dtype in (torch.float32, torch.float64):
        assert resolve_stream(None, sweep, dtype) is False
        assert resolve_stream(None, canon, dtype) is True
        assert resolve_stream(True, sweep, dtype) is True
        assert resolve_stream(False, canon, dtype) is False
    assert 4 * 128 * 64 * 8 == fused.RESIDENT_COLUMN_BUDGET
    assert resolve_stream(None, GridSpec(64, 129), torch.float64) is True
    assert resolve_stream(None, GridSpec(64, 129), torch.float32) is False
    assert mk.default_cols_per_tile(64) == 4
    assert mk.default_cols_per_tile(8) == 8
    assert mk.default_cols_per_tile(504) == 1


def test_host_first_order_still_raises(tables):
    """The first order from the host is ported (it used to raise): the
    resident execution runs it, and it equals the in-kernel first order;
    an unknown mode still raises."""
    opts = JOpts(surface="lambertian", dtype="float64")
    port = port_inputs(jax_scenes(2), tables, GRID, opts)
    host = solve_batch_mega(*port, stream=False, i1="host", device="cpu")
    kern = solve_batch_mega(*port, stream=False, device="cpu")
    assert torch.equal(host.n_orders, kern.n_orders) and host.i1 is not None
    assert_close_scaled(host.i_total.numpy(), kern.i_total.numpy(), rtol=1e-12,
                        atol_scale=1e-14)
    with pytest.raises(ValueError, match="i1 mode"):
        solve_batch_mega(*port, stream=False, i1="device", device="cpu")


def test_predict_sort_key_clamps_the_score(tables, monkeypatch):
    """count·1024 + min(score, 1023): a huge score (thick column) must not
    outrank the next predicted count."""
    opts = JOpts(surface="lambertian", dtype="float64")
    scenes, tbl, grid, o = port_inputs(
        jax_scenes(3, tau_star_aer=np.array([0.1, 5000.0, 0.1])), tables, GRID, opts)
    scenes = fused.scene_on(scenes, "cpu")
    counts = torch.tensor([3, 3, 4], dtype=torch.int32)
    monkeypatch.setattr(fused, "predict_order_count", lambda *a, **k: counts)
    key = fused.sort_key(scenes, tbl, grid, o, "predict", torch.device("cpu"))
    assert key[1] == 3 * 1024.0 + 1023.0
    assert torch.argsort(key, stable=True).tolist() == [0, 1, 2]
    # without a prediction the key is the raw score
    monkeypatch.setattr(fused, "predict_order_count", lambda *a, **k: None)
    raw = fused.sort_key(scenes, tbl, grid, o, "predict", torch.device("cpu"))
    assert float(raw[1]) > 1023.0
    assert convert.grid_from(GRID) == grid
