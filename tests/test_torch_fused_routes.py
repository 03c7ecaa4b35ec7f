"""How batches reach the port's fused engine.

``solve_batch(engine='mega')`` on a batch for which ``mega_small_ok`` is
false, and ``solve_batch_mega`` on a grid for which ``mega_supported`` is
false, hand the whole batch to the fused engine, as the JAX package does,
and reduce it to the summary rows where those were asked for; the calls of
the sweep wrappers and of the mega kernels show the route.  Also: buckets,
the outputs check, and the ``sweep --engine fused`` command, whose shards
both packages' ``load_sweep`` read.  All on the CPU, float64.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.sweep import load_sweep as j_load_sweep
from sos_rt_tpu_torch import fused, presets
from sos_rt_tpu_torch.cli import main
from sos_rt_tpu_torch.config import GridSpec, SolverOptions
from sos_rt_tpu_torch.fused import solve_batch_fused, solve_batch_mega
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.parallel import solve_batch
from sos_rt_tpu_torch.parallel.mesh import mega_small_ok
from sos_rt_tpu_torch.sweep import load_sweep, run_sweep

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GAUSS = JGrid(51, 24, spacing="gauss")


@pytest.fixture(scope="module")
def gauss():
    """A batch the mega path cannot take, and its fused solution."""
    opts = JOpts(surface="lambertian", dtype="float64")
    port = port_inputs(jax_scenes(3), jax_tables(GAUSS), GAUSS, opts)
    assert not mega_small_ok(port[0], port[2])
    return port, solve_batch_fused(*port, device="cpu")


@pytest.fixture
def calls(monkeypatch):
    """Counts of the calls the two engines make to their kernels' wrappers
    (on CPU tensors a wrapper launches nothing, so its own count stays 0)."""
    n = {"down_sweep": 0, "up_sweep_smooth": 0, "mega": 0}

    def spy(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)

    spy(fused, "down_sweep", "down_sweep")
    spy(fused, "up_sweep_smooth", "up_sweep_smooth")
    spy(mk, "mega_call", "mega")
    spy(ms, "stream_order_loop", "mega")
    return n


@pytest.mark.parametrize("outputs", ["full", "summary"])
def test_mega_engine_hands_an_uncovered_batch_to_fused(gauss, calls, outputs):
    port, want = gauss
    got = solve_batch(*port, engine="mega", outputs=outputs, sort="predict",
                      device="cpu")
    orders = int(want.n_orders.max())
    assert calls == {"down_sweep": orders - 1, "up_sweep_smooth": orders - 1, "mega": 0}
    assert torch.equal(got.n_orders, want.n_orders)
    assert torch.equal(got.converged, want.converged)
    if outputs == "summary":
        assert isinstance(got, fused.SweepSummary)
        assert torch.equal(got.i_toa, want.i_total[:, 0])
        assert torch.equal(got.i_surface, want.i_total[:, -1])
    else:
        assert isinstance(got, fused.Solution)
        assert torch.equal(got.i_total, want.i_total) and torch.equal(got.i1, want.i1)
    assert all(k.launches == 0 for k in ms.ALL_KERNELS)


def test_covered_batch_stays_on_the_mega_path(calls):
    grid = JGrid(56, 64)
    port = port_inputs(jax_scenes(2), jax_tables(grid), grid,
                       JOpts(surface="lambertian", dtype="float64"))
    sol = solve_batch(*port, engine="mega", device="cpu")
    assert bool(sol.converged.all()) and sol.i1 is None
    assert calls["mega"] == 1 and calls["down_sweep"] == calls["up_sweep_smooth"] == 0


def test_solve_batch_mega_without_the_grant_runs_fused(calls):
    """A small-µ grid without allow_small (mega_supported false)."""
    small = JGrid(201, 16)
    port = port_inputs(jax_scenes(2), jax_tables(small), small,
                       JOpts(surface="specular", dtype="float64"))
    want = solve_batch_fused(*port, device="cpu")
    before = dict(calls)
    got = solve_batch_mega(*port, outputs="summary", device="cpu")
    assert calls["mega"] == 0 and calls["down_sweep"] > before["down_sweep"]
    assert torch.equal(got.i_toa, want.i_total[:, 0])
    assert torch.equal(got.n_orders, want.n_orders)
    # with the grant the same batch runs the mega path and agrees
    mega = solve_batch_mega(*port, outputs="summary", allow_small=True, device="cpu")
    assert calls["mega"] == 1
    assert torch.equal(mega.n_orders, want.n_orders)
    assert_close_scaled(mega.i_toa.numpy(), got.i_toa.numpy(), rtol=1e-9,
                        atol_scale=1e-11)


@pytest.mark.parametrize("engine", ["fused", "mega"])
def test_buckets_match_single_solve(gauss, engine):
    opts = JOpts(surface="lambertian", dtype="float64")
    port = port_inputs(jax_scenes(4), jax_tables(GAUSS), GAUSS, opts)
    one = solve_batch(*port, engine=engine, device="cpu")
    two = solve_batch(*port, engine=engine, buckets=2, block_b=2, device="cpu")
    assert torch.equal(one.n_orders, two.n_orders)
    assert_close_scaled(two.i_total.numpy(), one.i_total.numpy(), rtol=1e-13,
                        atol_scale=1e-15)
    assert_close_scaled(two.i1.numpy(), one.i1.numpy(), rtol=1e-13, atol_scale=1e-15)
    with pytest.raises(ValueError, match="divisible"):
        solve_batch(*port, engine=engine, buckets=3, device="cpu")


def test_summary_outputs_need_the_mega_engine(gauss):
    port, _ = gauss
    with pytest.raises(ValueError, match="requires engine='mega'"):
        solve_batch(*port, engine="fused", outputs="summary", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        solve_batch(*port, engine="fusion", device="cpu")


def test_columns_do_not_depend_on_the_batch(gauss):
    port, want = gauss
    scenes, tables, grid, opts = port
    one = solve_batch_fused(scenes.map(lambda x: x[2:3]), tables, grid, opts,
                            device="cpu")
    assert int(one.n_orders[0]) == int(want.n_orders[2])
    assert_close_scaled(one.i_total[0].numpy(), want.i_total[2].numpy(), rtol=1e-12,
                        atol_scale=1e-14)


@pytest.fixture
def small_preset(monkeypatch):
    p = dataclasses.replace(
        presets.PRESETS["fwc_sweep"], grid=GridSpec(nb_angles=32, nb_layers=20),
        opts=SolverOptions(surface="lambertian", dtype="float64"))
    monkeypatch.setitem(presets.PRESETS, "fwc_sweep", p)
    return p


def test_sweep_cmd_fused_engine(small_preset, tmp_path, capsys, calls):
    out = str(tmp_path / "fused")
    main(["sweep", "--engine", "fused", "--batch", "6", "--chunk", "4", "--mu0-pool",
          "2", "--seed", "1", "--device", "cpu", "-o", out])
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sweep_metrics"]
    assert m["engine"] == "fused" and m["outputs"] == "full"
    assert m["n_chunks"] == 2 and m["complete"] and m["batch"] == 6
    assert m["n_unconverged"] == 0
    assert calls["mega"] == 0 and calls["down_sweep"] == calls["up_sweep_smooth"] > 0
    res, jres = load_sweep(out), j_load_sweep(out)
    assert sorted(res) == ["converged", "i_surface", "i_toa", "n_orders"]
    for k in res:
        np.testing.assert_array_equal(res[k], jres[k])
    assert res["i_toa"].shape == (6, 64) and np.isfinite(res["i_toa"]).all()
    # the shards hold the reduced rows of the mega engine's sweep of the batch
    mega = run_sweep(small_preset, 6, seed=1, mu0_pool=2, chunk=4,
                     out_dir=str(tmp_path / "mega"), device="cpu")
    assert mega["complete"] and mega["engine"] == "mega"
    ref = load_sweep(str(tmp_path / "mega"))
    np.testing.assert_array_equal(res["n_orders"], ref["n_orders"])
    for k in ("i_toa", "i_surface"):
        assert_close_scaled(res[k], ref[k], rtol=1e-9, atol_scale=1e-11)
