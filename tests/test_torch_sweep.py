"""The port's sweep entry point (sweep.py, cli.py) against the JAX package.

On the CPU (``device='cpu'``: the plain versions of the kernels) on a
small patched ``fwc_sweep`` preset: chunked shards that
``sos_rt_tpu.sweep.load_sweep`` reads, kill-and-resume, the spec check,
per-column µ0 tables; the port's batch carried to the JAX package as numpy
and solved there by ``solve_batch(engine='mega')`` in float64 gives the
same rows (rtol 1e-9, the engines' contract); ``save_orders`` shards equal
the JAX package's; and the ``sweep`` / ``list`` commands of ``python -m
sos_rt_tpu_torch``, with ``--mesh`` on a world-size-1 gloo mesh.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, Scene as JScene, SolverOptions as JOpts
from sos_rt_tpu.parallel import solve_batch as j_solve_batch
from sos_rt_tpu.solver import PhaseTables as JTables
from sos_rt_tpu.sweep import load_sweep as j_load_sweep
from sos_rt_tpu_torch import metrics, presets
from sos_rt_tpu_torch.cli import main
from sos_rt_tpu_torch.config import SCENE_FIELDS, GridSpec, SolverOptions
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.parallel import solve_batch
from sos_rt_tpu_torch.sweep import build_sweep_batch, load_sweep, run_sweep

from torch_cases import assert_close_scaled, world_of_one


def _small(dtype="float32", grid=GridSpec(nb_angles=32, nb_layers=48)):
    return dataclasses.replace(
        presets.PRESETS["fwc_sweep"], grid=grid,
        opts=SolverOptions(surface="lambertian", dtype=dtype, max_orders=40))


@pytest.fixture
def small(monkeypatch):
    p = _small()
    monkeypatch.setitem(presets.PRESETS, "fwc_sweep", p)
    return p


def test_build_sweep_batch_ranges_and_pool(small):
    scenes, tables = build_sweep_batch(small, 64, seed=3, mu0_pool=4, device="cpu")
    again, _ = build_sweep_batch(small, 64, seed=3, mu0_pool=4, device="cpu")
    other, _ = build_sweep_batch(small, 64, seed=4, mu0_pool=4, device="cpu")
    for f, lo, hi in (("grd_alb", 0.0, 0.9), ("tau_star_aer", 0.01, 0.4),
                      ("alb_aer", 0.7, 1.0)):
        v = getattr(scenes, f)
        assert v.shape == (64,) and v.dtype == torch.float64
        assert float(v.min()) >= lo and float(v.max()) < hi
        assert torch.equal(v, getattr(again, f))
        assert not torch.equal(v, getattr(other, f))
    pool = torch.as_tensor(np.linspace(0.2, 0.95, 4)).float().double()
    assert set(scenes.mu0.tolist()) <= set(pool.tolist())
    assert len(set(scenes.mu0.tolist())) == 4
    assert tables.p0_atm.shape == (64, 64) and tables.p0_atm.dtype == torch.float32
    assert tables.p_aer.shape == (64, 64)
    # one P0 row per column, gathered by that column's µ0
    same = scenes.mu0 == scenes.mu0[0]
    assert bool((tables.p0_aer[same] == tables.p0_aer[0]).all())
    assert not bool((tables.p0_aer[~same] == tables.p0_aer[0]).all())
    fixed, t1 = build_sweep_batch(small, 8, mu0_pool=0, device="cpu")
    assert t1.p0_atm.shape == (64,) and float(fixed.mu0[0]) == 0.5


def test_chunked_sweep_resume_and_spec_check(small, tmp_path):
    out = str(tmp_path / "sweep")
    logs = []
    kw = dict(seed=1, mu0_pool=2, chunk=4, out_dir=out, device="cpu", log=logs.append)
    part = run_sweep(small, 10, stop_after_chunks=1, **kw)      # "killed" after one
    assert part == {"engine": "mega", "outputs": "summary", "n_chunks": 3,
                    "n_completed": 1, "complete": False, "n_devices": 1,
                    "shard_threads": len(os.sched_getaffinity(0)), "shard_blocks": 4,
                    "wall_s": part["wall_s"], "col_per_s": part["col_per_s"],
                    "stages_s": part["stages_s"]}
    with pytest.raises(ValueError, match="incomplete"):
        load_sweep(out)
    first = os.path.getmtime(os.path.join(out, "shard_00000.npz"))
    m = run_sweep(small, 10, resume=True, **kw)
    assert m["complete"] and m["n_completed"] == 3 and m["batch"] == 10
    assert m["n_converged"] == 10 and m["n_unconverged"] == 0
    assert os.path.getmtime(os.path.join(out, "shard_00000.npz")) == first
    assert any("resuming: 1 shard" in ln for ln in logs)
    assert sorted(os.listdir(out)) == ["index.json", "shard_00000.npz",
                                       "shard_00001.npz", "shard_00002.npz"]
    # both packages read the directory; the last shard holds the short chunk
    res, jres = load_sweep(out), j_load_sweep(out)
    assert sorted(res) == ["converged", "i_surface", "i_toa", "n_orders"]
    for k in res:
        np.testing.assert_array_equal(res[k], jres[k])
    assert res["i_toa"].shape == (10, 64) and res["i_toa"].dtype == np.float32
    assert res["n_orders"].dtype == np.int32 and res["converged"].dtype == np.bool_
    with np.load(os.path.join(out, "shard_00002.npz")) as z:
        assert z["n_orders"].shape == (2,)
    # a resumed complete sweep solves nothing and reports no rate
    again = run_sweep(small, 10, resume=True, **kw)
    assert again["complete"] and "wall_s" not in again
    # the chunked rows equal one solve of the whole batch
    scenes, tables = build_sweep_batch(small, 10, seed=1, mu0_pool=2, device="cpu")
    whole = solve_batch(scenes, tables, small.grid, small.opts, engine="mega",
                        outputs="summary", sort="predict", device="cpu")
    np.testing.assert_array_equal(res["n_orders"], whole.n_orders.numpy())
    np.testing.assert_array_equal(res["i_toa"], whole.i_toa.numpy())
    # index layout of the TPU package
    with open(os.path.join(out, "index.json")) as f:
        index = json.load(f)
    assert index["n_chunks"] == 3 and index["completed"] == [0, 1, 2]
    assert index["spec"]["grid"] == {"nb_angles": 32, "nb_layers": 48,
                                     "spacing": "uniform"}
    assert index["spec"]["save_orders"] is False
    # a changed preset under the same name must not resume into the directory
    for changed in (_small(grid=GridSpec(nb_angles=32, nb_layers=40)),
                    _small(dtype="float64")):
        with pytest.raises(ValueError, match="spec mismatch"):
            run_sweep(changed, 10, resume=True, **kw)
    with pytest.raises(ValueError, match="spec mismatch"):
        run_sweep(small, 10, resume=True, **{**kw, "seed": 2})


def test_unchunked_sweep_returns_metrics(small):
    m = run_sweep(small, 6, mu0_pool=2, device="cpu", sort="score")
    assert m["batch"] == 6 and m["engine"] == "mega" and m["outputs"] == "summary"
    assert m["n_converged"] == 6 and m["col_per_s"] > 0 and m["n_devices"] == 1
    full = run_sweep(small, 3, outputs="full", device="cpu")
    assert full["outputs"] == "full" and full["orders_max"] >= 2


def test_routes_of_the_sweep_not_ported_yet(small, tmp_path):
    """The sweep's mesh routes, which raised until the mesh was ported: on a
    world-size-1 gloo mesh ``run_sweep`` reports ``n_devices`` equal to the
    mesh's size and equals the unmeshed sweep sorted by the score, chunked
    or not; ``save_orders`` with a mesh solves unsharded and writes the same
    shards; anything but a DeviceMesh is refused."""
    with world_of_one() as mesh:
        m = run_sweep(small, 4, mu0_pool=2, mesh=mesh, device="cpu")
        assert m["n_devices"] == mesh.size() == 1 and m["n_converged"] == 4
        for name, kw in (("mesh", dict(mesh=mesh)), ("plain", dict(sort="score")),
                         ("orders_mesh", dict(mesh=mesh, save_orders=True)),
                         ("orders", dict(save_orders=True))):
            m = run_sweep(small, 4, mu0_pool=2, chunk=2, out_dir=str(tmp_path / name),
                          device="cpu", **kw)
            assert m["complete"] and m["n_devices"] == 1
    for a, b in (("mesh", "plain"), ("orders_mesh", "orders")):
        got, want = load_sweep(str(tmp_path / a)), load_sweep(str(tmp_path / b))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises((TypeError, ValueError), match="DeviceMesh"):
        run_sweep(small, 4, mesh=object(), device="cpu")
    with pytest.raises((TypeError, ValueError), match="DeviceMesh"):
        run_sweep(small, 4, chunk=2, out_dir=str(tmp_path / "o"), save_orders=True,
                  mesh=object(), device="cpu")
    # save_orders writes its arrays only to shards, as in the TPU package
    for kw in (dict(), dict(chunk=2), dict(out_dir=str(tmp_path / "o"))):
        with pytest.raises(ValueError, match="save_orders"):
            run_sweep(small, 4, save_orders=True, device="cpu", **kw)
    assert not os.path.exists(tmp_path / "o")


def test_save_orders_shards_equal_jax(tmp_path):
    """save_orders: the per-order TOA/surface rows and their validity in the
    shards equal the JAX package's solve_batch_orders of the same batch
    (carried across as numpy), chunk by chunk, the short last chunk too."""
    from sos_rt_tpu.solver import solve_batch_orders as j_solve_batch_orders

    p = dataclasses.replace(_small(dtype="float64"),
                            opts=SolverOptions(dtype="float64", max_orders=12))
    out = str(tmp_path / "orders")
    m = run_sweep(p, 5, seed=4, mu0_pool=2, chunk=3, out_dir=out, save_orders=True,
                  engine="mega", device="cpu")
    assert m["engine"] == "orders" and m["complete"] and m["batch"] == 5
    with open(os.path.join(out, "index.json")) as f:
        assert json.load(f)["spec"]["save_orders"] is True
    res, jres = load_sweep(out), j_load_sweep(out)
    assert sorted(res) == ["converged", "i_surface", "i_toa", "n_orders", "order_valid",
                           "orders_surface", "orders_toa"]
    for k in res:
        np.testing.assert_array_equal(res[k], jres[k])
    assert res["orders_toa"].shape == (5, 12, 64) and res["order_valid"].shape == (5, 12)
    scenes, tables = build_sweep_batch(p, 5, seed=4, mu0_pool=2, device="cpu")
    jscenes = JScene(**{f: jnp.asarray(getattr(scenes, f).numpy()) for f in SCENE_FIELDS})
    jtables = JTables(*(jnp.asarray(getattr(tables, f.name).numpy())
                        for f in dataclasses.fields(tables)))
    sol, orders, valid = j_solve_batch_orders(
        jscenes, jtables, JGrid(32, 48), JOpts(surface="lambertian", dtype="float64",
                                               max_orders=12))
    np.testing.assert_array_equal(res["order_valid"], np.asarray(valid))
    np.testing.assert_array_equal(res["n_orders"], np.asarray(sol.n_orders))
    np.testing.assert_array_equal(res["converged"], np.asarray(sol.converged))
    for k, r in (("orders_toa", 0), ("orders_surface", 1)):
        assert_close_scaled(res[k], np.asarray(orders)[:, :, r], rtol=1e-9, atol_scale=1e-11)
    assert_close_scaled(res["i_toa"], np.asarray(sol.i_total)[:, 0], rtol=1e-9,
                        atol_scale=1e-11)
    # the per-order rows add up to the total rows
    np.testing.assert_allclose(res["orders_toa"].sum(1), res["i_toa"], rtol=1e-10,
                               atol=1e-13)


def test_sweep_cmd_save_orders_and_reference_engine(small, tmp_path, capsys):
    out = str(tmp_path / "o")
    main(["sweep", "--batch", "4", "--chunk", "2", "--mu0-pool", "2", "--save-orders",
          "--device", "cpu", "-o", out])
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sweep_metrics"]
    assert m["engine"] == "orders" and m["n_chunks"] == 2 and m["complete"]
    res = load_sweep(out)
    assert res["orders_toa"].shape == (4, 40, 64) and res["order_valid"][:, 0].all()
    np.testing.assert_array_equal(res["order_valid"].sum(1), res["n_orders"])
    # the reference engine through the command, full outputs
    ref = str(tmp_path / "r")
    main(["sweep", "--batch", "4", "--mu0-pool", "2", "--engine", "reference",
          "--device", "cpu", "-o", ref])
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sweep_metrics"]
    assert m["engine"] == "reference" and m["outputs"] == "full" and m["complete"]
    rows = load_sweep(ref)
    np.testing.assert_array_equal(rows["n_orders"], res["n_orders"])
    np.testing.assert_allclose(rows["i_toa"], res["i_toa"], rtol=1e-5, atol=1e-7)


def test_block_until_ready_returns_the_solution(small):
    scenes, tables = build_sweep_batch(small, 2, device="cpu")
    sol = solve_batch(scenes, tables, small.grid, small.opts, engine="mega",
                      outputs="summary", block_b=16, device="cpu")
    assert metrics.block_until_ready(sol) is sol


def test_sweep_batch_solved_by_the_jax_package():
    """The port's own sweep batch (per-column µ0 tables), carried across as
    numpy, through the JAX mega engine (Pallas interpreter) in float64."""
    p = _small(dtype="float64")
    scenes, tables = build_sweep_batch(p, 4, seed=5, mu0_pool=3, device="cpu")
    got = solve_batch(scenes, tables, p.grid, p.opts, engine="mega", outputs="summary",
                      cols_per_block=2, device="cpu")
    jscenes = JScene(**{f: jnp.asarray(getattr(scenes, f).numpy()) for f in SCENE_FIELDS})
    jtables = JTables(*(jnp.asarray(getattr(tables, f.name).numpy())
                        for f in dataclasses.fields(tables)))
    ref = j_solve_batch(jscenes, jtables, JGrid(32, 48),
                        JOpts(surface="lambertian", dtype="float64", max_orders=40),
                        engine="mega", outputs="summary", cols_per_block=2)
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert_close_scaled(got.i_toa.numpy(), ref.i_toa, rtol=1e-9, atol_scale=1e-11)
    assert_close_scaled(got.i_surface.numpy(), ref.i_surface, rtol=1e-9, atol_scale=1e-11)
    assert tables.p0_atm.shape == (4, 64) and len(set(scenes.mu0.tolist())) > 1


def test_sweep_cmd_mega_engine(small, tmp_path, monkeypatch, capsys):
    """The headline path through the CLI: mega engine + summary outputs,
    one shard for --output without --chunk, then --resume."""
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "megadir")
    argv = ["sweep", "--preset", "fwc_sweep", "--batch", "8", "--mu0-pool", "2",
            "--device", "cpu", "-o", out, "--metrics", str(tmp_path / "m.json")]
    mk.mega_call.launches = 0
    main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = j_load_sweep(out)
    assert res["i_toa"].shape == (8, 64)
    assert np.isfinite(res["i_toa"]).all() and np.isfinite(res["i_surface"]).all()
    assert res["converged"].all()
    with open(tmp_path / "m.json") as f:
        m = json.load(f)
    assert m == line["sweep_metrics"]
    assert m["engine"] == "mega" and m["outputs"] == "summary"
    assert m["batch"] == 8 and m["n_chunks"] == 1 and m["complete"]
    assert m["preset"] == "fwc_sweep" and m["batch_requested"] == 8
    assert mk.mega_call.launches == 0            # CPU tensors: the plain version
    main(argv + ["--resume"])
    m2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sweep_metrics"]
    assert m2["complete"] and m2["n_completed"] == 1 and "col_per_s" not in m2


def test_sweep_cmd_chunks_and_overrides(small, tmp_path, capsys):
    out = str(tmp_path / "chunks")
    main(["sweep", "--batch", "6", "--chunk", "4", "--mu0-pool", "0", "--dtype",
          "float64", "--sort", "score", "--seed", "2", "--device", "cpu", "-o", out])
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sweep_metrics"]
    assert m["n_chunks"] == 2 and m["batch"] == 6
    res = load_sweep(out)
    assert res["i_toa"].dtype == np.float64 and res["i_toa"].shape == (6, 64)
    with open(os.path.join(out, "index.json")) as f:
        spec = json.load(f)["spec"]
    assert spec["opts"]["dtype"] == "float64" and spec["mu0_pool"] == 0
    assert spec["seed"] == 2 and spec["chunk"] == 4


def test_list_cmd(capsys):
    main(["list"])
    out = capsys.readouterr().out
    assert "eva" in out and "rayleigh" in out and "fwc_sweep" in out
    assert "fwc" in out.split("phase models:")[1]


@pytest.mark.parametrize("argv,what", [
    (["sweep", "--mesh", "--batch", "4", "--mu0-pool", "2", "--device", "cpu"], "mesh"),
    (["sweep", "--engine", "reference", "--mesh", "--batch", "4", "--device", "cpu"],
     "mesh"),
])
def test_commands_not_ported_exit_with_the_message(small, argv, what, capsys,
                                                   tmp_path, monkeypatch):
    """``sweep --mesh``, which exited "not ported yet" until the mesh was
    ported, runs on a world-size-1 gloo mesh: it logs the mesh, reports
    ``n_devices`` 1 and, without ``-o``, writes nothing."""
    monkeypatch.chdir(tmp_path)
    try:
        main(argv)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    out, err = capsys.readouterr()
    m = json.loads(out.strip().splitlines()[-1])["sweep_metrics"]
    assert m["n_devices"] == 1 and m["batch"] == 4 and m["n_converged"] == 4
    assert f"[sos] {what} of 1 rank(s)" in err
    assert not os.listdir(tmp_path)


@pytest.fixture
def small_mie(monkeypatch):
    """The eva and wildfire presets on a 56×64 grid in both packages
    (``critical-albedo`` has no grid flags)."""
    from sos_rt_tpu import presets as j_presets

    for mod, grid_cls in ((j_presets, JGrid), (presets, GridSpec)):
        for name in ("eva", "wildfire"):
            monkeypatch.setitem(mod.PRESETS, name, dataclasses.replace(
                mod.PRESETS[name], grid=grid_cls(nb_angles=56, nb_layers=64)))


@pytest.mark.parametrize("argv", [
    ["run", "--nb-angles", "56", "--nb-layers", "64", "-o", "{}.npz"],
    ["run", "--preset", "wildfire", "--nb-angles", "56", "--nb-layers", "64",
     "-o", "{}.npz"],
    ["critical-albedo", "--tau-aer", "0.05,0.3", "--num", "3", "-o", "{}.json"],
], ids=["run-eva", "run-wildfire", "critical-albedo-eva"])
def test_mie_commands_run_and_match_jax(small_mie, argv, tmp_path, monkeypatch):
    """The commands that used to exit "not ported yet" at their Mie presets
    (``eva``, the default of ``run`` and ``critical-albedo``, and
    ``wildfire``) run on the CPU and write what the JAX package's commands
    write: ``run`` in float64 within rtol 1e-9, ``critical-albedo`` (the mega
    engine, float32) the same albedos."""
    from sos_rt_tpu.cli import main as j_main

    monkeypatch.chdir(tmp_path)
    fill = lambda who: [a.format(who) for a in argv]
    j_main(fill("jax"))
    main(fill("port") + ["--device", "cpu"])
    if argv[0] == "run":
        with np.load("jax.npz") as zj, np.load("port.npz") as zp:
            assert sorted(zp.files) == sorted(zj.files)
            assert int(zp["n_orders"]) == int(zj["n_orders"]) >= 2
            for k in zj.files:
                assert zp[k].shape == zj[k].shape and np.isfinite(zp[k]).all(), k
                assert_close_scaled(zp[k], zj[k], rtol=1e-9, atol_scale=1e-12)
        return
    with open("jax.json") as fj, open("port.json") as fp:
        ref, got = json.load(fj), json.load(fp)
    assert got["preset"] == ref["preset"] == "eva"
    assert list(got["critical_albedo"]) == list(ref["critical_albedo"])
    np.testing.assert_allclose(list(got["critical_albedo"].values()),
                               list(ref["critical_albedo"].values()), rtol=1e-9)


def test_module_entry_point_lists():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "sos_rt_tpu_torch", "list"], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "presets:" in out.stdout
    # --mesh without --device needs the card: no silent fall-back to gloo
    bad = subprocess.run([sys.executable, "-m", "sos_rt_tpu_torch", "sweep", "--mesh"],
                         cwd=repo, capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "device='cpu'" in bad.stderr
