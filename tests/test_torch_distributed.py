"""Multi-process solves through ``parallel.distributed``, held to the JAX
package (the counterpart of tests/test_distributed.py).

Two or four processes (``torch_cases.start_ranks``) start their gloo group
through ``init_distributed(coordinator_address, num_processes,
process_id, device='cpu')`` with a ``file://`` store, each takes its
contiguous share of one batch (the JAX package's ``build_sweep_batch`` on
a 32×48 ``fwc_sweep`` grid, float64, 16 columns, 2 µ0 values) and solves
it with ``solve_batch_multihost``; the parent concatenates the ranks'
``local_shard``s and holds them to the JAX package's single-process
``solve_batch`` (its reference engine) at rtol 1e-10 / atol 1e-12 with
equal order counts.  The four-process run sets ``LOCAL_WORLD_SIZE=2``, so
``make_host_mesh`` spans two "nodes" of two ranks.  Without arguments and
without torchrun's environment ``init_distributed`` starts nothing, and
with arguments but no device it needs the card.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.parallel import solve_batch as j_solve_batch
from sos_rt_tpu.presets import PRESETS as J_PRESETS
from sos_rt_tpu.sweep import build_sweep_batch as j_build_sweep_batch
from sos_rt_tpu_torch.config import SCENE_FIELDS
from sos_rt_tpu_torch.parallel.distributed import init_distributed

from torch_cases import start_ranks, wait_ranks

B = 16
TABLE_KEYS = ("p0_atm", "p_atm", "p0_aer", "p_aer")

BODY = """
from sos_rt_tpu_torch import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.parallel.distributed import (local_shard, make_host_mesh,
                                                   solve_batch_multihost)
from sos_rt_tpu_torch.solver import PhaseTables

z = np.load(cfg["inputs"])
per = z["mu0"].shape[0] // cfg["world"]
sl = slice(cfg["rank"] * per, (cfg["rank"] + 1) * per)
local = lambda k: torch.from_numpy(z[k][sl] if z[k].ndim == 1 or k.startswith("p0") else z[k])
scenes = Scene(**{f: local(f) for f in cfg["scene_keys"]})
tables = PhaseTables(*(local(k) for k in cfg["table_keys"]))
OUT["host_mesh"] = np.array(make_host_mesh().shape)
sol = solve_batch_multihost(scenes, tables, GridSpec(32, 48),
                            SolverOptions(surface="lambertian", dtype="float64",
                                          max_orders=40),
                            engine=cfg["engine"], outputs=cfg["outputs"])
OUT["n_orders"] = local_shard(sol.n_orders)
OUT["i_toa"] = local_shard(sol.i_toa if hasattr(sol, "i_toa") else sol.i_total[:, 0])
OUT["i_surface"] = local_shard(sol.i_surface if hasattr(sol, "i_surface")
                               else sol.i_total[:, -1])
"""


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """The batch as numpy arrays in an npz, and the JAX package's
    single-process truth."""
    preset = dataclasses.replace(
        J_PRESETS["fwc_sweep"], grid=JGrid(nb_angles=32, nb_layers=48),
        opts=JOpts(surface="lambertian", dtype="float64", max_orders=40))
    scenes, tables = j_build_sweep_batch(preset, B, seed=7, mu0_pool=2)
    path = tmp_path_factory.mktemp("batch") / "inputs.npz"
    np.savez(path, **{k: np.asarray(getattr(scenes, k), np.float64) for k in SCENE_FIELDS},
             **{k: np.asarray(getattr(tables, k), np.float64) for k in TABLE_KEYS})
    return str(path), j_solve_batch(scenes, tables, preset.grid, preset.opts)


@pytest.mark.parametrize("nproc,engine,outputs", [
    (2, "reference", "full"),
    (2, "mega", "summary"),
    (4, "mega", "summary"),
], ids=["2proc-reference", "2proc-mega", "4proc-mega"])
def test_multi_process_sharded_solve(batch, tmp_path, monkeypatch, nproc, engine, outputs):
    path, ref = batch
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(nproc // 2 if nproc == 4 else nproc))
    procs = start_ranks(tmp_path, nproc, BODY, inputs=path, engine=engine, outputs=outputs,
                        scene_keys=SCENE_FIELDS, table_keys=TABLE_KEYS)
    outs = wait_ranks(procs, tmp_path)
    for out in outs:
        assert out["host_mesh"].tolist() == ([2, 2] if nproc == 4 else [1, nproc])
        assert out["n_orders"].shape == (B // nproc,)
    got = {k: np.concatenate([o[k] for o in outs]) for k in ("n_orders", "i_toa",
                                                                "i_surface")}
    np.testing.assert_array_equal(got["n_orders"], np.asarray(ref.n_orders))
    np.testing.assert_allclose(got["i_toa"], np.asarray(ref.i_total[:, 0, :]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["i_surface"], np.asarray(ref.i_total[:, -1, :]),
                               rtol=1e-10, atol=1e-12)


def test_init_distributed_single_process_is_a_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_needs_the_card_or_cpu(tmp_path, monkeypatch):
    """With a coordinator but no device, the group would be NCCL on the
    card: without one it raises and starts nothing (no switch to gloo)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(f"file://{tmp_path / 'store'}", 1, 0)
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(tmp_path / "store")
