"""``correct`` comes out false when the timed path is broken underneath:
a run of a cell cut to a test size, on the CPU (the look for a card
skipped), with the program's ``solve_batch`` answering wrongly in each of
the ways a solve can, and true when it is sound."""
from __future__ import annotations

import dataclasses

import pytest
import torch

import sos_rt_tpu_torch.parallel as par
from sos_rt_tpu_torch.parallel import mesh as par_mesh
from sosbench import run
from sosbench.tests.helpers import small_cell

SEED = 2 ** 31 + 11


def stale(solve):
    """A step that returns its state unchanged: every call after the first
    answers with the first call's result."""
    first = []

    def f(*a, **kw):
        out = solve(*a, **kw)
        if not first:
            first.append(out)
        b = out.n_orders.shape[0]
        return dataclasses.replace(out, **{k: getattr(first[0], k)[:b] for k in
                                           ("i_toa", "i_surface", "n_orders", "converged")})
    return f


def half(solve):
    """Half of the batch left out: its answers are the other half's."""
    def f(*a, **kw):
        out = solve(*a, **kw)
        h = out.n_orders.shape[0] // 2
        fix = lambda x: torch.cat([x[:h], x[:h], x[2 * h:]])
        return dataclasses.replace(out, **{k: fix(getattr(out, k)) for k in
                                           ("i_toa", "i_surface", "n_orders", "converged")})
    return f


def altered(solve):
    """An answer altered where it is produced: every row a part in 10³ off."""
    def f(*a, **kw):
        out = solve(*a, **kw)
        return dataclasses.replace(out, i_toa=out.i_toa * 1.001, i_surface=out.i_surface * 1.001)
    return f


CELLS = ["canonical.stream", "fwc.sweep", "canonical.red"]


def run_cell(tmp_path, name):
    cell = small_cell(tmp_path, name)
    return run.execute(cell, SEED, 0.5, False, torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tmp_path, name):
    res = run_cell(tmp_path, name)
    assert res["correct"] is True, res["check"]
    assert res["attempted"] >= 1 and set(res["check"]) == set(
        small_cell(tmp_path / "x", name).workload["check"]["limits"])


@pytest.mark.parametrize("fault", [stale, half, altered], ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tmp_path, monkeypatch, name, fault):
    monkeypatch.setattr(par, "solve_batch", fault(par.solve_batch))
    res = run_cell(tmp_path, name)
    assert res["correct"] is False, res["check"]


def _rank(rank, world, port, base, fault, queue):
    """One gloo rank of the mesh cell cut to a test size."""
    from sosbench import spec
    if fault:
        par_mesh.all_gather_rows = lambda x, group, size: torch.cat([x] * size)
    cell = spec.Cell("fwc.sweep_4gpu", spec.benchmark(), base)
    res = run.execute(cell, SEED, 0.5, False, torch.device("cpu"), rank, world, port)
    if rank == 0:
        queue.put(res)


def run_mesh(tmp_path, fault: bool, world: int = 2):
    import multiprocessing as mp
    cell = small_cell(tmp_path, "fwc.sweep_4gpu", chunk=16, sweep=40)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = run.free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, cell.base, fault, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    res = queue.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    return res


def test_mesh_run_is_correct(tmp_path):
    """The mesh cell's path on two gloo ranks: chunks sharded, gathered,
    written by rank 0, and read back correct."""
    res = run_mesh(tmp_path, fault=False)
    assert res["correct"] is True, res["check"]


def test_exchange_left_out_is_not_correct(tmp_path):
    """The mesh's gather left out: each rank keeps its own shard's rows,
    and the others' come back as copies of them."""
    res = run_mesh(tmp_path, fault=True)
    assert res["correct"] is False, res["check"]
