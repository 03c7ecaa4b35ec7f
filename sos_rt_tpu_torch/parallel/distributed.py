"""Multi-process execution: one process per GPU over ``torch.distributed``.

Counterpart of ``sos_rt_tpu/parallel/distributed.py``:

- :func:`init_distributed` — the process group from explicit arguments or
  from ``torchrun``'s environment; a no-op for a single process.
- :func:`make_host_mesh` — a ('replica', 'data') DeviceMesh over nodes ×
  the ranks of one node.
- :func:`process_local_batch` — this rank's columns and the replicated
  tables on its device.
- :func:`solve_batch_multihost` — each rank solves its own columns and
  keeps them: no collective inside the solve.
- :func:`local_shard` — a local result as a NumPy array.

The TPU package's ``columns_spec`` (its replica×data sharding of a global
array) has no counterpart: a rank's columns are the ones it holds.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sos_rt_tpu_torch.config import SCENE_FIELDS, Scene, resolve_device
from sos_rt_tpu_torch.parallel.mesh import (all_gather_rows, engine_solver, mega_small_ok,
                                            mesh_device, mesh_device_type)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, device=None) -> bool:
    """Start this process's rank of the process group.

    Explicit arguments win: ``coordinator_address`` ("host:port", or an
    init-method URL such as ``file:///path``), ``num_processes`` and
    ``process_id``.  Otherwise ``torchrun``'s environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  With
    neither it returns False and starts nothing, the single-process no-op.
    Returns True when it started the group.

    The backend is NCCL on the card, with the rank's card
    (``local_device_ids[0]``, else ``LOCAL_RANK``, else the process id
    modulo the visible cards) made current; gloo only when the caller
    passes ``device='cpu'``.  The TPU package's pod detection
    (``TPU_WORKER_HOSTNAMES`` / ``MEGASCALE_COORDINATOR_ADDRESS``) has no
    GPU counterpart and is not ported.
    """
    env = os.environ
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
    elif all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        init_method, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    device = resolve_device(device)
    index = None
    if device.type == "cuda":
        index = (local_device_ids[0] if local_device_ids
                 else int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
        torch.cuda.set_device(index)
    dist.init_process_group("nccl" if index is not None else "gloo",
                            init_method=init_method, world_size=world, rank=rank,
                            device_id=None if index is None else torch.device("cuda", index))
    return True


def make_host_mesh(axis_names=("replica", "data")) -> DeviceMesh:
    """('replica', 'data') mesh: nodes × the ranks of one node
    (``LOCAL_WORLD_SIZE``, torchrun's; the whole world without it).  Ranks
    are numbered node-major, so the 'data' groups stay inside a node and
    the 'replica' groups cross nodes.  The device type follows the running
    group's backend: NCCL the card, gloo the CPU."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"world size {world} not divisible by LOCAL_WORLD_SIZE {local}")
    return init_device_mesh(mesh_device_type(), (world // local, local),
                            mesh_dim_names=tuple(axis_names))


def process_local_batch(mesh: DeviceMesh, local_scenes, local_tables):
    """This rank's (scenes, tables) on its device: ``local_scenes`` with
    (B_local,) fields, ``local_tables`` with the replicated P matrices and,
    for µ0 sweeps, this rank's (B_local, 2M) P0 rows."""
    from sos_rt_tpu_torch.fused import scene_on, tables_on

    device = mesh_device(mesh)
    return scene_on(local_scenes, device), tables_on(local_tables, device)


def solve_batch_multihost(local_scenes, local_tables, grid, opts,
                          engine: str = "reference", outputs: str = "full",
                          block_b: int = 16):
    """Multi-process batched solve: each rank solves the columns it holds
    and returns them (its local shard of the global batch, whose columns
    are the ranks' in rank order).

    The mega engine's route (:func:`~sos_rt_tpu_torch.parallel.mesh.
    mega_small_ok`, the handover to the fused engine) is decided on the
    global batch: the ranks all-gather their scene fields (9 numbers a
    column) before the solve, so every rank runs the same engine.  The solve
    itself runs no collective; the TPU package's reference engine reduces
    its convergence test over every process, which a column's masked
    accumulation makes unnecessary (parallel.mesh.solve_batch)."""
    from sos_rt_tpu_torch.fused import goes_to_fused

    if engine not in ("reference", "fused", "mega"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'reference', 'fused' or 'mega'")
    if outputs != "full" and engine != "mega":
        raise ValueError("outputs='summary' requires engine='mega'")
    mesh = make_host_mesh()
    scenes, tables = process_local_batch(mesh, local_scenes, local_tables)
    device = mesh_device(mesh)
    kw = dict(outputs=outputs, block_b=block_b)
    if engine == "mega":
        cols = torch.stack([getattr(scenes, f) for f in SCENE_FIELDS], dim=1)
        every = all_gather_rows(cols, None, dist.get_world_size())
        glob = Scene(**{f: every[:, i] for i, f in enumerate(SCENE_FIELDS)})
        kw["allow_small"] = mega_small_ok(glob, grid)
        if goes_to_fused(glob, grid, kw["allow_small"]):
            engine = "fused"
    return engine_solver(engine, grid, opts, device, **kw)(scenes, tables, True)


def local_shard(x) -> np.ndarray:
    """This rank's rows of a result field as a NumPy array."""
    return x.detach().cpu().numpy()

