"""Batched solving: scene broadcast, sort keys, buckets, and the mesh.

Counterpart of ``sos_rt_tpu/parallel/mesh.py`` for the three engines:
``engine='reference'`` (the default, the batched ``solve_column``),
``'fused'`` and ``'mega'``.  A batch that fails :func:`mega_small_ok` goes
from the mega engine to the fused engine as a whole, as in the TPU package.

Several GPUs run in PyTorch's SPMD idiom: one process per GPU, a
``torch.distributed.device_mesh.DeviceMesh`` with the TPU package's axis
names (:func:`make_mesh`), and collectives on that mesh's process groups.
The TPU package's mesh of N local devices becomes N ranks, launched by
``torchrun`` (``parallel/distributed.py::init_distributed``); a mesh of one
rank runs in a plain process.

- **DP ('data' axis)**: every rank passes the global batch and solves the
  contiguous column shard at its 'data' coordinate with the unsharded
  engine on its own device, then the shards are gathered along 'data', so
  every rank returns the global result.  Phase tables are replicated;
  per-column P0 tables go with their columns.
- **TP ('model' axis, ``shard_tables=True``, reference engine only)**: the
  ranks of one 'model' group split the columns of the two (2M, 2M) source
  operators, and all-gather their slices of Jₙ every order.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions, resolve_device
from sos_rt_tpu_torch.solver import PhaseTables, solve_batch_reference
from sos_rt_tpu_torch.spans import MESH_GATHER, span


def mesh_device_type(device=None) -> str:
    """'cuda' or 'cpu': the caller's device, else the running group's
    (NCCL on the card, gloo on the CPU), else the card."""
    if device is not None:
        return resolve_device(device).type
    if dist.is_initialized():
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return resolve_device(None).type


def make_mesh(mesh_shape: tuple | None = None,
              axis_names: tuple = ("data", "model"), device=None) -> DeviceMesh:
    """A DeviceMesh over every rank of the process group; the default shape
    ``(world_size, 1)`` puts every rank on 'data'.

    Without a process group (a plain process) it starts one of a single
    rank on an in-memory store (NCCL on the card, gloo with
    ``device='cpu'``), as the TPU package's mesh spans one host's devices
    without a distributed runtime.  ``device`` defaults to the running
    group's device type, or to the card."""
    device_type = mesh_device_type(device)
    if not dist.is_initialized():
        cuda = device_type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo", store=dist.HashStore(),
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device())
                                if cuda else None)
    if mesh_shape is None:
        mesh_shape = (dist.get_world_size(), 1)
    return init_device_mesh(device_type, tuple(mesh_shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_axis(mesh, axis: str):
    """(process group, this rank's place in it, its size) of ``mesh``'s
    axis ``axis``.  The place is the rank's coordinate along the axis in
    the order the group's collectives gather."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (make_mesh), "
                        f"not {type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are "
                         f"{mesh.mesh_dim_names}")
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current card for a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_first_rank(mesh: DeviceMesh) -> bool:
    """True on the mesh's first rank, the one that writes a run's files."""
    return dist.get_rank() == int(mesh.mesh.flatten()[0])


def all_gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's (n, ...) ``x`` along dim 0, in the group's rank order:
    (size·n, ...)."""
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def broadcast_scene(scene: Scene, batch: int, device=None) -> Scene:
    """Broadcast every Scene field to a (batch,) float64 tensor."""
    device = resolve_device(device)
    return scene.map(lambda x: torch.as_tensor(
        x, dtype=torch.float64, device=device).expand(batch).contiguous())


def order_count_score(scenes: Scene):
    """Monotone proxy for the expected number of scattering orders.

    Orders grow with total optical depth, single-scattering albedo and
    surface reflectivity; used only to sort columns into blocks/buckets.
    """
    tau_tot = scenes.tau_star_atm + scenes.tau_star_aer
    omega = 0.5 * (scenes.alb_atm + scenes.alb_aer)
    return tau_tot * omega + 0.3 * scenes.grd_alb


def mega_small_ok(scenes: Scene, grid: GridSpec) -> bool:
    """True when the mega path may run a grid with small-µ columns: for
    EVERY column, both region band choices (``ops.sweeps.
    region_band_choices``, main_lambertian.py:344-349) select a
    polyfit band that covers the whole small-µ set, so the windowed /
    Taylor values would be overwritten anyway.  True for grids without
    small-µ columns."""
    from sos_rt_tpu_torch.grids import tau_profile
    from sos_rt_tpu_torch.ops.megakernel import band_covers_small
    from sos_rt_tpu_torch.ops.sweeps import region_band_choices, stencils_for

    stencils = stencils_for(grid)
    if stencils.small_cols.size == 0:
        return True
    ok = {c for c in range(4) if band_covers_small(stencils, c)}
    if len(ok) == 4:
        return True
    tau, iu, idn = tau_profile(scenes.tau_star_atm, scenes.tau_star_aer,
                               scenes.z0, scenes.z_up, scenes.z_down,
                               grid.nb_layers)
    ca, cb = region_band_choices(tau.reshape(-1, grid.nb_layers), iu.reshape(-1),
                                 idn.reshape(-1))
    choices = set(torch.cat([ca, cb]).unique().tolist())
    return choices.issubset(ok)


def engine_solver(engine: str, grid: GridSpec, opts: SolverOptions, device,
                  outputs: str = "full", cols_per_block: int | None = None,
                  block_b: int = 16, allow_small: bool = False, model=None):
    """``solve(scenes, tables, sort)`` of one engine on one device, with no
    collective but ``model``'s.  ``engine``: 'mega' (``allow_small`` is the
    grant of :func:`mega_small_ok`), 'fused' (reduced to the summary rows
    where ``outputs='summary'``: the mega engine's handover) or
    'reference' (``model``: the (group, place, size) of the ranks that
    split the source operators' columns)."""
    from sos_rt_tpu_torch.fused import solve_batch_fused, solve_batch_mega, to_summary
    from sos_rt_tpu_torch.solver import _columns, _order_loop

    if engine == "mega":
        return lambda s, t, srt: solve_batch_mega(
            s, t, grid, opts, sort=srt, outputs=outputs, cols_per_block=cols_per_block,
            allow_small=allow_small, device=device)
    if engine == "fused":
        def fused(s, t, srt):
            sol = solve_batch_fused(s, t, grid, opts, block_b=block_b, device=device)
            return to_summary(sol) if outputs == "summary" else sol
        return fused
    if model is None:
        return lambda s, t, srt: solve_batch_reference(s, t, grid, opts, device=device)
    return lambda s, t, srt: _order_loop(*_columns(s, t, device), grid, opts, None,
                                         None, False, model=model)[0]


def solve_shards(data, scenes: Scene, tables: PhaseTables, solve):
    """``solve(scenes, tables)`` of this rank's contiguous column shard along
    the 'data' axis ``data`` = (group, place, size), its fields then
    gathered along 'data': the whole batch's result on every rank."""
    from sos_rt_tpu_torch.fused import take_columns

    group, place, size = data
    b = scenes.mu0.shape[0]
    if b % size:
        raise ValueError(f"batch {b} not divisible by the mesh's 'data' axis {size}")
    sl = slice(place * b // size, (place + 1) * b // size)
    part = solve(take_columns(scenes, sl), tables.take(sl))
    with span(MESH_GATHER):
        return dataclasses.replace(part, **{
            f.name: all_gather_rows(getattr(part, f.name), group, size)
            for f in dataclasses.fields(part) if getattr(part, f.name) is not None})


def solve_batch(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                opts: SolverOptions, mesh=None, shard_tables: bool = False,
                buckets: int = 1, engine: str = "reference", block_b: int = 16,
                outputs: str = "full", cols_per_block: int | None = None,
                sort: str = "score", device=None):
    """Solve a batch of columns, on one GPU or sharded over ``mesh``.

    ``engine='reference'`` (default): the reference engine
    (solver.solve_batch_reference, ``solve_column`` of every column in one
    batch), full outputs with ``i1``.  ``engine='mega'``: the whole-solve
    engine (resident or streamed, as fused.resolve_stream picks for the
    grid).  When a column's polyfit band does not cover the grid's small-µ
    columns (:func:`mega_small_ok` false), or some column's aerosol layer
    reaches the bottom layer (fused.layer_reaches_ground), the whole batch
    runs the fused engine instead; the kernels' launch counts show which
    ran.
    ``engine='fused'``: the fused engine (fused.solve_batch_fused), full
    outputs only.  In float32 with ``opts.mm=None`` the mega engine runs
    bf16x3 split products and the other two full-precision ones, as in the
    JAX package.

    scenes: Scene with (B,) fields (see :func:`broadcast_scene`).
    ``buckets > 1`` sorts the columns by the order-count key and solves
    equal-size chunks one after another; per-column results are
    unchanged.  ``outputs='summary'`` (mega engine) returns a
    :class:`sos_rt_tpu_torch.fused.SweepSummary`.  ``sort='predict'`` keys
    the sort on the coarse-grid order-count pre-solve
    (fused.predict_order_count).  ``block_b`` is the TPU package's batch
    block of the fused engine and has no effect here.  The parameters
    take the JAX package's places up to ``sort``.  ``device`` defaults to
    CUDA.

    ``mesh`` (a DeviceMesh of :func:`make_mesh` with a 'data' axis): every
    rank passes the same global batch, B divisible by the 'data' size; each
    solves its contiguous column shard on its own device (``device`` must
    be None or of the mesh's type) and returns the global result.  The
    route (``mega_small_ok``, the handover to the fused engine) is decided
    on the global batch, or bucket, before sharding, so every rank runs the
    same engine and the result equals the unsharded solve's.  Shards sort
    by the score (``sort='predict'`` is not used), as the TPU package's
    sharded engines do; ``buckets > 1`` sorts globally by the score, then
    shards each bucket.  No collective runs inside a solve: the TPU
    package's reference engine reduces its convergence test over the mesh
    (GSPMD), which the port drops, because every column masks its own
    accumulation once converged (solver._order_loop), so a column's result
    does not depend on the batch it is solved in.  ``shard_tables=True``
    (reference engine only, ``ValueError`` otherwise; ignored without a
    mesh, as there) splits the source operators' columns over the mesh's
    'model' axis.
    """
    from sos_rt_tpu_torch.fused import goes_to_fused, scene_on, sort_key, tables_on, take_columns

    if engine not in ("reference", "fused", "mega"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'reference', 'fused' or 'mega'")
    if outputs != "full" and engine != "mega":
        raise ValueError("outputs='summary' requires engine='mega'")
    data = model = None
    if mesh is not None:
        data = mesh_axis(mesh, "data")
        if shard_tables:
            if engine != "reference":
                raise ValueError("shard_tables (TP) requires engine='reference'")
            model = mesh_axis(mesh, "model")
        mesh_dev = mesh_device(mesh)
        if device is not None and resolve_device(device).type != mesh_dev.type:
            raise ValueError(f"device {device!r} is not the mesh's ({mesh_dev.type})")
        device, sort = mesh_dev, "score"
    device = resolve_device(device)
    scenes = scene_on(scenes, device)
    tables = tables_on(tables, device)
    # allow_small grants the mega path a grid with small-µ columns;
    # without it solve_batch_mega hands the batch to the fused engine
    allow_small = engine == "mega" and mega_small_ok(scenes, grid)
    kw = dict(outputs=outputs, cols_per_block=cols_per_block, block_b=block_b,
              allow_small=allow_small)
    local = engine_solver(engine, grid, opts, device, model=model, **kw)

    def one(s, t, srt):
        if data is None:
            return local(s, t, srt)
        route = local
        if engine == "mega" and goes_to_fused(s, grid, allow_small):
            route = engine_solver("fused", grid, opts, device, **kw)
        return solve_shards(data, s, t, lambda ss, tt: route(ss, tt, True))

    if buckets <= 1:
        return one(scenes, tables, "predict" if sort == "predict" else True)
    b = scenes.mu0.shape[0]
    if b % buckets:
        raise ValueError(f"batch {b} not divisible by buckets {buckets}")
    perm = torch.argsort(sort_key(scenes, tables, grid, opts, sort, device),
                         stable=True)
    scenes, tables = take_columns(scenes, perm), tables.take(perm)
    chunk = b // buckets
    outs = []
    for i in range(buckets):
        sl = slice(i * chunk, (i + 1) * chunk)
        outs.append(one(take_columns(scenes, sl), tables.take(sl), False))
    stacked = dataclasses.replace(outs[0], **{
        f.name: torch.cat([getattr(o, f.name) for o in outs])
        for f in dataclasses.fields(outs[0]) if getattr(outs[0], f.name) is not None})
    return take_columns(stacked, torch.argsort(perm, stable=True))
