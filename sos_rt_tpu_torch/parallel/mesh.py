"""Batched solving on one GPU: scene broadcast, sort keys, buckets.

Counterpart of ``sos_rt_tpu/parallel/mesh.py`` for the three engines on a
single device: ``engine='reference'`` (the default, the batched
``solve_column``), ``'fused'`` and ``'mega'``.  A batch that fails
:func:`mega_small_ok` goes from the mega engine to the fused engine as a
whole, as in the TPU package.  Meshes (column data parallelism over several
GPUs) raise :class:`~sos_rt_tpu_torch.config.NotPortedError` until their
slice lands (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch

from sos_rt_tpu_torch.config import (GridSpec, NotPortedError, Scene,
                                     SolverOptions, resolve_device)
from sos_rt_tpu_torch.solver import PhaseTables, solve_batch_reference


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
    EVERY column, both region band choices (band_choice(τ[idx_up-1]) and
    band_choice(τ[idx_down]), main_lambertian.py:344-349) select a
    polyfit band that covers the whole small-µ set, so the windowed /
    Taylor values would be overwritten anyway.  True for grids without
    small-µ columns."""
    from sos_rt_tpu_torch.grids import neighbour_index, tau_profile
    from sos_rt_tpu_torch.ops.megakernel import band_covers_small
    from sos_rt_tpu_torch.ops.sweeps import band_choice, stencils_for

    stencils = stencils_for(grid)
    if stencils.small_cols.size == 0:
        return True
    ok = {c for c in range(4) if band_covers_small(stencils, c)}
    if len(ok) == 4:
        return True
    tau, iu, idn = tau_profile(scenes.tau_star_atm, scenes.tau_star_aer,
                               scenes.z0, scenes.z_up, scenes.z_down,
                               grid.nb_layers)
    tau = tau.reshape(-1, grid.nb_layers)
    iu1 = neighbour_index(iu.reshape(-1) - 1, grid.nb_layers)
    ca = band_choice(torch.gather(tau, 1, iu1[:, None]))
    cb = band_choice(torch.gather(tau, 1, idn.reshape(-1)[:, None]))
    choices = set(torch.cat([ca, cb]).unique().tolist())
    return choices.issubset(ok)


def solve_batch(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                opts: SolverOptions, mesh=None, shard_tables: bool = False,
                buckets: int = 1, engine: str = "reference", block_b: int = 16,
                outputs: str = "full", cols_per_block: int | None = None,
                sort: str = "score", device=None):
    """Solve a batch of columns on one GPU.

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
    take the JAX package's places up to ``sort``; ``shard_tables`` (shard
    per-column tables over ``mesh``) is ignored without a mesh, as there.
    ``device`` defaults to CUDA.
    """
    from sos_rt_tpu_torch.fused import (scene_on, solve_batch_fused,
                                        solve_batch_mega, sort_key, tables_on,
                                        take_columns)

    if engine not in ("reference", "fused", "mega"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'reference', 'fused' or 'mega'")
    if outputs != "full" and engine != "mega":
        raise ValueError("outputs='summary' requires engine='mega'")
    if mesh is not None:
        raise NotPortedError("mesh= (multi-GPU column sharding) is not "
                             "ported yet; see ROADMAP.md")
    device = resolve_device(device)
    scenes = scene_on(scenes, device)
    tables = tables_on(tables, device)
    if engine == "mega":
        # allow_small grants the mega path a grid with small-µ columns;
        # without it solve_batch_mega hands the batch to the fused engine
        kw = dict(outputs=outputs, cols_per_block=cols_per_block,
                  allow_small=mega_small_ok(scenes, grid), device=device)
        one = lambda s, t, srt: solve_batch_mega(s, t, grid, opts, sort=srt, **kw)
    elif engine == "fused":
        one = lambda s, t, srt: solve_batch_fused(s, t, grid, opts, block_b=block_b,
                                                  device=device)
    else:
        one = lambda s, t, srt: solve_batch_reference(s, t, grid, opts, device=device)
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
