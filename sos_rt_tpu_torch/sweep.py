"""Production batched sweeps (counterpart of ``sos_rt_tpu/sweep.py``).

- :func:`build_sweep_batch` — deterministic randomized scene batch + the
  µ0-pooled phase tables (P0(µ, µ0) built per distinct µ0 and gathered
  per column; the P matrices are shared).
- :func:`run_sweep` — chunked, **resumable** execution: results are
  written as per-chunk npz shards (:mod:`sos_rt_tpu_torch.npz`) with an
  index JSON; a re-run with
  ``resume=True`` skips completed shards, so a killed sweep loses at most
  one chunk.  Returns structured metrics per run, logs them per chunk.
- :func:`load_sweep` — concatenate a completed sweep's shards.

Shard files and ``index.json`` have the TPU package's keys and layout, so
either package's ``load_sweep`` reads a directory the other wrote.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from sos_rt_tpu_torch import metrics as _metrics
from sos_rt_tpu_torch.config import resolve_device, torch_dtype
from sos_rt_tpu_torch.npz import NpzWriter
from sos_rt_tpu_torch.spans import (SWEEP_BARRIER, SWEEP_LOAD, SWEEP_SHARD, SWEEP_SOLVE,
                                    SWEEP_TABLES, span)


def build_sweep_batch(preset, batch: int, seed: int = 0, mu0_pool: int = 0,
                      dtype=None, device=None):
    """Randomized sweep scene batch from a preset.

    Randomizes (grd_alb, τ*_aer, ω_aer) per column — U[0, 0.9),
    U[0.01, 0.4), U[0.7, 1.0) — and, with ``mu0_pool > 0``, draws each
    column's µ0 from that many distinct values in [0.2, 0.95] (tables
    built once per distinct value via
    ``PhaseTables.from_models_batched_mu0`` and gathered per column).
    Deterministic in ``seed``: the draws come from
    ``numpy.random.default_rng(seed)``, in the order above, so they differ
    from the TPU package's (which draws the same ranges from its own
    framework's generator).  Returns (scenes, tables) on ``device``.
    """
    return _sweep_batch(preset, batch, seed, mu0_pool, dtype, device)


def _sweep_batch(preset, batch, seed, mu0_pool, dtype, device, stages=None):
    """:func:`build_sweep_batch`, with the tables' seconds added to
    ``stages`` where it is given (:func:`~sos_rt_tpu_torch.spans.span`)."""
    from sos_rt_tpu_torch.parallel import broadcast_scene
    from sos_rt_tpu_torch.solver import PhaseTables

    device = resolve_device(device)
    if dtype is None:
        dtype = torch_dtype(preset.opts.dtype)
    rng = np.random.default_rng(seed)
    draw = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, batch), device=device)
    scenes = dataclasses.replace(
        broadcast_scene(preset.scene, batch, device=device),
        grd_alb=draw(0.0, 0.9), tau_star_aer=draw(0.01, 0.4),
        alb_aer=draw(0.7, 1.0))
    if mu0_pool > 0:
        pool = np.linspace(0.2, 0.95, mu0_pool)
        idx = rng.integers(0, mu0_pool, batch)
        # the pool rounded to the compute dtype, as the tables' dtype is
        mu0 = torch.as_tensor(pool).to(dtype)[idx].to(torch.float64)
        scenes = dataclasses.replace(scenes, mu0=mu0.to(device))
    with span(SWEEP_TABLES, into=stages):
        if mu0_pool > 0:
            tables = PhaseTables.from_models_batched_mu0(
                preset.grid, pool, atm=preset.atm, aer=preset.aer, dtype=dtype,
                device=device)
            tables = tables.take(torch.as_tensor(idx, device=device))
        else:
            tables = PhaseTables.from_models(
                preset.grid, float(np.asarray(preset.scene.mu0)),
                atm=preset.atm, aer=preset.aer, dtype=dtype, device=device)
    return scenes, tables


def _shard_path(out_dir: str, i: int) -> str:
    return os.path.join(out_dir, f"shard_{i:05d}.npz")


def _summary_arrays(sol) -> Dict[str, np.ndarray]:
    """Reduced per-column outputs for shard files (TOA/surface rows; full
    fields stay on the device)."""
    if hasattr(sol, "i_toa"):
        i_toa, i_surface = sol.i_toa, sol.i_surface
    else:
        i_toa, i_surface = sol.i_total[:, 0, :], sol.i_total[:, -1, :]
    to_np = lambda x: x.detach().cpu().numpy()
    return {"i_toa": to_np(i_toa), "i_surface": to_np(i_surface),
            "n_orders": to_np(sol.n_orders), "converged": to_np(sol.converged)}


def run_sweep(preset, batch: int, seed: int = 0, mu0_pool: int = 0,
              engine: str = "mega", outputs: str = "summary",
              buckets: int = 1, block_b: int = 16, chunk: int = 0,
              out_dir: Optional[str] = None, resume: bool = False,
              mesh=None, stop_after_chunks: int = 0,
              log=None, save_orders: bool = False,
              sort: str = "predict", device=None) -> Dict[str, Any]:
    """Run a (resumable) sweep; returns the aggregated metrics dict.

    Its ``wall_s`` and ``col_per_s`` count only the solve calls: no
    tables, shards or ``load_sweep``.  ``stages_s`` holds the seconds of
    the sweep's spans (:mod:`sos_rt_tpu_torch.spans`) by name:
    ``sos.sweep.tables``, ``sos.sweep.solve``, ``sos.sweep.shard`` (the
    shard writer only) and ``sos.sweep.load``, where they ran.

    ``chunk > 0`` with ``out_dir``: solve ``chunk`` columns at a time,
    write one npz shard per chunk plus ``index.json``, deflated on one
    pool of host threads a run (:class:`sos_rt_tpu_torch.npz.NpzWriter`);
    the metrics' ``shard_threads`` and ``shard_blocks`` are its size and
    the deflate blocks it wrote (0 on ranks that write no shard).
    ``resume=True`` skips shards already recorded in the index (kill-and-resume safe:
    the index is rewritten atomically after each shard).
    ``stop_after_chunks > 0`` stops early after that many *newly solved*
    chunks.  The last chunk is solved at its own size.

    ``sort``: convergence-sort key for the mega engine — 'predict'
    (coarse-grid order-count pre-solve; the proxy when that does not
    apply) or 'score' (the closed-form proxy).

    ``save_orders``: also record each column's per-order TOA/surface rows
    and their validity (the reference's ``I_saved`` read-set,
    main_lambertian.py:460) as ``orders_toa`` / ``orders_surface``
    (B, max_orders, 2M) and ``order_valid`` (B, max_orders) in the shards.
    It solves through :func:`sos_rt_tpu_torch.solver.solve_batch_orders`,
    the batched reference engine: ``engine``, ``buckets`` and ``sort`` are
    ignored, as in the TPU package, and the throughput is the reference
    engine's.  It needs ``chunk > 0`` and ``out_dir`` (the per-order
    arrays leave only through the shards; ``ValueError`` otherwise).

    ``mesh`` (a DeviceMesh of ``parallel.make_mesh``): every rank builds
    the same batch and solves it sharded over the mesh's 'data' axis
    (``parallel.solve_batch(mesh=)``, which sorts by the score, so ``sort``
    is 'score'); ``n_devices`` in the metrics is the mesh's size.  Only the
    mesh's first rank writes shards and ``index.json`` (and logs); the
    others wait for it at a barrier before they read the finished sweep.
    ``save_orders`` with a mesh solves unsharded on every rank, as in the
    TPU package.  ``device`` defaults to CUDA (to the mesh's device with a
    mesh).
    """
    from sos_rt_tpu_torch.fused import take_columns
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.parallel.mesh import is_first_rank, mesh_axis, mesh_device
    from sos_rt_tpu_torch.solver import solve_batch_orders

    if save_orders and (chunk <= 0 or out_dir is None):
        raise ValueError("save_orders=True requires chunk > 0 and an out_dir "
                         "(the per-order arrays are written to the npz shards)")
    writer, n_devices = True, 1
    if mesh is not None:
        mesh_axis(mesh, "data")         # a DeviceMesh with a 'data' axis
        device, sort = mesh_device(mesh), "score"
        writer, n_devices = is_first_rank(mesh), mesh.size()
    device = resolve_device(device)
    log = (log if writer else None) or (lambda msg: None)
    if mesh is not None and save_orders:
        log("save_orders: solving unsharded on every rank; the mesh is not used")

    def solve(part, part_tbl):
        """→ (solution, extra per-column shard arrays)."""
        if save_orders:
            sol, orders, valid = solve_batch_orders(part, part_tbl, preset.grid,
                                                    preset.opts, device=device)
            to_np = lambda x: x.detach().cpu().numpy()
            return sol, {"orders_toa": to_np(orders[:, :, 0]),
                         "orders_surface": to_np(orders[:, :, 1]),
                         "order_valid": to_np(valid)}
        sol = solve_batch(part, part_tbl, preset.grid, preset.opts, mesh=mesh,
                          engine=engine, outputs=outputs, buckets=buckets,
                          block_b=block_b, sort=sort, device=device)
        return _metrics.block_until_ready(sol), {}

    stages: Dict[str, float] = {}
    scenes, tables = _sweep_batch(preset, batch, seed, mu0_pool, None, device, stages)
    if chunk <= 0 or out_dir is None:
        t0 = time.perf_counter()
        with span(SWEEP_SOLVE, into=stages):
            sol, _ = solve(scenes, tables)
        m = _metrics.solution_metrics(sol, time.perf_counter() - t0, n_devices=n_devices)
        m["engine"] = engine
        m["outputs"] = outputs
        m["stages_s"] = _rounded(stages)
        return m

    if writer:
        os.makedirs(out_dir, exist_ok=True)
    index_path = os.path.join(out_dir, "index.json")
    # the spec pins everything that shapes a shard's physics/layout:
    # resuming into an out_dir written under a same-named but modified
    # preset (different grid/opts) must be rejected, not silently mixed
    g, o = preset.grid, preset.opts
    spec = {"preset": preset.name, "batch": batch, "seed": seed,
            "mu0_pool": mu0_pool, "chunk": chunk, "engine": engine,
            "outputs": outputs, "save_orders": bool(save_orders),
            "grid": {"nb_angles": g.nb_angles, "nb_layers": g.nb_layers,
                     "spacing": g.spacing},
            "opts": {"surface": o.surface, "dtype": o.dtype,
                     "tol": float(o.tol), "max_orders": int(o.max_orders)}}
    done: set[int] = set()
    if resume and os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        if index.get("spec") != spec:
            raise ValueError(
                f"resume spec mismatch: index has {index.get('spec')}, "
                f"requested {spec}; use a fresh --output dir")
        done = {i for i in index.get("completed", [])
                if os.path.exists(_shard_path(out_dir, i))}
        log(f"resuming: {len(done)} shard(s) already complete")

    n_chunks = -(-batch // chunk)
    wall = 0.0
    solved_now = 0
    solved_cols = 0
    # the writer rank's shard writer, one pool of threads for every shard
    with (NpzWriter() if writer else contextlib.nullcontext()) as shards:
        for i in range(n_chunks):
            if i in done:
                continue
            sl = slice(i * chunk, min((i + 1) * chunk, batch))
            t0 = time.perf_counter()
            with span(SWEEP_SOLVE, into=stages):
                sol, extra = solve(take_columns(scenes, sl), tables.take(sl))
            dt = time.perf_counter() - t0
            wall += dt
            solved_cols += sl.stop - sl.start
            done.add(i)
            if writer:
                with span(SWEEP_SHARD, into=stages):
                    tmp = _shard_path(out_dir, i)[:-4] + ".tmp.npz"
                    shards.save(tmp, **_summary_arrays(sol), **extra)
                    os.replace(tmp, _shard_path(out_dir, i))
                    index = {"spec": spec, "n_chunks": n_chunks, "completed": sorted(done)}
                    tmp_idx = index_path + ".tmp"
                    with open(tmp_idx, "w") as f:
                        json.dump(index, f)
                    os.replace(tmp_idx, index_path)
            cm = _metrics.solution_metrics(sol, dt, n_devices=n_devices)
            log(f"shard {i + 1}/{n_chunks}: {cm['batch']} columns in "
                f"{dt:.2f}s ({cm.get('col_per_s', 0):,.0f} col/s), "
                f"orders max {cm['orders_max']}")
            solved_now += 1
            if stop_after_chunks and solved_now >= stop_after_chunks:
                break

    if mesh is not None:
        with span(SWEEP_BARRIER):
            dist.barrier()      # the first rank has written every shard
    m: Dict[str, Any] = {"engine": "orders" if save_orders else engine,
                         "outputs": outputs, "n_chunks": n_chunks, "n_completed": len(done),
                         "complete": len(done) == n_chunks, "n_devices": n_devices,
                         "shard_threads": shards.threads if writer else 0,
                         "shard_blocks": shards.blocks if writer else 0}
    if len(done) == n_chunks:
        res = _load_sweep(out_dir, stages)
        n_tot = int(res["n_orders"].shape[0])
        conv = int(res["converged"].sum())
        m.update(batch=n_tot, orders_max=int(res["n_orders"].max()),
                 orders_mean=float(res["n_orders"].mean()),
                 n_converged=conv, n_unconverged=n_tot - conv)
    if wall > 0 and solved_now:
        m["wall_s"] = round(wall, 4)
        m["col_per_s"] = round(solved_cols / wall, 1)
    m["stages_s"] = _rounded(stages)
    return m


def _rounded(stages: Dict[str, float]) -> Dict[str, float]:
    return {k: round(v, 4) for k, v in stages.items()}


def load_sweep(out_dir: str) -> Dict[str, np.ndarray]:
    """Concatenate a completed sweep's shards into one result dict."""
    return _load_sweep(out_dir)


def _load_sweep(out_dir: str, stages=None) -> Dict[str, np.ndarray]:
    """:func:`load_sweep`, with its seconds added to ``stages`` where it is
    given."""
    with span(SWEEP_LOAD, into=stages):
        with open(os.path.join(out_dir, "index.json")) as f:
            index = json.load(f)
        n = index["n_chunks"]
        missing = [i for i in range(n)
                   if not os.path.exists(_shard_path(out_dir, i))]
        if missing:
            raise ValueError(f"sweep incomplete: missing shards {missing}")
        parts = []
        for i in range(n):
            with np.load(_shard_path(out_dir, i)) as z:
                parts.append({k: z[k] for k in z.files})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
