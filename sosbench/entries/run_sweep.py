"""Entry ``run_sweep``: whole sweeps of ``sos_rt_tpu_torch.sweep.run_sweep``
back to back, each with its own seed, as the ``sweep`` command runs them
(with ``mesh=make_mesh()`` on several cards, the ``sweep --mesh`` path).

A request is one chunk, timed from the previous chunk's log callback (or
from the sweep's start for the first chunk) to its own: it includes the
shard's compression and writing, and the first chunk's includes the µ0
tables.  ``load_sweep`` at the sweep's end and the gaps between sweeps
count in the window but in no chunk.  Shards go to a fresh directory
under ``TMPDIR``, removed after each sweep; one shard of each sweep, drawn
from the seed, is moved aside first for the check.

The warm request is a shorter sweep: one whole chunk and, where the batch
does not divide into chunks, a last chunk of the window's last size, over
the same µ0 pool, so every shape the window's sweeps use runs once.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from sosbench import traffic_gen


class Entry:
    def __init__(self, cell, seed: int, device, mesh=None):
        import torch
        from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
        from sos_rt_tpu_torch.presets import Preset
        from sos_rt_tpu_torch.sweep import run_sweep

        self.torch, self.run_sweep = torch, run_sweep
        self.cell, self.device, self.mesh, self.seed = cell, device, mesh, seed
        cfg, tr = cell.config, cell.traffic
        self.preset = Preset(
            name=cfg["name"], grid=GridSpec(**cfg["grid"]), scene=Scene(**cfg["scene"]),
            opts=SolverOptions(surface=cfg["surface"], dtype=cfg["dtype"], mm=cfg["mm"],
                               tol=cfg["tol"], max_orders=cfg["max_orders"]),
            atm=tuple(cfg["atm"]), aer=tuple(cfg["aer"]), batch=int(cfg["batch"]))
        self.batch, self.pool = int(cfg["batch"]), int(cfg["mu0_pool"])
        self.chunk = int(tr["chunk"])
        self.n_chunks = -(-self.batch // self.chunk)
        self.warm_batch = min(self.batch, self.chunk + self.batch % self.chunk)
        self.rng = np.random.default_rng([seed, 1])
        self.pick_rng = np.random.default_rng([seed, 2])
        self.writer = mesh is None or torch.distributed.get_rank() == 0
        self.scratch = tempfile.mkdtemp(prefix="sosbench-") if self.writer else None
        self.kept = []           # (sweep seed, chunk index, shard path)

    def _shared(self, value):
        """Rank 0's ``value`` on every rank."""
        if self.mesh is None:
            return value
        box = [value]
        self.torch.distributed.broadcast_object_list(box, src=0)
        return box[0]

    def _sweep(self, seed: int, keep: bool, batch: int = 0):
        out_dir = self._shared(tempfile.mkdtemp(prefix="sweep-", dir=self.scratch)
                               if self.writer else None)
        stamps = []

        def log(msg):
            if msg.startswith("shard "):
                stamps.append(time.perf_counter())

        tr = self.cell.traffic
        batch = batch or self.batch
        n_chunks = -(-batch // self.chunk)
        t0 = time.perf_counter()
        m = self.run_sweep(self.preset, batch, seed=seed, mu0_pool=self.pool,
                           engine=tr["engine"], outputs=tr["outputs"], chunk=self.chunk,
                           out_dir=out_dir, mesh=self.mesh, log=log, sort=tr["sort"],
                           device=self.device)
        if self.mesh is not None:
            self.torch.distributed.barrier()     # every rank has read the sweep
        records = []
        if self.writer:
            if len(stamps) != n_chunks or not m.get("complete"):
                raise RuntimeError(f"the sweep logged {len(stamps)} of {n_chunks} "
                                   f"chunks (complete: {m.get('complete')})")
            walls = np.diff([t0] + stamps)
            shard = lambda i: os.path.join(out_dir, f"shard_{i:05d}.npz")
            for i, w in enumerate(walls):
                with np.load(shard(i)) as z:
                    rec = {"wall_s": float(w), "columns": len(z["converged"]),
                           "converged": int(z["converged"].sum()),
                           "n_orders": z["n_orders"].copy()}
                records.append(rec)
            if keep:
                i = int(self.pick_rng.integers(self.n_chunks))
                dest = os.path.join(self.scratch, f"kept_{len(self.kept):04d}.npz")
                os.replace(shard(i), dest)
                self.kept.append((seed, i, dest))
            shutil.rmtree(out_dir)
        return records

    def warm(self):
        self._sweep(int(np.random.default_rng([self.seed, 0]).integers(2 ** 62)), keep=False,
                    batch=self.warm_batch)

    def step(self, keep: bool = True):
        """One sweep; its chunks' records [{wall_s, columns, converged,
        n_orders}], read back from the shards, on the writer rank; [] on the
        others."""
        return self._sweep(int(self.rng.integers(2 ** 62)), keep)

    def release(self):
        pass

    def sample(self, n: int):
        """Up to ``n`` columns of the kept shards, drawn from the seed, read
        back with NumPy: (scenes, answers, µ0 of each column's P0 table)."""
        parts = []
        for seed, i, path in self.kept:
            scenes, pool, idx = traffic_gen.sweep_scenes(self.cell.config, seed)
            sl = slice(i * self.chunk, min((i + 1) * self.chunk, self.batch))
            with np.load(path) as z:
                ans = {k: z[k].copy() for k in ("i_toa", "i_surface", "n_orders", "converged")}
            if len(ans["n_orders"]) != sl.stop - sl.start:
                raise RuntimeError(f"shard {i} of sweep {seed} holds {len(ans['n_orders'])} "
                                   f"columns, not {sl.stop - sl.start}")
            parts.append(({k: v[sl] for k, v in scenes.items()}, ans, pool[idx[sl]]))
        cat = lambda dicts: {k: np.concatenate([d[k] for d in dicts]) for k in dicts[0]}
        scenes, ans = cat([p[0] for p in parts]), cat([p[1] for p in parts])
        p0_mu0 = np.concatenate([p[2] for p in parts])
        pick = np.sort(np.random.default_rng([self.seed, 3]).choice(
            len(p0_mu0), min(n, len(p0_mu0)), replace=False))
        return ({k: v[pick] for k, v in scenes.items()}, {k: v[pick] for k, v in ans.items()},
                p0_mu0[pick])

    def close(self):
        if self.scratch:
            shutil.rmtree(self.scratch, ignore_errors=True)
