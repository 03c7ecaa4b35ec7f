"""Entry ``solve_chunk``: closed-loop calls of
``sos_rt_tpu_torch.parallel.solve_batch`` on chunks of a sweep's columns,
one caller, as a lookup-table or retrieval code calls the library.

Each call draws its own seed, and from it the sweep's documented scenes
(``traffic_gen.sweep_scenes``: ρ, τ*_aer, ω_aer and each column's index
into the configuration's µ0 pool, µ0 rounded to the compute dtype).  The
pool's tables are built once at set-up
(``PhaseTables.from_models_batched_mu0``) and each call is given its
columns' P0 rows.  A request is one call: the draws, the call, and its
summary copied to the host.

The answers of every call are not kept: a reservoir keeps
:data:`KEEP_CALLS` calls drawn uniformly from the window (by the seed),
each with its call seed, so the check re-makes their scenes.
"""
from __future__ import annotations

import time

import numpy as np

from sosbench import traffic_gen

KEEP_CALLS = 8


class Entry:
    def __init__(self, cell, seed: int, device, mesh=None):
        import torch
        from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
        from sos_rt_tpu_torch.parallel import solve_batch
        from sos_rt_tpu_torch.solver import PhaseTables

        self.torch, self.Scene, self.solve_batch = torch, Scene, solve_batch
        self.cell, self.device, self.mesh, self.seed = cell, device, mesh, seed
        cfg, tr = cell.config, cell.traffic
        self.grid = GridSpec(**cfg["grid"])
        self.opts = SolverOptions(surface=cfg["surface"], dtype=cfg["dtype"], mm=cfg["mm"],
                                  tol=cfg["tol"], max_orders=cfg["max_orders"])
        self.batch = int(tr["batch"])
        self.draw_cfg = dict(cfg, batch=self.batch)
        self.pool = np.linspace(*traffic_gen.SWEEP_MU0, int(cfg["mu0_pool"]))
        self.tables = PhaseTables.from_models_batched_mu0(
            self.grid, self.pool, atm=tuple(cfg["atm"]), aer=tuple(cfg["aer"]),
            dtype=getattr(torch, cfg["dtype"]), device=device)
        self.rng = np.random.default_rng([seed, 1])
        self.keep_rng = np.random.default_rng([seed, 2])
        self.calls = 0
        self.kept = []           # (call seed, answers) of the reservoir's calls

    def _call(self, call_seed: int):
        torch = self.torch
        draw, _, idx = traffic_gen.sweep_scenes(self.draw_cfg, call_seed)
        scene = self.Scene(**{k: torch.as_tensor(v, device=self.device)
                              for k, v in draw.items()})
        tables = self.tables.take(torch.as_tensor(idx, device=self.device))
        tr = self.cell.traffic
        sol = self.solve_batch(scene, tables, self.grid, self.opts, mesh=self.mesh,
                               engine=tr["engine"], outputs=tr["outputs"], sort=tr["sort"],
                               device=self.device)
        return {"i_toa": sol.i_toa.cpu().numpy(), "i_surface": sol.i_surface.cpu().numpy(),
                "n_orders": sol.n_orders.cpu().numpy(),
                "converged": sol.converged.cpu().numpy()}

    def warm(self):
        self._call(int(np.random.default_rng([self.seed, 0]).integers(2 ** 62)))

    def step(self, keep: bool = True):
        """One request; returns its records [{wall_s, columns, converged,
        n_orders}]."""
        t0 = time.perf_counter()
        call_seed = int(self.rng.integers(2 ** 62))
        ans = self._call(call_seed)
        wall = time.perf_counter() - t0
        if keep:
            self.calls += 1
            if len(self.kept) < KEEP_CALLS:
                self.kept.append((call_seed, ans))
            else:
                j = int(self.keep_rng.integers(self.calls))
                if j < KEEP_CALLS:
                    self.kept[j] = (call_seed, ans)
        return [{"wall_s": wall, "columns": self.batch,
                 "converged": int(ans["converged"].sum()), "n_orders": ans["n_orders"]}]

    def release(self):
        self.tables = None

    def sample(self, n: int):
        """``n`` columns of the kept calls drawn from the seed: (scenes,
        answers, µ0 of each column's P0 table)."""
        parts = []
        for call_seed, ans in self.kept:
            scenes, pool, idx = traffic_gen.sweep_scenes(self.draw_cfg, call_seed)
            parts.append((scenes, ans, pool[idx]))
        cat = lambda dicts: {k: np.concatenate([d[k] for d in dicts]) for k in dicts[0]}
        scenes, ans = cat([p[0] for p in parts]), cat([p[1] for p in parts])
        p0_mu0 = np.concatenate([p[2] for p in parts])
        pick = np.sort(np.random.default_rng([self.seed, 3]).choice(
            len(p0_mu0), min(n, len(p0_mu0)), replace=False))
        return ({k: v[pick] for k, v in scenes.items()}, {k: v[pick] for k, v in ans.items()},
                p0_mu0[pick])
