"""Entry ``solve_batch``: closed-loop calls of
``sos_rt_tpu_torch.parallel.solve_batch`` on fresh draws, one caller.

A request is one call: its scenes drawn on the host, the call, and its
summary (TOA and surface rows, order counts, convergence flags) copied to
the host.  Every answer is kept for the check.
"""
from __future__ import annotations

import time

import numpy as np

from sosbench import traffic_gen


class Entry:
    def __init__(self, cell, seed: int, device, mesh=None):
        import torch
        from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
        from sos_rt_tpu_torch.parallel import solve_batch
        from sos_rt_tpu_torch.solver import PhaseTables

        self.torch, self.Scene, self.solve_batch = torch, Scene, solve_batch
        self.cell, self.device, self.mesh = cell, device, mesh
        cfg, tr = cell.config, cell.traffic
        self.grid = GridSpec(**cfg["grid"])
        self.opts = SolverOptions(surface=cfg["surface"], dtype=cfg["dtype"], mm=cfg["mm"],
                                  tol=cfg["tol"], max_orders=cfg["max_orders"])
        self.batch = int(tr["batch"])
        self.tables = PhaseTables.from_models(
            self.grid, float(cfg["scene"]["mu0"]), atm=tuple(cfg["atm"]),
            aer=tuple(cfg["aer"]), dtype=getattr(torch, cfg["dtype"]), device=device)
        self.warm_rng = np.random.default_rng([seed, 0])
        self.rng = np.random.default_rng([seed, 1])
        self.seed = seed
        self.kept = []           # (scenes, answers) of every request in the window

    def _call(self, rng):
        torch = self.torch
        draw = traffic_gen.scenes(self.cell.config, self.cell.traffic, rng, self.batch)
        scene = self.Scene(**{k: torch.as_tensor(v, device=self.device)
                              for k, v in draw.items()})
        sol = self.solve_batch(scene, self.tables, self.grid, self.opts, mesh=self.mesh,
                               engine=self.cell.traffic["engine"],
                               outputs=self.cell.traffic["outputs"], device=self.device)
        ans = {"i_toa": sol.i_toa.cpu().numpy(), "i_surface": sol.i_surface.cpu().numpy(),
               "n_orders": sol.n_orders.cpu().numpy(), "converged": sol.converged.cpu().numpy()}
        return draw, ans

    def warm(self):
        self._call(self.warm_rng)

    def step(self, keep: bool = True):
        """One request; returns its records [{wall_s, columns, converged,
        n_orders}]."""
        t0 = time.perf_counter()
        draw, ans = self._call(self.rng)
        wall = time.perf_counter() - t0
        if keep:
            self.kept.append((draw, ans))
        return [{"wall_s": wall, "columns": self.batch,
                 "converged": int(ans["converged"].sum()), "n_orders": ans["n_orders"]}]

    def release(self):
        self.tables = None

    def sample(self, n: int):
        """``n`` answers of the window drawn from the seed: (scenes, answers,
        p0 µ0 of each column) as {key: (n,)} / {key: (n, ...)} arrays."""
        rows = [(i, j) for i, (_, a) in enumerate(self.kept) for j in range(len(a["n_orders"]))]
        pick = np.random.default_rng([self.seed, 2]).choice(len(rows), min(n, len(rows)),
                                                             replace=False)
        pick = sorted(rows[p] for p in pick)
        scenes = {k: np.array([self.kept[i][0][k][j] for i, j in pick])
                  for k in traffic_gen.SCENE_KEYS}
        ans = {k: np.stack([self.kept[i][1][k][j] for i, j in pick])
               for k in self.kept[0][1]}
        return scenes, ans, scenes["mu0"]
