"""Ablation harness for the mega engine: block size and sorting.

Counterpart of the JAX package's ``tools/ablate.py``.

usage: python -m sos_rt_tpu_torch.tools.ablate [block_b ...] [--batch N]
           [--device cpu] [--grid NA NL]

Solves the 64×128 FWC batch (rayleigh + FWC tables at µ0 = 0.5, float32,
Lambertian, ``max_orders`` = 100, ``scan_impl='sequential'``; ρ, τ*_aer
and ω_aer drawn per column from a ``torch.Generator`` seeded 0) through
``solve_batch(engine='mega')``, with the columns in their drawn order and
sorted by the closed-form order-count score, and prints col/s: the least
of three solves after a first one (each with ρ moved by i·1e-7, as the
JAX tool does), the first one's seconds beside it.  ``block_b`` (default
64) is handed to ``solve_batch`` as the JAX tool hands it; in both
packages it has no effect on the mega engine (the resident kernel's tile
and the streamed loop's block are the engine's own), so every ``block_b``
reads the same.  ``--device cpu`` runs the plain versions (for the tests;
keep the batch and the grid small).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.parallel import broadcast_scene, solve_batch
from sos_rt_tpu_torch.parallel.mesh import order_count_score
from sos_rt_tpu_torch.solver import PhaseTables


def make_batch(batch: int, device, seed: int = 0) -> Scene:
    """The tool's scenes: (ρ, τ*_aer, ω_aer) uniform in [0, 0.9), [0.01,
    0.4), [0.7, 1.0), drawn in that order from a torch.Generator seeded
    ``seed`` (on the CPU, so the draws do not depend on the device)."""
    gen = torch.Generator().manual_seed(seed)
    draw = lambda lo, hi: (lo + (hi - lo) * torch.rand(batch, generator=gen,
                                                       dtype=torch.float64)).to(device)
    return dataclasses.replace(broadcast_scene(Scene(), batch, device=device),
                               grd_alb=draw(0.0, 0.9), tau_star_aer=draw(0.01, 0.4),
                               alb_aer=draw(0.7, 1.0))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_case(scenes, tables, grid, opts, batch: int, block_b: int, sort: bool,
             device, reps: int = 3) -> dict:
    if sort:
        perm = torch.argsort(order_count_score(scenes), stable=True)
        scenes = scenes.map(lambda x: x[perm])

    def run(i):
        s = dataclasses.replace(scenes, grd_alb=scenes.grd_alb + i * 1e-7)
        sol = solve_batch(s, tables, grid, opts, engine="mega", block_b=block_b,
                          device=device)
        return float(sol.i_total[:, 0, :].sum())

    _sync(device)
    t0 = time.perf_counter()
    run(0)
    first_s = time.perf_counter() - t0
    times = []
    for i in range(1, reps + 1):
        _sync(device)
        t0 = time.perf_counter()
        run(i)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    print(f"block_b={block_b:4d} sort={int(sort)} : {batch / dt:10,.0f} col/s "
          f"({dt * 1e3:.0f} ms, first {first_s:.1f}s)", flush=True)
    return {"block_b": block_b, "sort": sort, "col_per_s": batch / dt, "ms": dt * 1e3,
            "first_s": first_s}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("block_b", type=int, nargs="*", default=[64])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=2, metavar=("NA", "NL"), default=(64, 128))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    grid = GridSpec(*args.grid)
    opts = SolverOptions(surface="lambertian", dtype="float32", max_orders=100,
                         scan_impl="sequential")
    tables = PhaseTables.from_models(grid, 0.5, atm=("rayleigh", {}), aer=("fwc", {}),
                                     dtype=torch.float32, device=device)
    scenes = make_batch(args.batch, device)
    return [run_case(scenes, tables, grid, opts, args.batch, b, sort, device)
            for b in args.block_b for sort in (False, True)]


if __name__ == "__main__":
    main()
