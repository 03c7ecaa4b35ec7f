"""Per-stage timing attribution for the streamed mega engine.

Counterpart of the JAX package's ``tools/ablate_stream.py``.  Runs the
streamed whole solve (``ops/megastream.py::stream_order_loop``: passI, then
passA and passB an order) at the canonical 501×800 grid with a FIXED order
count (``noconv``) and removes stages one variant at a time (passA's and
passB's variants are the ablated builds of ``csrc/megastream_ablate.cu``);
the difference of the times attributes the time to the stages.  Results
are numerically wrong under ablation: timing only.

usage: python -m sos_rt_tpu_torch.tools.ablate_stream [orders] [batch]
           [--device cpu] [--grid NA NL]

The batch is the JAX tool's: Rayleigh with an HG (g = 0.7) aerosol layer,
µ0 = 0.5, Lambertian, float32 'bf16x3', ρ 0.05–0.6, τ*_aer 0.05–0.3 and
ω_aer 0.8–1.0 as linspaces over the columns.  ``orders`` (default 12, so
11 fixed orders after I₁) is max_orders, ``batch`` the columns (default
128: one block).  Each line gives the order loop's time (CUDA events
around ``stream_order_loop`` on the prepared batch, the least of three
runs), its kernels' device time (torch.profiler, one run; the base's by
kernel below the table), the wall of the whole ``solve_batch_mega`` call
that a user makes, and the share of the base's loop time and kernels'
time that the variant removes.  ``--device
cpu`` runs the plain versions (for the tests; keep the grid and the batch
small): its times are the CPU's, and it has no device time.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import prepare_batch, solve_batch_mega
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.parallel import broadcast_scene
from sos_rt_tpu_torch.solver import PhaseTables
from sos_rt_tpu_torch.tools import profile
from sos_rt_tpu_torch.tools.card import best_ms

GRID = GridSpec(nb_angles=501, nb_layers=800)
# the stages the JAX tool removes, each on top of 'noconv'
FLAGS = ("nosrc", "nosmooth", "nofin", "nopoly", "noloops", "nopassB", "nopassA,nopassB")


def variants() -> tuple:
    """The base ('noconv') and the tool's variants, in its order."""
    return ("noconv",) + tuple("noconv," + f for f in FLAGS)


def canonical_batch(batch: int, orders: int, device, grid: GridSpec = GRID):
    """(scenes, tables, opts) of the tool's batch on ``device``."""
    opts = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3",
                         max_orders=orders)
    tables = PhaseTables.from_models(grid, 0.5, atm=("rayleigh", {}),
                                     aer=("hg", {"g": 0.7}), dtype=torch.float32,
                                     device=device)
    lin = lambda lo, hi: torch.linspace(lo, hi, batch, dtype=torch.float64, device=device)
    scenes = dataclasses.replace(broadcast_scene(Scene(), batch, device=device),
                                 grd_alb=lin(0.05, 0.6), tau_star_aer=lin(0.05, 0.3),
                                 alb_aer=lin(0.8, 1.0))
    return scenes, tables, opts


def _synced_ms(fn, device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("orders", type=int, nargs="?", default=12)
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=2, metavar=("NA", "NL"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    grid = GridSpec(*args.grid) if args.grid else GRID
    scenes, tables, opts = canonical_batch(args.batch, args.orders, device, grid)
    block = min(args.batch, 128)
    sb = prepare_batch(scenes, tables, grid, opts, cols_per_block=block, device=device)
    loop_kw = dict(tol=float(opts.tol), max_orders=args.orders,
                   cols_per_block=sb.cols_per_block, outputs="summary")

    times, kernels, by_kernel, lost, walls = {}, {}, {}, {}, {}
    for ab in variants():
        loop = lambda: ms.stream_order_loop(sb.pack, sb.cpar, sb.tiles, sb.ops, **loop_kw,
                                            ablate=ab)
        times[ab] = best_ms(loop, device)
        t = profile.trace(loop, None, ab, device) if device.type == "cuda" else None
        by_kernel[ab] = t["kernels"] if t else {}
        lost[ab] = t["lost_launches"] if t else None
        kernels[ab] = (sum(k["ms"] for k in by_kernel[ab].values())
                       if device.type == "cuda" else None)
        walls[ab] = min(_synced_ms(lambda: solve_batch_mega(
            scenes, tables, grid, opts, cols_per_block=block, sort=False, mm="bf16x3",
            outputs="summary", allow_small=True, stream=True, device=device, ablate=ab),
            device) for _ in range(2))

    base, kbase = times["noconv"], kernels["noconv"]
    share = {ab: (base - times[ab]) / base for ab in variants()[1:]}
    kshare = ({ab: (kbase - kernels[ab]) / kbase for ab in variants()[1:]}
              if kbase else None)
    kstr = lambda ab: f"{kernels[ab]:8.2f}" if kernels[ab] is not None else "    none"
    print(f"streamed solve, {args.orders - 1} fixed orders, B={args.batch}, "
          f"{grid.nb_angles}x{grid.nb_layers}, device {device}:", flush=True)
    for ab in variants():
        line = (f"{ab:30s}: loop {times[ab]:8.2f} ms  kernels {kstr(ab)} ms  "
                f"(solve_batch_mega {walls[ab]:8.2f} ms)")
        if ab in share:
            line += f"  share {100 * share[ab]:5.1f}%"
            if kshare is not None:
                line += f" of the loop, {100 * kshare[ab]:5.1f}% of the kernels"
        print(line, flush=True)
    for name, k in by_kernel["noconv"].items():
        print(f"  noconv's kernel {name[:40]:40s}: {k['ms']:8.3f} ms ({k['calls']} calls)",
              flush=True)
    return {"orders": args.orders, "batch": args.batch,
            "grid": [grid.nb_angles, grid.nb_layers], "device": str(device),
            "ms": times, "kernels_ms": kernels, "solve_ms": walls, "share": share,
            "kernel_share": kshare, "by_kernel": by_kernel, "lost_launches": lost}


if __name__ == "__main__":
    main()
