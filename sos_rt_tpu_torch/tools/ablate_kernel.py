"""Per-stage timing attribution for the resident whole-loop kernel.

Counterpart of the JAX package's ``tools/ablate_kernel.py``.  Runs the
kernel (``ops/megakernel.py::mega_call``) with a FIXED order count
(``noconv``) on the 64×128 FWC batch and removes stages one variant at a
time (``megakernel.ABLATE_VARIANTS``, built by ``csrc/mega_ablate.cuh``);
the difference of the times attributes the time to the stages.  Results
are numerically wrong under ablation: timing only.

usage: python -m sos_rt_tpu_torch.tools.ablate_kernel [orders] [block] [batch]
           [--device cpu]

``orders`` (default 16) is max_orders, ``block`` the columns a thread
block's tile holds (default: the kernel's own, 4 at this grid), ``batch``
the columns (default 4096).  Each line gives the kernel's time (CUDA
events, the least of three launches on the prepared batch) and, beside it,
the wall time of the whole ``solve_batch_mega`` call that a user makes.
``--device cpu`` runs the plain version (for the tests; keep the batch
small): its times are the CPU's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import prepare_batch, solve_batch_mega
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.parallel import broadcast_scene
from sos_rt_tpu_torch.solver import PhaseTables
from sos_rt_tpu_torch.tools.card import best_ms

GRID = GridSpec(nb_angles=64, nb_layers=128)


def fwc_batch(batch: int, orders: int, device):
    """The tool's batch: rayleigh + FWC tables at µ0 = 0.5, float32,
    Lambertian, (ρ, τ*_aer, ω_aer) drawn per column from seed 0."""
    opts = SolverOptions(surface="lambertian", dtype="float32", max_orders=orders)
    tables = PhaseTables.from_models(GRID, 0.5, atm=("rayleigh", {}), aer=("fwc", {}),
                                     dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    t = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, batch), device=device)
    scenes = dataclasses.replace(broadcast_scene(Scene(), batch, device=device),
                                 grd_alb=t(0.0, 0.9), tau_star_aer=t(0.01, 0.4),
                                 alb_aer=t(0.7, 1.0))
    return scenes, tables, opts


def _synced(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("orders", type=int, nargs="?", default=16)
    ap.add_argument("block", type=int, nargs="?", default=None)
    ap.add_argument("batch", type=int, nargs="?", default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    scenes, tables, opts = fwc_batch(args.batch, args.orders, device)
    block = args.block or mk.default_cols_per_tile(mk.pad_angles(GRID.nb_angles))
    sb = prepare_batch(scenes, tables, GRID, opts, cols_per_block=block, device=device)
    kw = dict(tol=float(opts.tol), max_orders=args.orders, full=False, cols_per_tile=block)

    times, walls = {}, {}
    for ab in mk.ABLATE_VARIANTS:
        times[ab] = best_ms(lambda: mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops,
                                                 ablate=ab, **kw), device)
        walls[ab] = min(_synced(lambda: solve_batch_mega(
            scenes, tables, GRID, opts, cols_per_block=block, sort=False,
            outputs="summary", stream=False, device=device, ablate=ab), device)
            for _ in range(2))
        print(f"{ab:42s}: {times[ab]:8.2f} ms  {args.batch / times[ab] * 1e3:10,.0f} "
              f"col/s  (solve_batch_mega {walls[ab]:8.2f} ms)", flush=True)

    full = times["noconv"]
    print(f"\nper-stage share of the full {full:.2f} ms "
          f"({args.orders} orders, block={block}, B={args.batch}, device {device}):")
    shares = {}
    for ab in mk.ABLATE_VARIANTS[1:]:
        stage = ",".join(ab.split(",")[1:])
        shares[stage] = full - times[ab]
        print(f"  {stage:28s}: {shares[stage]:7.2f} ms ({100 * shares[stage] / full:5.1f}%)")
    return {"orders": args.orders, "block": block, "batch": args.batch,
            "ms": times, "solve_ms": walls, "stage_ms": shares}


if __name__ == "__main__":
    main()
