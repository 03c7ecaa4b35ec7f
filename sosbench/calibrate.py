"""The readings that a cell's ``check.limits`` are set from, on the card.

usage: python3 sosbench/calibrate.py --workload <cell> [--seeds 12]
           [--control-seeds 3] [--requests N] [--first-seed S] [--out FILE]

For each seed, in one process: a short window of the cell's own requests
(``--requests``, default the cell's traced count) through the program,
then the check's numbers of a sample of its answers against the float64
reference (``check.numbers``): the lower readings.  On the first
``--control-seeds`` seeds also the control, the reference put in the
program's place in the precision one step below the configuration's
(float32 with TF32 products, ``reference/precision.py``), on the same
scenes: the upper readings.  Prints one JSON line a seed and appends it to
``--out``.  One card; cells on several cards are read on one card (their
answers are the same computation sharded).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["SOS_RT_CACHE_DIR"] = os.path.join(ROOT, "build", "sosbench", "phase_tables")

from sosbench import check, spec  # noqa: E402


def readings(cell, seed: int, requests: int, control: bool, device) -> dict:
    import torch

    entry = cell.entry().Entry(cell, seed, device, None)
    try:
        entry.warm()
        for _ in range(requests):
            entry.step()
        entry.release()
        torch.cuda.empty_cache()
        wl = cell.workload
        scenes, answers, p0_mu0 = entry.sample(int(wl["check"]["columns"]))
        block = int(wl["check"].get("block", 64))
        ref = check.reference(cell.config, scenes, p0_mu0, device, block=block,
                              base=cell.base)
        out = {"seed": seed, "columns": len(p0_mu0), "program": check.numbers(answers, ref)}
        if control:
            ctl = check.reference(cell.config, scenes, p0_mu0, device, dtype="float32",
                                  products="tf32", block=block, base=cell.base)
            out["control"] = check.numbers(ctl, ref)
        return out
    finally:
        close = getattr(entry, "close", None)
        if close:
            close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload, spec.benchmark(ROOT))
    requests = args.requests or int(cell.workload["trace"]["requests"])
    for i in range(args.seeds):
        t0 = time.perf_counter()
        r = readings(cell, args.first_seed + 7919 * i, requests, i < args.control_seeds,
                     torch.device("cuda"))
        r["workload"], r["s"] = cell.name, time.perf_counter() - t0
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
