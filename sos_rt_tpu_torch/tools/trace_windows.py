"""Count the profiler windows that lose the device record of a launch.

usage: python -m sos_rt_tpu_torch.tools.trace_windows [windows]
           [--opening S ...] [--device cpu] [--grid NA NL]

Traces ``tools/ablate_stream.py``'s streamed solve (one block of 128
columns, 12 orders, ``noconv`` and ``noconv,nosrc`` in turn) ``windows``
times each through ``tools/profile.py::trace``, at each ``--opening``: the
seconds between the recorded step's opening launch and the recorded call
(default 0 and ``profile.OPENING_S``).  For each opening it prints the
windows whose trace lacks a launch call's device record
(``lost_launches``) and the windows short of the loop's product launches
(passI's and each passA's, ``quad_mma``), with each base window's busy
share.  ``--device cpu`` runs the plain versions (for the tests): no device
records, so nothing is lost or counted short.
"""
from __future__ import annotations

import argparse

import torch

from sos_rt_tpu_torch.config import GridSpec
from sos_rt_tpu_torch.fused import prepare_batch
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.tools import ablate_stream, profile

ORDERS = 12
VARIANTS = ("noconv", "noconv,nosrc")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("windows", type=int, nargs="?", default=100)
    ap.add_argument("--opening", type=float, nargs="+", default=[0.0, profile.OPENING_S])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=2, metavar=("NA", "NL"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    grid = GridSpec(*args.grid) if args.grid else ablate_stream.GRID
    scenes, tables, opts = ablate_stream.canonical_batch(128, ORDERS, device, grid)
    sb = prepare_batch(scenes, tables, grid, opts, cols_per_block=128, device=device)
    kw = dict(tol=float(opts.tol), max_orders=ORDERS, cols_per_block=128,
              outputs="summary")
    out = {}
    for opening in args.opening:
        res = {"windows": 0, "lost": 0, "short": 0, "busy_share": []}
        for _ in range(args.windows):
            for ab in VARIANTS:
                loop = lambda: ms.stream_order_loop(sb.pack, sb.cpar, sb.tiles, sb.ops,
                                                    **kw, ablate=ab)
                t = profile.trace(loop, None, ab, device, opening=opening)
                products = sum(k["calls"] for name, k in t["kernels"].items()
                               if "quad_mma" in name)
                want = 1 + (0 if "nosrc" in ab else ORDERS - 1)
                res["windows"] += 1
                res["lost"] += t["lost_launches"] > 0
                res["short"] += device.type == "cuda" and products != want
                if ab == "noconv":
                    res["busy_share"].append(t["busy_share"])
        out[opening] = res
        print(f"opening {opening:.3f} s: {res['windows']} windows, {res['lost']} lost a "
              f"launch's device record, {res['short']} short of the product launches",
              flush=True)
    return out


if __name__ == "__main__":
    main()
