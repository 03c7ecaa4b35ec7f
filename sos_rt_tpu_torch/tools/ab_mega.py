"""mega_call of two checkouts on the same batch, in turns, on one card.

usage: python -m sos_rt_tpu_torch.tools.ab_mega OTHER [--rounds N]

OTHER is the root of another checkout of this repository (an earlier
commit, unpacked with ``git archive``; it needs its ``chip_smoke.py`` and
``sos_rt_tpu_torch/``).  Each turn runs, in a process of its own from a
checkout's root, that checkout's ``mega_call`` on the 4096-column 64×128
sweep batch of its ``chip_smoke.fwc_batch`` (float32 bf16x3, sorted by the
predictor as the solve sorts it, 4 columns a tile) and reports the least of
three timings of three launches each (CUDA events), with the batch's order
counts.  The turns go OTHER, this, this, OTHER, ``rounds`` times, so that a
drift of the card's clocks falls on both alike.  One JSON line per turn,
then one with the medians.  Each checkout builds its kernel library in its
own ``build/`` at its first turn.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TURN = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from sos_rt_tpu_torch import fused
from sos_rt_tpu_torch.fused import prepare_batch, take_columns
from sos_rt_tpu_torch.ops import megakernel as mk

dev = torch.device("cuda")
preset, scenes, tables = cs.fwc_batch(dev)
t32 = tables[torch.float32]
key = fused.sort_key(scenes, t32, preset.grid, preset.opts, "predict", dev)
cb = mk.default_cols_per_tile(mk.pad_angles(preset.grid.nb_angles))
sb = prepare_batch(take_columns(scenes, torch.argsort(key, stable=True)), t32,
                   preset.grid, preset.opts, cols_per_block=cb, device=dev)
kw = dict(tol=float(preset.opts.tol), max_orders=int(preset.opts.max_orders), full=False)
call = lambda: mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
ms = min(cs.timed(call, 3) for _ in range(3))
n = call()[-1][mk.ST_N]
print(json.dumps({"ms": ms, "orders_mean": float(n.mean()), "orders_max": float(n.max()),
                  "device": torch.cuda.get_device_name(0)}))
"""


def turn(root: str) -> dict:
    env = dict(os.environ, SOS_RT_CACHE_DIR=os.path.join(root, "build", "tables"))
    out = subprocess.run([sys.executable, "-c", TURN], cwd=root, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"ab_mega: the turn in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    times = {"this": [], "other": []}
    for _ in range(args.rounds):
        for who, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
            rec = {"checkout": who, **turn(root)}
            times[who].append(rec["ms"])
            print(json.dumps(rec), flush=True)
    print(json.dumps({"this_ms": statistics.median(times["this"]),
                      "other_ms": statistics.median(times["other"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
