"""Kernels or solves of two checkouts on the same inputs, in turns, on one card.

usage: python -m sos_rt_tpu_torch.tools.ab_kernels OTHER
           [--what mega|stream|sweeps|sweeps_fwc|canonical|fused_canonical|fused_sweep|micro]
           [--rounds N]

OTHER is the root of another checkout of this repository (an earlier
commit, unpacked with ``git archive``; it needs its ``chip_smoke.py`` and
``sos_rt_tpu_torch/``).  Each turn runs, in a process of its own from a
checkout's root and with that checkout's ``chip_smoke`` helpers and
kernels, kernel wrappers or a whole solve on inputs made from
``chip_smoke.SEED``:

- ``mega``   ``mega_call`` on the 4096-column 64×128 sweep batch of
             ``chip_smoke.fwc_batch`` (float32 bf16x3, sorted by the
             predictor as the solve sorts it, 4 columns a tile);
- ``stream`` passI, passA and passB at the canonical block of phase
             ``canonical`` (the ``hg`` preset, 501×800, 128 columns, float32
             bf16x3, Lambertian);
- ``sweeps`` down_sweep and up_sweep_smooth at the block of phase
             ``fused_canonical`` (501×800, τ*_atm = 0.044, B=64, float32);
- ``sweeps_fwc`` the same two at the block of phase ``fused_sweep`` (the
             4096-column 64×128 sweep batch of ``chip_smoke.fwc_batch``,
             float32);
- ``canonical``, ``fused_canonical``  the whole solve of that phase
             (``solve_batch(engine="mega", outputs="summary")``, B=256 in
             two 128-column blocks, or B=64 through the fused engine);
- ``fused_sweep`` the whole fused solve of phase ``fused_sweep`` (the
             4096-column sweep batch, ``engine="fused"``, full outputs,
             ``sort="predict"``);
- ``micro``  the tools' kernels: every micro_ops pattern's slope between
             K1 and K2 reps (each call the least of three), every
             micro_pass pair's time a call, one call alone (the least of
             three) and the card's own (``tools/card.py::queued_ms``),
             all in µs a pass and the median of three; smooth's first rep
             (``ops smooth rep 1``: k = 1 less k = 0, queued), where the
             walk's first index lies near the row's end, as the tool's
             later reps stop it at 2; and whether each output (micro_ops
             at k = 1 and 2, micro_pass on a field of ones and a random
             one) has the other checkout's bits.

A kernel's time is the least of three timings of three launches each
(CUDA events); a solve's is the least of three walls on the host clock,
each ending in a synchronise, after one warm-up solve.  The turns go
OTHER, this, this, OTHER, ``rounds`` times, so that a drift of the card's
clocks falls on both alike.  One JSON line per turn, then one with the
medians per kernel.  Each checkout builds its kernel libraries in its own
``build/`` at its first turn.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

from sos_rt_tpu_torch.tools import card

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETUP = r"""
import dataclasses, json, statistics, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev = torch.device("cuda")
best = lambda fn: min(cs.timed(fn, 3) for _ in range(3))
unit, bits = "ms", {}
"""

TURNS = {
    "mega": r"""
from sos_rt_tpu_torch import fused
from sos_rt_tpu_torch.fused import prepare_batch, take_columns
from sos_rt_tpu_torch.ops import megakernel as mk

preset, scenes, tables = cs.fwc_batch(dev)
t32 = tables[torch.float32]
key = fused.sort_key(scenes, t32, preset.grid, preset.opts, "predict", dev)
cb = mk.default_cols_per_tile(mk.pad_angles(preset.grid.nb_angles))
sb = prepare_batch(take_columns(scenes, torch.argsort(key, stable=True)), t32,
                   preset.grid, preset.opts, cols_per_block=cb, device=dev)
kw = dict(tol=float(preset.opts.tol), max_orders=int(preset.opts.max_orders), full=False)
calls = {"mega_call": lambda: mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)}
""",
    "stream": r"""
from sos_rt_tpu_torch.config import SolverOptions
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.presets import get_preset
from sos_rt_tpu_torch.solver import PhaseTables

preset = get_preset("hg")
opts = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3")
scenes = cs.random_scenes(preset, 128, dev, np.random.default_rng(cs.SEED))
tables = PhaseTables.from_models(preset.grid, 0.5, atm=preset.atm, aer=preset.aer,
                                 dtype=torch.float32, device=dev)
(pack, cpar, tiles), ops = cs.block_inputs(scenes, tables, preset.grid, opts, dev,
                                           cols_per_block=128)
fdn, fup = ms.passI(pack, tiles, cpar, ops)
sdn, jn = ms.passA(pack, fdn, fup, ops)
calls = {"passI": lambda: ms.passI(pack, tiles, cpar, ops),
         "passA": lambda: ms.passA(pack, fdn, fup, ops),
         "passB": lambda: ms.passB(pack, sdn, jn, cpar, ops)}
""",
    "sweeps": r"""
from sos_rt_tpu_torch.config import SolverOptions
from sos_rt_tpu_torch.fused import FusedBatch
from sos_rt_tpu_torch.presets import get_preset
from sos_rt_tpu_torch.solver import PhaseTables

preset = get_preset("hg")
opts = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3")
scenes = dataclasses.replace(
    cs.random_scenes(preset, 64, dev, np.random.default_rng(cs.SEED)),
    tau_star_atm=torch.full((64,), 0.044, dtype=torch.float64, device=dev))
tables = PhaseTables.from_models(preset.grid, 0.5, atm=preset.atm, aer=preset.aer,
                                 dtype=torch.float32, device=dev)
fb = FusedBatch(scenes, tables, preset.grid, opts, dev)
calls = {k: kern for k, (kern, _) in cs.sweep_calls(fb, cs.second_order_source(fb)).items()}
""",
    "sweeps_fwc": r"""
from sos_rt_tpu_torch.fused import FusedBatch

preset, scenes, tables = cs.fwc_batch(dev)
fb = FusedBatch(scenes, tables[torch.float32], preset.grid, preset.opts, dev)
calls = {k: kern for k, (kern, _) in cs.sweep_calls(fb, cs.second_order_source(fb)).items()}
""",
}

# every micro_ops pattern's slope, every micro_pass pair's time a call (one
# call, and the card's own: card.queued_ms, whose source the turn carries,
# since the other checkout's card.py may lack it) in µs a pass, smooth's
# first rep, and a digest of each output at k = 1 and 2 (micro_pass: the
# tool's field of ones and a random one), so that the checkouts' bits compare
TURNS["micro"] = (
    f"QUEUED_RUN, QUEUE_SPIN_CYCLES = {card.QUEUED_RUN}, {card.QUEUE_SPIN_CYCLES}\n"
    + inspect.getsource(card.queued_ms) + r"""
import hashlib
from sos_rt_tpu_torch.ops import micro

unit = "us_per_pass"
xs, pk, a2 = micro.make_inputs(0, dev)
kw = dict(split=micro.split_a2(a2), mu=micro.mu_up(dev))
ones = torch.ones_like(xs[0])
ops = lambda pat, k: micro.micro_ops_call(pat, k, xs[0], pk, a2, **kw)
timed = lambda fn: min(cs.timed(fn, 1) for _ in range(3))


def slope(pat):
    return lambda: ((timed(lambda: ops(pat, micro.K2)) - timed(lambda: ops(pat, micro.K1)))
                    / (micro.K2 - micro.K1) * 1e3)


def per_pass(mode, g, clock):
    return lambda: clock(lambda: micro.micro_pass_call(mode, g, ones)) / micro.K * 1e3


digest = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
calls = {f"ops {pat}": slope(pat) for pat in micro.PATTERNS}
calls["ops smooth rep 1"] = lambda: (queued_ms(lambda: ops("smooth", 1))
                                     - queued_ms(lambda: ops("smooth", 0))) * 1e3
calls.update({f"pass {mode} {g}": per_pass(mode, g, timed) for mode, g in micro.PASS_PAIRS})
calls.update({f"pass {mode} {g} queued": per_pass(mode, g, queued_ms)
              for mode, g in micro.PASS_PAIRS})
bits = {f"ops {pat} k={k}": digest(ops(pat, k)) for pat in micro.PATTERNS for k in (1, 2)}
bits.update({f"pass {mode} {g} {name}": digest(micro.micro_pass_call(mode, g, x))
             for mode, g in micro.PASS_PAIRS for name, x in (("ones", ones), ("rand", xs[1]))})
best = lambda fn: statistics.median(fn() for _ in range(3))
""")

CELL = r"""
from sos_rt_tpu_torch.config import SolverOptions
from sos_rt_tpu_torch.parallel import solve_batch
from sos_rt_tpu_torch.presets import get_preset
from sos_rt_tpu_torch.solver import PhaseTables

preset = get_preset("hg")
opts = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3")
scenes = cs.random_scenes(preset, B, dev, np.random.default_rng(cs.SEED))
if TAU_ATM is not None:
    scenes = dataclasses.replace(scenes, tau_star_atm=torch.full(
        (B,), TAU_ATM, dtype=torch.float64, device=dev))
tables = PhaseTables.from_models(preset.grid, 0.5, atm=preset.atm, aer=preset.aer,
                                 dtype=torch.float32, device=dev)
solve = lambda: solve_batch(scenes, tables, preset.grid, opts, engine="mega",
                            outputs="summary", device=dev, **KW)
"""
WALL = r"""

def wall():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


best = lambda fn: min(fn() for _ in range(3))
solve()
calls = {"solve": wall}
"""
TURNS["canonical"] = ("import time\nB, TAU_ATM, KW = 256, None, dict(cols_per_block=128)\n"
                      + CELL + WALL)
TURNS["fused_canonical"] = "import time\nB, TAU_ATM, KW = 64, 0.044, {}\n" + CELL + WALL
TURNS["fused_sweep"] = r"""
import time
from sos_rt_tpu_torch.parallel import solve_batch

preset, scenes, tables = cs.fwc_batch(dev)
solve = lambda: solve_batch(scenes, tables[torch.float32], preset.grid, preset.opts,
                            engine="fused", sort="predict", device=dev)
""" + WALL

REPORT = r"""
out = {name: best(fn) for name, fn in calls.items()}
print(json.dumps({unit: out, "bits": bits, "device": torch.cuda.get_device_name(0)}))
"""


def turn(root: str, what: str) -> dict:
    env = dict(os.environ, SOS_RT_CACHE_DIR=os.path.join(root, "build", "tables"))
    out = subprocess.run([sys.executable, "-c", SETUP + TURNS[what] + REPORT], cwd=root,
                         env=env, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"ab_kernels: the turn in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--what", choices=sorted(TURNS), default="mega")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    times, bits = {"this": {}, "other": {}}, {}
    unit = "us_per_pass" if args.what == "micro" else "ms"
    for _ in range(args.rounds):
        for who, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
            rec = {"checkout": who, "what": args.what, **turn(root, args.what)}
            for name, t in rec[unit].items():
                times[who].setdefault(name, []).append(t)
            bits[who] = rec.pop("bits")
            print(json.dumps(rec), flush=True)
    summary = {f"{who}_{unit}": {k: statistics.median(v) for k, v in t.items()}
               for who, t in times.items()}
    if bits["this"]:
        summary["same_bits"] = {k: v == bits["other"].get(k) for k, v in bits["this"].items()}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
