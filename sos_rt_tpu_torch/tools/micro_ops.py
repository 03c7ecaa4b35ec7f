"""Microbenchmark: per-op cost of the resident kernel's pass building blocks.

Counterpart of the JAX package's ``tools/micro_ops.py``.  For each pattern
(``ops/micro.py::PATTERNS``) it times one kernel call of K1 and one of K2
reps over the (128, 64, 128) float32 field (CUDA events, the least of
three calls) and prints the slope, (t(K2) − t(K1)) / (K2 − K1), as µs per
pass: launch, load and store cancel.  Beside it, the pass's bound on this
card (8 MiB of shared-memory traffic for the elementwise patterns, the
operations for the products) and the plain version's µs per pass (slope
over 1 and 5 reps).

usage: python -m sos_rt_tpu_torch.tools.micro_ops [pattern ...]
           [--k1 N] [--k2 N] [--device cpu]

``--device cpu`` runs the plain versions (for the tests): its times are the
CPU's.  The inputs are ``ops/micro.py::make_inputs(0)``, drawn as the JAX
tool draws them; the products and ``reduce`` grow the field by 11× to
129× a rep, so at K1 and K2 reps they run on inf/NaN (as the JAX tool's
did), which the card's float32 units and tensor cores take at full rate.
"""
from __future__ import annotations

import argparse

import torch

from sos_rt_tpu_torch.ops import micro
from sos_rt_tpu_torch.tools.card import HBM_BYTES_PER_S, PEAK_OPS, best_ms, smem_bytes_per_s

# the JAX tool's main() list, and matmul_high, which it left out
DEFAULT_PATTERNS = ("fma", "tworefs", "rowscalar", "rowscalar_slice", "lanemask",
                    "lanebrd", "exp", "reduce", "roll", "smooth", "matmul",
                    "matmul_def", "matmul_high")
FIELD_BYTES = micro.L * micro.C * micro.M2 * 4
VALUES = micro.L * micro.C * micro.M2
# multiplies, adds, compares and exponentials a value takes in one rep
ELEM_OPS = {"fma": 2, "rowscalar": 2, "rowscalar_slice": 2, "lanemask": 2,
            "tworefs": 2, "exp": 2, "lanebrd": 2, "reduce": 2, "roll": 1,
            "smooth": 8}
# the products' passes of bf16 (or float32) products
PRODUCT_PASSES = {"matmul": (1, "float32"), "matmul_high": (3, "bf16"),
                  "matmul_def": (1, "bf16")}
PLAIN_REPS = (1, 5)


def rep_flops(pat: str) -> tuple[float, str]:
    """Operations of one rep and their type."""
    if pat in PRODUCT_PASSES:
        passes, kind = PRODUCT_PASSES[pat]
        return 2.0 * micro.L * micro.C * micro.M2 * micro.M2 * passes, kind
    return float(ELEM_OPS[pat] * VALUES), "float32"


def pass_bound_us(pat: str, smem_rate: float) -> tuple[float, str]:
    """Least µs of one rep: the field read and written once through shared
    memory (tworefs reads b too) against its operations at the peak."""
    nbytes = FIELD_BYTES * (3 if pat == "tworefs" else 2)
    flops, kind = rep_flops(pat)
    t_b, t_o = nbytes / smem_rate * 1e6, flops / PEAK_OPS[kind] * 1e6
    return max(t_b, t_o), ("operations" if t_o > t_b else "bytes")


def call_bound_ms(pat: str, k: int) -> tuple[float, str]:
    """Least ms of one call of k reps: its inputs read and its output
    written once in device memory against k reps' operations."""
    nbytes = 2 * FIELD_BYTES
    if pat in ("rowscalar", "rowscalar_slice"):
        nbytes += micro.L * micro.C * 16 * 4
    if pat in PRODUCT_PASSES or pat == "lanebrd":
        nbytes += micro.M2 * micro.M2 * 4
    flops, kind = rep_flops(pat)
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, k * flops / PEAK_OPS[kind] * 1e3
    return max(t_b, t_o), ("operations" if t_o > t_b else "bytes")


def run(pat: str, inputs, device, k1: int, k2: int, smem_rate) -> dict:
    """Time pattern ``pat`` and print its line; returns the numbers."""
    xs, pk, a2 = inputs
    kw = {}
    if device.type == "cuda":
        kw = dict(split=micro.split_a2(a2), mu=micro.mu_up(device))
    t = {k: best_ms(lambda: micro.micro_ops_call(pat, k, xs[0], pk, a2, **kw), device)
         for k in (k1, k2)}
    per = (t[k2] - t[k1]) / (k2 - k1) * 1e3
    out = {"pattern": pat, "us_per_pass": per, "k1_ms": t[k1], "k2_ms": t[k2]}
    line = f"{pat:16s}: {per:8.3f} us/pass"
    if device.type == "cuda":
        p1, p2 = PLAIN_REPS
        tp = {k: best_ms(lambda: micro.micro_ops_plain(pat, k, xs[0], pk, a2), device)
              for k in PLAIN_REPS}
        bound, by = pass_bound_us(pat, smem_rate)
        out.update(plain_us_per_pass=(tp[p2] - tp[p1]) / (p2 - p1) * 1e3,
                   bound_us=bound, bound_by=by)
        line += (f"  bound {bound:7.3f} us ({by})  plain "
                 f"{out['plain_us_per_pass']:9.2f} us/pass")
    print(line, flush=True)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("patterns", nargs="*", default=list(DEFAULT_PATTERNS),
                    help=f"any of {', '.join(micro.PATTERNS)}")
    ap.add_argument("--k1", type=int, default=micro.K1)
    ap.add_argument("--k2", type=int, default=micro.K2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.k2 > args.k1 >= 0:
        ap.error("needs k2 > k1 >= 0")
    device = torch.device(args.device)
    inputs = micro.make_inputs(0, device)
    smem_rate, rate_src = (smem_bytes_per_s(device) if device.type == "cuda"
                           else (None, "plain versions on the CPU, not a card time"))
    print(f"field = ({micro.L},{micro.C},{micro.M2}) f32 = "
          f"{FIELD_BYTES / 2**20:.0f} MB; K1={args.k1} K2={args.k2} reps; "
          f"device {device}; shared memory: {rate_src}", flush=True)
    return [run(p, inputs, device, args.k1, args.k2, smem_rate) for p in args.patterns]


if __name__ == "__main__":
    main()
