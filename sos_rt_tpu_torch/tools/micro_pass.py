"""Microbenchmark: cost of one full-field pass in shared memory.

Counterpart of the JAX package's ``tools/micro_pass.py``.  Times K = 64
elementwise passes (a ← a·1.0001 + 0.5) over the (128, 64, 128) float32
field inside one kernel call, for each loop structure of the TPU tool:
``flat`` (one pass over a block's rows, then a barrier), ``chunk g`` (a
runtime loop over chunks of g layers, a barrier each), ``static g`` (the
same loop unrolled at compile time), ``chunk2d g`` (as ``chunk``: the
TPU's reshape has no counterpart).  Prints the call's ms (CUDA events,
least of three), µs per pass, the effective GB/s of 8 MiB a pass (read +
write), the pass's bound through shared memory, the plain version's ms
and the card's own ms a call (``tools/card.py::queued_ms``: calls queued
back to back, without the host's dispatch of each, which one call
carries).

usage: python -m sos_rt_tpu_torch.tools.micro_pass [--device cpu]

``--device cpu`` runs the plain versions (for the tests): its times are the
CPU's.
"""
from __future__ import annotations

import argparse

import torch

from sos_rt_tpu_torch.ops import micro
from sos_rt_tpu_torch.tools.card import best_ms, queued_ms, smem_bytes_per_s

PASS_BYTES = micro.L * micro.C * micro.M2 * 4 * 2      # read + write


def run(mode: str, g: int, x, device, smem_rate) -> dict:
    """Time one (mode, g) pair and print its line; returns the numbers."""
    ms = best_ms(lambda: micro.micro_pass_call(mode, g, x), device)
    per = ms / micro.K * 1e3
    out = {"mode": mode, "g": g, "ms": ms, "us_per_pass": per,
           "gb_per_s": PASS_BYTES / (per * 1e-6) / 1e9}
    line = (f"{mode:8s} g={g:3d}: {ms:7.3f} ms total, {per:7.3f} us/pass, "
            f"{out['gb_per_s']:6.0f} GB/s eff")
    if device.type == "cuda":
        out.update(bound_us=PASS_BYTES / smem_rate * 1e6,
                   plain_ms=best_ms(lambda: micro.micro_pass_plain(mode, g, x), device),
                   queued_ms=queued_ms(lambda: micro.micro_pass_call(mode, g, x)))
        line += (f", bound {out['bound_us']:6.3f} us/pass, plain {out['plain_ms']:7.3f} ms, "
                 f"queued {out['queued_ms']:7.3f} ms")
    print(line, flush=True)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    x = torch.ones((micro.L, micro.C, micro.M2), dtype=torch.float32, device=device)
    smem_rate, rate_src = (smem_bytes_per_s(device) if device.type == "cuda"
                           else (None, "plain versions on the CPU, not a card time"))
    print(f"field = ({micro.L},{micro.C},{micro.M2}) f32 = "
          f"{PASS_BYTES / 2 / 2**20:.0f} MB; K={micro.K} passes (read+write); "
          f"device {device}; shared memory: {rate_src}", flush=True)
    return [run(mode, g, x, device, smem_rate) for mode, g in micro.PASS_PAIRS]


if __name__ == "__main__":
    main()
