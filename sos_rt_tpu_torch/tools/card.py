"""The card's peak rates and the timer the tools share.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit):
3.35 TB/s of device memory, 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s float32 and float64 outside them.  Shared memory moves 128 bytes a
clock on each SM (the Hopper tuning guide), so its rate is the SM count
times 128 B times the SM clock that ``nvidia-smi`` reports as the card's
maximum.
"""
from __future__ import annotations

import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "float32": 67e12, "float64": 67e12}
SMEM_BYTES_PER_CLOCK = 128          # per SM
DATASHEET_SM_CLOCK_HZ = 1.98e9      # H100 SXM maximum boost clock


def nvidia_smi(query: str) -> str:
    """The first card's answer to ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def smem_bytes_per_s(device) -> tuple[float, str]:
    """The card's shared-memory rate (bytes/s) and where its clock came
    from: ``nvidia-smi``'s clocks.max.sm, else the data sheet's."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    try:
        hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
        src = "nvidia-smi clocks.max.sm"
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        hz, src = DATASHEET_SM_CLOCK_HZ, "data sheet"
    return sms * SMEM_BYTES_PER_CLOCK * hz, f"{sms} SMs x 128 B x {hz / 1e6:.0f} MHz ({src})"


def best_ms(fn, device, reps: int = 3) -> float:
    """The least time of ``reps`` calls of ``fn`` after one warm-up call,
    in ms: CUDA events around each call on a card, the host clock on the
    CPU."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


# calls of a queued run, and the cycles the card spins before it (~10 ms
# at 1.98 GHz, longer than the host takes to queue the run)
QUEUED_RUN = 20
QUEUE_SPIN_CYCLES = 20_000_000


def queued_ms(fn, reps: int = 3) -> float:
    """The card's own time of a call of ``fn``, in ms: the least of ``reps``
    runs of QUEUED_RUN calls queued behind a spin of the card
    (``torch.cuda._sleep``), each over its calls, after one warm-up call.
    The calls run back to back, so the host's dispatch of each, which one
    call alone (:func:`best_ms`) carries, stays out."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        start.record()
        for _ in range(QUEUED_RUN):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / QUEUED_RUN)
    return best
