"""The card: its name, count and power limit, and the published peaks
that every roofline is stated against.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32
and float64 outside them, 3.35 TB/s of device memory.  A card set below
700 W runs slower under load, so every run reports ``power.limit``.
"""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "float32": 67e12, "float64": 67e12}
SPLIT_PASSES = {"bf16x3": 3, "bf16x5": 5, "highest": 1}


def power_limits() -> list:
    """Each card's ``nvidia-smi`` name and ``power.limit``, or [] where
    nvidia-smi does not answer."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.stdout.strip().splitlines()]
