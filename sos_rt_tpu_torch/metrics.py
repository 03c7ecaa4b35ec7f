"""Structured per-solve metrics (counterpart of ``sos_rt_tpu/metrics.py``).

Order-count statistics, convergence counts and, given a wall time,
columns per second, as one dict.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def solution_metrics(sol, wall_s: float | None = None,
                     n_devices: int = 1) -> Dict[str, Any]:
    """Metrics dict from a Solution or SweepSummary."""
    n_orders = torch.atleast_1d(torch.as_tensor(sol.n_orders)).cpu()
    converged = torch.atleast_1d(torch.as_tensor(sol.converged)).cpu()
    batch = int(n_orders.shape[0])
    n_conv = int(converged.sum())
    m: Dict[str, Any] = {
        "batch": batch,
        "orders_max": int(n_orders.max()),
        "orders_mean": float(n_orders.to(torch.float32).mean()),
        "n_converged": n_conv,
        "n_unconverged": batch - n_conv,
    }
    if wall_s is not None:
        m["wall_s"] = round(float(wall_s), 4)
        if wall_s > 0:
            m["col_per_s"] = round(batch / wall_s, 1)
            m["col_per_s_per_chip"] = round(batch / wall_s / max(n_devices, 1), 1)
        m["n_devices"] = n_devices
    return m


def block_until_ready(sol):
    """Wait until the device has finished computing a Solution or
    SweepSummary (for wall-clock measurement); nothing to wait for on the
    CPU.  Returns ``sol``."""
    device = torch.as_tensor(sol.n_orders).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return sol
