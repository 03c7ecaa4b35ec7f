"""Phase tables and the solution container.

Counterpart of the data classes of ``sos_rt_tpu/solver.py``.  The
per-column reference solver ``solve_column`` is a later slice of the port
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sos_rt_tpu_torch.config import GridSpec, resolve_device


@dataclasses.dataclass(frozen=True)
class PhaseTables:
    """Phase-function tables as tensors: P0 (2M,) or (B, 2M) per species,
    P (2M, 2M) per species."""

    p0_atm: Any
    p_atm: Any
    p0_aer: Any
    p_aer: Any

    @classmethod
    def from_models(cls, grid: GridSpec, mu0: float, atm=("rayleigh", {}),
                    aer=("rayleigh", {}), dtype=torch.float64, device=None,
                    cache: bool = True):
        from sos_rt_tpu_torch.models import build_phase_tables

        device = resolve_device(device)
        mu = grid.mu()
        p0a, pa = build_phase_tables(atm[0], mu, mu0, cache=cache, **atm[1])
        p0r, pr = build_phase_tables(aer[0], mu, mu0, cache=cache, **aer[1])
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in (p0a, pa, p0r, pr)))

    @classmethod
    def from_models_batched_mu0(cls, grid: GridSpec, mu0_values,
                                atm=("rayleigh", {}), aer=("rayleigh", {}),
                                dtype=torch.float64, device=None,
                                cache: bool = True):
        """Tables for a µ0 sweep: P0 gets a leading (B,) axis (one row per
        column's µ0), the P matrices are built once and shared."""
        from sos_rt_tpu_torch.models import build_phase_tables

        device = resolve_device(device)
        mu = grid.mu()
        mu0_values = np.asarray(mu0_values, dtype=np.float64)
        build = lambda spec, m0: build_phase_tables(spec[0], mu, float(m0),
                                                    cache=cache, **spec[1])
        pa = build(atm, mu0_values[0])[1]
        pr = build(aer, mu0_values[0])[1]
        p0a = np.stack([build(atm, m0)[0] for m0 in mu0_values])
        p0r = np.stack([build(aer, m0)[0] for m0 in mu0_values])
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in (p0a, pa, p0r, pr)))

    def take(self, idx) -> "PhaseTables":
        """Columns ``idx`` of per-column (B, 2M) P0 tables; shared tables
        are returned unchanged."""
        if self.p0_atm.dim() != 2:
            return self
        return dataclasses.replace(self, p0_atm=self.p0_atm[idx],
                                   p0_aer=self.p0_aer[idx])


@dataclasses.dataclass(frozen=True)
class Solution:
    """Radiance solution for a batch of columns."""

    i_total: Any       # (B, L, 2M) total radiance field
    i1: Any            # (B, L, 2M) first order, or None
    n_orders: Any      # (B,) int32
    converged: Any     # (B,) bool
    tau: Any           # (B, L)
    idx_up: Any
    idx_down: Any
