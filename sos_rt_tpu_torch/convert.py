"""Carry inputs across from the JAX package (or plain numpy arrays).

Each function reads its argument's fields by name through ``np.asarray``
— a ``sos_rt_tpu`` GridSpec / Scene / PhaseTables / SolverOptions, or
any object with the same field names — and builds this package's
counterpart, so both packages can solve the same inputs.  Nothing of the
JAX package is imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from sos_rt_tpu_torch.config import (SCENE_FIELDS, GridSpec, Scene,
                                     SolverOptions, resolve_device)
from sos_rt_tpu_torch.solver import PhaseTables


def grid_from(grid) -> GridSpec:
    return GridSpec(nb_angles=int(grid.nb_angles), nb_layers=int(grid.nb_layers),
                    spacing=str(getattr(grid, "spacing", "uniform")))


def scene_from(scene, device=None) -> Scene:
    """Scene with float64 tensors (scalars stay 0-d) on ``device``."""
    device = resolve_device(device)
    return Scene(**{f: torch.as_tensor(np.array(getattr(scene, f), np.float64),
                                       device=device) for f in SCENE_FIELDS})


def tables_from(tables, dtype=torch.float64, device=None) -> PhaseTables:
    device = resolve_device(device)
    conv = lambda x: torch.as_tensor(np.array(x, np.float64), dtype=dtype,
                                     device=device)
    return PhaseTables(p0_atm=conv(tables.p0_atm), p_atm=conv(tables.p_atm),
                       p0_aer=conv(tables.p0_aer), p_aer=conv(tables.p_aer))


def options_from(opts) -> SolverOptions:
    """SolverOptions from one with the same fields (``scan_impl`` taken as
    'associative' where ``opts`` has none)."""
    return SolverOptions(surface=str(opts.surface), max_orders=int(opts.max_orders),
                         tol=float(opts.tol), dtype=str(opts.dtype),
                         scan_impl=str(getattr(opts, "scan_impl", "associative")),
                         mm=None if opts.mm is None else str(opts.mm))
