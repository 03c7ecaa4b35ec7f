"""How ``correct`` is decided: the program's answers against the plain
reference (``reference/``), run in float64 on the same scenes with tables
of its own.

The numbers compared (a cell's ``check.limits`` names those it holds to a
limit):

- ``rows_p50``: the median, over every value of the sampled columns' TOA
  and surface rows that the reference gives as non-zero, of |program −
  reference| / the column's scale (the largest |value| of its two
  reference rows);
- ``rows_p99``, ``rows_max``: the 99th percentile and the largest of the
  same;
- ``orders_off``: the share of sampled columns whose order count or
  convergence flag differs from the reference's.
"""
from __future__ import annotations

import numpy as np

from sosbench import spec
from sosbench.reference import grid as ref_grid
from sosbench.reference import phase, precision, solver

ROWS = ("i_toa", "i_surface")


def reference(config: dict, scenes: dict, p0_mu0, device, dtype="float64",
              products: str = "full", block: int = 64, base: str = spec.HERE) -> dict:
    """The reference's summary of ``scenes`` under ``config``, its P0 tables
    at each column's ``p0_mu0``, in ``dtype`` with ``products``; the phase
    models' files found under ``base`` (the cell's)."""
    import torch

    M, L = config["grid"]["nb_angles"], config["grid"]["nb_layers"]
    mu = ref_grid.mu_grid(M)
    uniq, inv = np.unique(np.asarray(p0_mu0, dtype=np.float64), return_inverse=True)
    p0a, pa = phase.tables(config["atm"], mu, uniq, base)
    p0r, pr = phase.tables(config["aer"], mu, uniq, base)
    with precision.products(products):
        return solver.solve(scenes, p0a[inv], pa, p0r[inv], pr, M, L,
                            surface=config["surface"], dtype=getattr(torch, dtype),
                            tol=config["tol"], max_orders=config["max_orders"],
                            block=block, device=device)


def numbers(answers: dict, ref: dict) -> dict:
    """The compared numbers of ``answers`` against ``ref`` (see the module)."""
    got = np.concatenate([np.asarray(answers[k], dtype=np.float64) for k in ROWS], axis=1)
    want = np.concatenate([np.asarray(ref[k], dtype=np.float64) for k in ROWS], axis=1)
    if got.shape != want.shape:
        raise ValueError(f"answer rows {got.shape} against reference rows {want.shape}")
    scale = np.abs(want).max(axis=1, keepdims=True)
    scale = np.where(scale > 0, scale, 1.0)
    err = np.abs(got - want) / scale
    err = np.where(np.isfinite(err), err, np.inf)[want != 0]
    off = ((np.asarray(answers["n_orders"]) != np.asarray(ref["n_orders"]))
           | (np.asarray(answers["converged"]) != np.asarray(ref["converged"])))
    return {"rows_p50": float(np.median(err)), "rows_p99": float(np.percentile(err, 99)),
            "rows_max": float(err.max()), "orders_off": float(off.mean())}


def judge(found: dict, limits: dict):
    """(correct, {name: {value, limit}}) of ``found`` against ``limits``."""
    shown = {name: {"value": found[name], "limit": lim} for name, lim in limits.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return bool(ok), shown
