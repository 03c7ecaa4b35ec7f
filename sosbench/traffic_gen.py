"""The one generator of every traffic mix: each column's scene from the
cell's configuration, its traffic's fixed values and its uniform draws."""
from __future__ import annotations

import numpy as np

SCENE_KEYS = ("mu0", "grd_alb", "alb_atm", "alb_aer", "tau_star_atm", "tau_star_aer",
              "z0", "z_up", "z_down")
# the sweep's documented draws, in its order (sweep.build_sweep_batch)
SWEEP_DRAWS = (("grd_alb", 0.0, 0.9), ("tau_star_aer", 0.01, 0.4), ("alb_aer", 0.7, 1.0))
SWEEP_MU0 = (0.2, 0.95)


def scenes(config: dict, traffic: dict, rng: np.random.Generator, batch: int) -> dict:
    """{key: (batch,) float64} for one call: the configuration's scene, the
    traffic's fixed ``scene`` values over it, then each of ``draws``
    {key: [lo, hi]} drawn U[lo, hi) from ``rng`` in the file's order."""
    base = dict(config["scene"], **traffic.get("scene", {}))
    out = {k: np.full(batch, float(base[k])) for k in SCENE_KEYS}
    for key, (lo, hi) in traffic.get("draws", {}).items():
        out[key] = rng.uniform(lo, hi, batch)
    return out


def sweep_scenes(config: dict, seed: int):
    """The scenes of a sweep of ``config["batch"]`` columns with seed ``seed``,
    as the sweep command documents them: ``numpy.random.default_rng(seed)``
    draws ρ ~ U[0, 0.9), τ*_aer ~ U[0.01, 0.4), ω_aer ~ U[0.7, 1.0), then
    each column's index into the pool of ``mu0_pool`` values
    linspace(0.2, 0.95), whose µ0 is that value rounded to the compute
    dtype.  Returns ({key: (batch,) float64}, pool (float64), pool index
    of each column)."""
    batch, pool_n = int(config["batch"]), int(config["mu0_pool"])
    rng = np.random.default_rng(seed)
    out = {k: np.full(batch, float(config["scene"][k])) for k in SCENE_KEYS}
    for key, lo, hi in SWEEP_DRAWS:
        out[key] = rng.uniform(lo, hi, batch)
    pool = np.linspace(*SWEEP_MU0, pool_n)
    idx = rng.integers(0, pool_n, batch)
    out["mu0"] = pool.astype(config["dtype"])[idx].astype(np.float64)
    return out, pool, idx
