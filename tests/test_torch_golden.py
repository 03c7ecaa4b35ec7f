"""The port against the oracle fixtures, as tests/test_golden.py holds the
JAX solver.

Each fixture (tests/golden/*_mid.npz, made once from the NumPy oracle) is
one column on a 201-angle × 304-layer grid.  The port solves it on the CPU
in float64 with the mega engine's resident execution
(``solve_batch_mega(stream=False)``, the plain version of the whole-loop
kernel), the same with the first order from the host (``i1='host'``,
engine ``mega_host``), with the fused engine (``solve_batch(engine=
'fused')``) and with the reference engine (``solve_batch(engine=
'reference')``), and must reproduce it as the JAX solver does: the
oracle's order count, and I_total (and I₁, which the mega engine returns
only with ``i1='host'``) within test_golden.py's rtol 1e-5, atol
1e-7·scale (the port agrees to ~1e-14 of scale).  The eva and wildfire
fixtures' aerosol is the log-normal Mie model.
"""
import os

import numpy as np
import pytest
import torch

from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import solve_batch_mega
from sos_rt_tpu_torch.parallel import broadcast_scene, solve_batch
from sos_rt_tpu_torch.parallel.mesh import mega_small_ok
from sos_rt_tpu_torch.solver import PhaseTables

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CPU = torch.device("cpu")
# the aerosol model of each fixture (tests/test_golden.py::MODEL_FOR)
MODEL_FOR = {
    "rayleigh_mid": ("rayleigh", {}), "hg_mid": ("hg", {"g": 0.7}),
    "eva_mid": ("lognormal", {"lambda0": 0.550, "indx": 1.44 + 0.0j,
                              "n0": 501187.0, "r_m": 0.506, "sig": 1.2}),
    "wildfire_mid": ("lognormal", {"lambda0": 0.550, "indx": 1.7 + 0.03j,
                                   "n0": 501187.0, "r_m": 0.065, "sig": 1.5}),
    "fwc_mid": ("fwc", {}),
}
FIXTURES = ["rayleigh_mid", "hg_mid", "fwc_mid", "eva_mid", "wildfire_mid"]


def _fixture(name):
    with np.load(os.path.join(GOLDEN_DIR, name + ".npz")) as z:
        scene_kw = {k[6:]: float(z[k]) for k in z.files if k.startswith("scene_")}
        return (z["I"], z["I1"], int(z["n_orders"]), str(z["surface"]),
                GridSpec(nb_angles=int(z["M"]), nb_layers=int(z["L"])), scene_kw)


def _solve(name, engine):
    gold_i, gold_i1, n, surface, grid, scene_kw = _fixture(name)
    scenes = broadcast_scene(Scene(**scene_kw), 1, device=CPU)
    tables = PhaseTables.from_models(grid, scene_kw["mu0"], aer=MODEL_FOR[name],
                                     dtype=torch.float64, device=CPU)
    opts = SolverOptions(surface=surface, dtype="float64")
    if engine in ("mega", "mega_host"):
        # the whole-loop kernel's route must take this column as it is
        assert mega_small_ok(scenes, grid)
        sol = solve_batch_mega(scenes, tables, grid, opts, outputs="full",
                               allow_small=True, stream=False, device=CPU,
                               i1="host" if engine == "mega_host" else "kernel")
    else:
        sol = solve_batch(scenes, tables, grid, opts, engine=engine, device=CPU)
    return sol, gold_i, gold_i1, n


@pytest.mark.parametrize("engine", ["mega", "mega_host", "fused", "reference"])
@pytest.mark.parametrize("name", FIXTURES)
def test_port_matches_golden(name, engine):
    sol, gold_i, gold_i1, n = _solve(name, engine)
    assert int(sol.n_orders[0]) == n
    assert bool(sol.converged[0])
    scale = np.abs(gold_i).max()
    np.testing.assert_allclose(sol.i_total[0].numpy(), gold_i, rtol=1e-5,
                               atol=1e-7 * scale)
    if engine == "mega":
        assert sol.i1 is None
    else:
        np.testing.assert_allclose(sol.i1[0].numpy(), gold_i1, rtol=1e-5,
                                   atol=1e-7 * scale)
