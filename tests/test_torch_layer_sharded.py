"""The layer-sharded scan and whole-column solve on four gloo ranks, held
to the JAX package (the counterparts of tests/test_layer_scan.py and
tests/test_layer_sharded.py).

One launch of four processes (``torch_cases.start_ranks``) runs, with the
layer axis sharded over a ('data',) mesh of the four ranks:
``sharded_affine_scan`` forward and reverse on an attenuation-like (128,
24) pair and on the down sweep's own operator shape, held to the JAX
package's ``ops/sweeps.py::_affine_scan`` at rtol 1e-12; and
``solve_column_layer_sharded`` at 64 angles × 128 layers, float64, both
surfaces, then with the aerosol layer in the top and in the bottom layer,
each held to the JAX package's ``solve_column``: equal order counts,
converged, within 1e-12 of scale.  A layer count the axis does not divide
and, in this process, the 501-angle grid (small-µ columns) are refused.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from sos_rt_tpu.config import GridSpec as JGrid, Scene as JScene, SolverOptions as JOpts
from sos_rt_tpu.ops.sweeps import _affine_scan as j_affine_scan
from sos_rt_tpu.solver import solve_column as j_solve_column
from sos_rt_tpu_torch import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.parallel.layer_sharded import (layer_sharded_supported,
                                                     solve_column_layer_sharded)
from sos_rt_tpu_torch.solver import PhaseTables

from torch_cases import jax_tables, start_ranks, wait_ranks, world_of_one

GRID = (64, 128)
# name → (surface, scene overrides of Scene(mu0=0.5, grd_alb=0.3, tau_star_aer=0.2))
SOLVES = {
    "lambertian": ("lambertian", {}),
    "specular": ("specular", {}),
    "top_layer": ("lambertian", dict(z_up=120.0)),
    "bottom_layer": ("lambertian", dict(z_down=0.1)),
}
SCENE = dict(mu0=0.5, grd_alb=0.3, tau_star_aer=0.2)


def _scan_inputs():
    rng = np.random.default_rng(0)
    L, M = 128, 24
    scans = {"attenuation": (rng.uniform(0.1, 0.99, (L, M)), rng.standard_normal((L, M)))}
    # the down sweep's operator: a = e^{Δτ/µ} after a leading 1, trapezoid b
    L, M = 64, 16
    tau = np.linspace(0.0, 0.3, L)
    mu = np.linspace(-1.0, -0.05, M)
    jn = np.sin(np.arange(L * M, dtype=np.float64)).reshape(L, M) + 2.0
    dtau = np.diff(tau)
    att = np.exp(dtau[:, None] / mu[None, :])
    scans["down_sweep"] = (np.concatenate([np.ones((1, M)), att]),
                           np.concatenate([np.zeros((1, M)),
                                           0.5 * dtau[:, None] * (jn[:-1] * att + jn[1:])]))
    return scans


BODY = """
from sos_rt_tpu_torch import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.parallel import make_mesh
from sos_rt_tpu_torch.parallel.layer_scan import sharded_affine_scan
from sos_rt_tpu_torch.parallel.layer_sharded import solve_column_layer_sharded
from sos_rt_tpu_torch.solver import PhaseTables

z = np.load(cfg["inputs"])
mesh = make_mesh((cfg["world"],), ("data",))
for name in cfg["scans"]:
    for reverse in (False, True):
        s = sharded_affine_scan(torch.from_numpy(z[name + ".a"]),
                                torch.from_numpy(z[name + ".b"]), mesh, reverse=reverse)
        OUT[f"{name}.{reverse}"] = s.numpy()
tables = PhaseTables(*(torch.from_numpy(z[k]) for k in ("p0_atm", "p_atm", "p0_aer", "p_aer")))
for name, (surface, over) in cfg["solves"].items():
    sol = solve_column_layer_sharded(Scene(**cfg["scene"], **over), tables,
                                     GridSpec(*cfg["grid"]),
                                     SolverOptions(surface=surface, dtype="float64"), mesh)
    for k in ("i_total", "n_orders", "converged", "idx_up", "idx_down"):
        OUT[name + "." + k] = getattr(sol, k).numpy()
try:
    solve_column_layer_sharded(Scene(), tables, GridSpec(cfg["grid"][0], 130),
                               SolverOptions(dtype="float64"), mesh)
except ValueError as e:
    OUT["indivisible"] = np.array(str(e))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's OUT, the scans' inputs, the JAX solves)."""
    tmp = tmp_path_factory.mktemp("layers")
    scans = _scan_inputs()
    tables = jax_tables(JGrid(*GRID))
    arrays = {f"{n}.{ab}": x for n, pair in scans.items() for ab, x in zip("ab", pair)}
    arrays.update({k: np.asarray(getattr(tables, k)) for k in
                   ("p0_atm", "p_atm", "p0_aer", "p_aer")})
    np.savez(tmp / "inputs.npz", **arrays)
    procs = start_ranks(tmp, 4, BODY, inputs=str(tmp / "inputs.npz"), scans=list(scans),
                        solves=SOLVES, scene=SCENE, grid=GRID)
    try:
        ref = {name: j_solve_column(JScene(**SCENE, **over), tables, JGrid(*GRID),
                                    JOpts(surface=surface, dtype="float64"))
               for name, (surface, over) in SOLVES.items()}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return wait_ranks(procs, tmp), scans, ref


@pytest.mark.parametrize("name", ["attenuation", "down_sweep"])
@pytest.mark.parametrize("reverse", [False, True])
def test_sharded_scan_matches_jax(run, name, reverse):
    outs, scans, _ = run
    a, b = scans[name]
    want = np.asarray(j_affine_scan(jnp.asarray(a), jnp.asarray(b), reverse=reverse,
                                    method="associative"))
    for out in outs:
        np.testing.assert_allclose(out[f"{name}.{reverse}"], want, rtol=1e-12,
                                   atol=1e-16 if name == "down_sweep" else 1e-14)


@pytest.mark.parametrize("name", list(SOLVES))
def test_layer_sharded_matches_jax_solve_column(run, name):
    outs, _, ref = run
    ref = ref[name]
    scale = float(jnp.max(jnp.abs(ref.i_total)))
    for out in outs:
        assert int(out[f"{name}.n_orders"]) == int(ref.n_orders)
        assert bool(out[f"{name}.converged"])
        assert out[f"{name}.i_total"].shape == (GRID[1], 2 * GRID[0])
        np.testing.assert_allclose(out[f"{name}.i_total"], np.asarray(ref.i_total),
                                   rtol=0, atol=1e-12 * scale)
    edge = {"top_layer": ("idx_up", 0), "bottom_layer": ("idx_down", GRID[1] - 1)}
    if name in edge:
        key, at = edge[name]
        assert int(outs[0][f"{name}.{key}"]) == int(getattr(ref, key)) == at


def test_layer_sharded_refuses_indivisible_layers(run):
    outs, _, _ = run
    for out in outs:
        assert "not divisible" in str(out["indivisible"])


def test_layer_sharded_rejects_small_mu_grid():
    grid = GridSpec(nb_angles=501, nb_layers=64)   # canonical angles: small-µ
    tables = PhaseTables.from_models(grid, 0.5, aer=("hg", {"g": 0.7}), device="cpu",
                                     cache=False)
    assert not layer_sharded_supported(grid)
    assert layer_sharded_supported(GridSpec(*GRID))
    with world_of_one() as mesh:
        with pytest.raises(ValueError, match="small"):
            solve_column_layer_sharded(Scene(), tables, grid,
                                       SolverOptions(dtype="float64"), mesh)
