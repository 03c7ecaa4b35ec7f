"""An aerosol layer in the top or the bottom layer, on every engine.

With z_down within half a layer of the ground the aerosol layer ends in
the bottom layer (idx_down = L − 1), and with z_up within half a layer of
z0 it starts in the top one (idx_up = 0): the neighbour layers
idx_down + 1 and idx_up − 1 then lie off the grid.  The JAX package's
reference engine reads them as ``tau[i]`` reads, wrapped and clamped to
L − 1 (``sos_rt_tpu_torch.grids.neighbour_index``).  Each engine of the
port (the reference engine, the mega engine resident and streamed, with
the kernels' I₁ and with ``i1='host'``, and the fused engine) is held to
``sos_rt_tpu.parallel.solve_batch(engine='reference')`` on a 48-angle ×
40-layer grid, z0 = 120 km, float64: equal order counts, I_total within
rtol 1e-9 (atol 1e-11·scale, the contract of tests/test_megastream.py).
The mega engine hands a batch whose layer reaches the ground to the fused
engine (``fused.layer_reaches_ground``).  ``python -m sos_rt_tpu_torch run
--z-down 0.3`` runs to its end on the CPU.
"""
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.parallel import solve_batch as j_solve_batch
from sos_rt_tpu_torch import cli, convert
from sos_rt_tpu_torch.fused import layer_reaches_ground, solve_batch_fused, solve_batch_mega
from sos_rt_tpu_torch.grids import layer_indices, neighbour_index
from sos_rt_tpu_torch.parallel import solve_batch
from sos_rt_tpu_torch.parallel.mesh import mega_small_ok

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(48, 40)
OPTS = JOpts(surface="lambertian", dtype="float64")
B = 3
# (z_up, z_down) km: the layer's bottom in the bottom layer, then its top
# in the top layer
EDGES = {"down0.1": (25.0, 0.1), "down0.3": (25.0, 0.3), "down1.0": (25.0, 1.0),
         "up3-down0.5": (3.0, 0.5), "up119": (119.0, 17.0), "up120": (120.0, 17.0)}
ENGINES = {
    "reference": lambda *a: solve_batch(*a, engine="reference", device="cpu"),
    "mega_resident": lambda *a: solve_batch_mega(*a, stream=False, device="cpu"),
    "mega_streamed": lambda *a: solve_batch_mega(*a, stream=True, device="cpu"),
    "mega_host_i1": lambda *a: solve_batch_mega(*a, stream=False, i1="host",
                                                device="cpu"),
    "fused": lambda *a: solve_batch_fused(*a, device="cpu"),
}


@pytest.fixture(scope="module")
def tables():
    return jax_tables(GRID)


_REFS = {}


def _jax_reference(case, tables):
    if case not in _REFS:
        z_up, z_down = EDGES[case]
        scenes = jax_scenes(B, z_up=z_up, z_down=z_down)
        _REFS[case] = scenes, j_solve_batch(scenes, tables, GRID, OPTS,
                                            engine="reference")
    return _REFS[case]


def test_neighbour_index_wraps_then_clamps():
    idx = torch.tensor([-1, 0, 5, 39, 40])
    assert neighbour_index(idx, 40).tolist() == [39, 0, 5, 39, 39]


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("case", list(EDGES))
def test_edge_layer_matches_jax_reference(tables, case, engine):
    z_up, z_down = EDGES[case]
    iu, idn = layer_indices(120.0, z_up, z_down, GRID.nb_layers)
    assert int(iu) == 0 or int(idn) == GRID.nb_layers - 1
    scenes, ref = _jax_reference(case, tables)
    got = ENGINES[engine](*port_inputs(scenes, tables, GRID, OPTS))
    assert bool(torch.isfinite(got.i_total).all())
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert_close_scaled(got.i_total.numpy(), np.asarray(ref.i_total), rtol=1e-9,
                        atol_scale=1e-11)


@pytest.mark.parametrize("case", list(EDGES))
def test_mega_routes_a_layer_at_the_ground_to_fused(tables, case):
    """The mega kernels' up walk smooths the bottom join once, the
    reference engine twice: a batch whose layer reaches the ground runs
    the fused engine; one whose layer reaches the top runs the kernels.
    mega_small_ok reads the top neighbour layer on a grid with small-µ
    columns without leaving the profile."""
    z_up, z_down = EDGES[case]
    scenes, _, grid, _ = port_inputs(jax_scenes(B, z_up=z_up, z_down=z_down), tables,
                                     GRID, OPTS)
    assert layer_reaches_ground(scenes, grid) == (z_down < 1.5)
    assert mega_small_ok(scenes, convert.grid_from(JGrid(128, 40))) in (True, False)


def test_run_cli_with_the_layer_at_the_ground(tmp_path):
    out = tmp_path / "edge.npz"
    cli.main(["run", "--preset", "hg", "--nb-angles", "48", "--nb-layers", "40",
              "--z-down", "0.3", "--device", "cpu", "-o", str(out)])
    with np.load(out) as f:
        assert all(np.isfinite(f[k]).all() for k in f.files
                   if np.issubdtype(f[k].dtype, np.floating))
