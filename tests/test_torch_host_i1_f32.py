"""``i1='host'`` in float32 bf16x3: the port's order counts equal the JAX
mega engine's (``solve_batch_mega(i1='host', interpret=True)``) on the
same float32 batch, resident and streamed, and its rows agree within rtol
1e-4 (the same split products, summed in another order).  A file of its
own: each JAX interpret-mode solve takes 15–30 s here.  Both sides take
the scenes and tables in float32 (float64 leaves would promote JAX's host
I₁ to float64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu_torch.fused import solve_batch_mega

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(56, 64)


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "streamed"])
def test_float32_host_i1_order_counts_match_jax(stream):
    opts = JOpts(surface="lambertian", dtype="float32")
    f32 = lambda t: jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), t)
    scenes = f32(jax_scenes(4))
    tables = f32(jax_tables(GRID))
    ref = j_solve_mega(scenes, tables, GRID, opts, cols_per_block=2, interpret=True,
                       stream=stream, i1="host", outputs="summary")
    got = solve_batch_mega(*port_inputs(scenes, tables, GRID, opts, torch.float32),
                           cols_per_block=2, stream=stream, i1="host",
                           outputs="summary", device="cpu")
    assert got.i_toa.dtype == torch.float32
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert_close_scaled(got.i_toa.numpy(), ref.i_toa, rtol=1e-4, atol_scale=1e-6)
    assert_close_scaled(got.i_surface.numpy(), ref.i_surface, rtol=1e-4,
                        atol_scale=1e-6)
