"""The port against the JAX mega engine where the reference engine does
not apply: float32 order counts and the coarse-grid order predictor.

The JAX side runs its Pallas kernels in interpreter mode on the CPU (about
20 s each here), so these two comparisons have a file of their own.
"""
import numpy as np
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import predict_order_count as j_predict
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu_torch.fused import predict_order_count, solve_batch_mega

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(56, 64)


def test_float32_order_counts_match_jax_mega():
    """float32 bf16x3: the order counts of the port equal those of the JAX
    streamed mega engine in float32 on the same batch."""
    opts = JOpts(surface="lambertian", dtype="float32")
    scenes = jax_scenes(4)
    tables56 = jax_tables(GRID)
    ref = j_solve_mega(scenes, tables56, GRID, opts, cols_per_block=2,
                       interpret=True, stream=True, outputs="summary")
    got = solve_batch_mega(*port_inputs(scenes, tables56, GRID, opts),
                           cols_per_block=2, outputs="summary", device="cpu")
    assert got.i_toa.dtype == torch.float32
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    # float32 against float32: the same split products, summed in another order
    assert_close_scaled(got.i_toa.numpy(), ref.i_toa, rtol=1e-4, atol_scale=1e-6)


def test_predicted_order_counts_match_jax():
    grid = JGrid(51, 40)                           # nearest-node subsampling
    tables = jax_tables(grid)
    opts = JOpts(surface="lambertian", dtype="float64")
    scenes = jax_scenes(4)
    want = j_predict(scenes, tables, grid, opts, interpret=True, min_batch=1)
    got = predict_order_count(*port_inputs(scenes, tables, grid, opts),
                              min_batch=1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert predict_order_count(*port_inputs(scenes, tables, grid, opts),
                               device="cpu") is None      # below 4096 columns
