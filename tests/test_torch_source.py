"""``ops/source.py::source_function`` against the JAX package's.

The blended Jₙ over all layers, float64, on a random field and the two
species' operators of GridSpec(24, 32), for aerosol layers inside the
column and at both edges: rtol 1e-12 (both sum the same products; the
order of the sums may differ).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec
from sos_rt_tpu.ops.source import source_function as j_source_function
from sos_rt_tpu.ops.source import source_operator as j_source_operator
from sos_rt_tpu_torch.ops.source import source_function, source_operator

from torch_cases import jax_tables

GRID = GridSpec(24, 32)
PAIRS = [(5, 9), (0, 3), (20, 31), (0, 31), (7, 7)]


@pytest.mark.parametrize("idx_up,idx_down", PAIRS)
def test_source_function_matches_jax(idx_up, idx_down):
    rng = np.random.default_rng(12)
    L, m2 = GRID.nb_layers, 2 * GRID.nb_angles
    tables = jax_tables(GRID)
    w_mu = np.asarray(GRID.trapz_weights(), np.float64)
    in_prev = rng.uniform(0.0, 1.0, (L, m2))
    alb_atm, alb_aer, w_atm, w_aer = 0.95, 0.85, 0.3, 0.7
    a_atm_j = j_source_operator(jnp.asarray(tables.p_atm), jnp.asarray(w_mu))
    a_aer_j = j_source_operator(jnp.asarray(tables.p_aer), jnp.asarray(w_mu))
    want = j_source_function(jnp.asarray(in_prev), a_atm_j, a_aer_j, alb_atm, alb_aer,
                             w_atm, w_aer, idx_up, idx_down)
    t = lambda x: torch.as_tensor(np.array(x), dtype=torch.float64)
    a_atm = source_operator(t(tables.p_atm), t(w_mu))
    a_aer = source_operator(t(tables.p_aer), t(w_mu))
    got = source_function(t(in_prev), a_atm, a_aer, alb_atm, alb_aer, w_atm, w_aer,
                          idx_up, idx_down)
    np.testing.assert_allclose(a_atm.numpy(), np.asarray(a_atm_j), rtol=1e-15, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)
    # rows outside the layer are the atmosphere's alone
    outside = [r for r in range(L) if not idx_up <= r <= idx_down]
    np.testing.assert_allclose(got.numpy()[outside],
                               (alb_atm / 4.0) * (in_prev @ a_atm.numpy())[outside],
                               rtol=1e-12, atol=0)
