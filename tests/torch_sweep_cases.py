"""Shared inputs of the down-sweep tests, on the CPU and on the card.

Only torch and numpy: tests/test_torch_cuda.py imports it on a machine
without JAX.
"""
import numpy as np
import torch

from sos_rt_tpu_torch.ops import fused_sweeps as fs


def down_inputs(B, L, M, dtype, device, seed=20261017):
    """(jn_down, pack, mu_down_safe) of a (B, L, M) down sweep: jn_down the
    strided half-view of a (B, L, 2M) source of uniform values, as the
    engine passes it; pack from increasing τ, µ in [−1, −0.01]."""
    rng = np.random.default_rng(seed)
    jn = torch.as_tensor(rng.uniform(0.0, 1.0, (B, L, 2 * M)), dtype=dtype, device=device)
    tau = torch.as_tensor(np.cumsum(rng.uniform(0.0, 2.0 / L, (B, L)), axis=1),
                          device=device)
    idx = torch.full((B,), L // 2, dtype=torch.long, device=device)
    pack, _ = fs.build_pack(tau, idx // 2, idx, dtype)
    mu = torch.as_tensor(rng.uniform(-1.0, -0.01, M), dtype=dtype, device=device)
    return jn[:, :, :M], pack, mu
