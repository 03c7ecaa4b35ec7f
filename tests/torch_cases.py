"""Shared inputs of the PyTorch port's CPU tests.

The same batch, made with numpy, goes through the JAX package and the
port (``sos_rt_tpu_torch.convert`` carries it across), so each test holds
the port against the JAX package on identical inputs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

from sos_rt_tpu.config import Scene
from sos_rt_tpu.models import build_phase_tables
from sos_rt_tpu.parallel import broadcast_scene
from sos_rt_tpu.solver import PhaseTables
from sos_rt_tpu_torch import convert


def jax_tables(grid, mu0=0.5):
    """Rayleigh atmosphere + HG (g=0.7) aerosol tables, built without cache."""
    mu = grid.mu()
    p0a, pa = build_phase_tables("rayleigh", mu, mu0, cache=False)
    p0r, pr = build_phase_tables("hg", mu, mu0, g=0.7, cache=False)
    return PhaseTables(*[jnp.asarray(x) for x in (p0a, pa, p0r, pr)])


def jax_scenes(batch, **over):
    """The scene sweep of tests/test_megastream.py: albedo, aerosol τ and
    aerosol ω vary over the batch."""
    base = broadcast_scene(Scene(), batch)
    fields = dict(grd_alb=np.linspace(0.0, 0.8, batch),
                  tau_star_aer=np.linspace(0.02, 0.35, batch),
                  alb_aer=np.linspace(0.7, 1.0, batch))
    fields.update(over)
    return dataclasses.replace(base, **{k: jnp.asarray(np.broadcast_to(v, (batch,)),
                                                       jnp.float64)
                                        for k, v in fields.items()})


def port_inputs(scenes, tables, grid, opts, dtype=None):
    """The port's (scenes, tables, grid, opts) on the CPU."""
    import torch

    dtype = dtype or torch.float64
    return (convert.scene_from(scenes, device="cpu"),
            convert.tables_from(tables, dtype=dtype, device="cpu"),
            convert.grid_from(grid), convert.options_from(opts))


def assert_close_scaled(got, want, rtol, atol_scale):
    """allclose with an absolute floor of ``atol_scale`` times max|want|."""
    want = np.asarray(want)
    got = np.asarray(got)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale)
