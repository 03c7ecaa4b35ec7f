"""Shared inputs of the PyTorch port's CPU tests.

The same batch, made with numpy, goes through the JAX package and the
port (``sos_rt_tpu_torch.convert`` carries it across), so each test holds
the port against the JAX package on identical inputs.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

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


@contextlib.contextmanager
def world_of_one():
    """A world-size-1 gloo mesh in this process (``make_mesh`` starts the
    process group), the group destroyed on exit."""
    import torch.distributed as dist

    from sos_rt_tpu_torch.parallel import make_mesh

    try:
        yield make_mesh(device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every rank's script starts with this: one thread (the ranks share the
# test worker's cores), its rank of a gloo group on the parent's file store
RANK_PRELUDE = """
import json, sys
cfg = json.loads(sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
from sos_rt_tpu_torch.parallel.distributed import init_distributed
assert init_distributed(cfg["store"], cfg["world"], cfg["rank"], device="cpu")
OUT = {}
"""
# ... and ends with this: it imported neither JAX nor the JAX package, and
# writes OUT to its own npz
RANK_EPILOGUE = """
assert "jax" not in sys.modules, "a rank imported jax"
assert not [m for m in sys.modules if m == "sos_rt_tpu" or m.startswith("sos_rt_tpu.")]
np.savez(cfg["out"], **OUT)
torch.distributed.destroy_process_group()
print("RANK_OK", cfg["rank"])
"""


def start_ranks(tmp_path, nproc: int, body: str, **cfg):
    """Start ``nproc`` processes that run ``body`` as the ranks of one gloo
    group (a ``file://`` store under ``tmp_path``, no port); each sees
    ``cfg`` (with its ``rank``, ``world``, ``out``) and fills ``OUT``.
    Returns the processes, for :func:`wait_ranks`."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    src = RANK_PRELUDE + body + RANK_EPILOGUE
    procs = []
    for rank in range(nproc):
        c = dict(cfg, rank=rank, world=nproc, store=f"file://{tmp_path / 'store'}",
                 out=str(tmp_path / f"rank{rank}.npz"))
        procs.append(subprocess.Popen([sys.executable, "-c", src, json.dumps(c)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def wait_ranks(procs, tmp_path, timeout: float = 240.0):
    """Wait for every rank (each within ``timeout`` s: a hung rendezvous
    fails here, its ranks killed); returns each rank's OUT as a dict."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {rank}" in log, f"rank {rank}:\n{log}"
    outs = []
    for rank in range(len(procs)):
        with np.load(tmp_path / f"rank{rank}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs
