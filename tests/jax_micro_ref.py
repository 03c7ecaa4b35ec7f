"""The JAX package's micro kernels in Pallas interpret mode, as references.

    python tests/jax_micro_ref.py OUT.npz

Writes, on ``ops/micro.py::make_inputs(0)``'s inputs (drawn here with the
same numpy calls): ``ops_<pattern>`` — ``tools/micro_ops.py::kern`` at
k = 2 for every pattern but ``smooth``; ``smooth`` — two applications of
``sos_rt_tpu.ops.megakernel._smooth_up`` to the up half of every row (µ
of GridSpec(64, 128)), the pattern the port's ``smooth`` stands for;
``pass_<mode>_<g>`` — ``tools/micro_pass.py::kern`` for the tool's nine
(mode, g) pairs on its all-ones field.

tests/test_torch_micro.py runs this in a process of its own, with
``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``: XLA:CPU contracts a product and a
sum into one fused multiply-add wherever the CPU has the instruction (one
rounding), which the TPU's vector unit does not do; on a CPU without FMA
instructions XLA rounds the product and the sum separately, as the TPU
and the port do, so the elementwise patterns compare to the bit.
``tools/micro_ops.py`` imports ``_smooth_tile``, a name the JAX package no
longer has; it is stubbed for the import only.
"""
import functools
import importlib.util
import os
import sys
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from sos_rt_tpu.config import GridSpec  # noqa: E402
from sos_rt_tpu.ops import megakernel  # noqa: E402

PATTERNS = ("fma", "rowscalar", "rowscalar_slice", "lanemask", "tworefs", "exp",
            "lanebrd", "reduce", "roll", "matmul", "matmul_high", "matmul_def")
PASS_PAIRS = (("flat", 128), ("chunk", 8), ("chunk", 16), ("chunk", 32),
              ("chunk2d", 8), ("chunk2d", 16),
              ("static", 8), ("static", 16), ("static", 32))


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(megakernel, "_smooth_tile", None, create=True):
        spec.loader.exec_module(mod)
    return mod


def inputs(mo):
    rng = np.random.default_rng(0)
    xs = [np.asarray(rng.standard_normal((mo.L, mo.C, mo.M2)) * 1e-2 + 1.0, np.float32)
          for _ in range(4)]
    pk = np.asarray(rng.standard_normal((mo.L, mo.C, 16)), np.float32)
    a2 = np.asarray(rng.standard_normal((mo.M2, mo.M2)), np.float32)
    return xs[0], pk, a2


def smooth_ref(x, m):
    """Two applications of _smooth_up to the up halves (angles on
    sublanes: (M, rows))."""
    mu = np.asarray(GridSpec(m, 128).mu()[m:], np.float32)[:, None]

    def kern(v_ref, mu_ref, o_ref):
        rowf = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0).astype(jnp.float32)
        o_ref[...] = megakernel._smooth_up(v_ref[...], rowf, m, mu_ref[...])

    f = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((m, x.size // (2 * m)),
                                                            jnp.float32),
                       interpret=True)
    up = x[..., m:].reshape(-1, m).T
    for _ in range(2):
        up = np.asarray(f(up, mu))
    out = x.copy()
    out[..., m:] = up.T.reshape(x[..., m:].shape)
    return out


def main(path):
    mo, mp = load_tool("micro_ops"), load_tool("micro_pass")
    x, pk, a2 = inputs(mo)
    out = {}
    for pat in PATTERNS:
        f = pl.pallas_call(
            functools.partial(mo.kern, pat=pat, k=2),
            out_shape=jax.ShapeDtypeStruct((mo.L, mo.C, mo.M2), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((mo.L, mo.C, mo.M2), jnp.float32)] * 2,
            interpret=True)
        out["ops_" + pat] = np.asarray(f(x, pk, a2))
    out["smooth"] = smooth_ref(x, mo.M)
    ones = np.ones((mp.L, mp.C, mp.M2), np.float32)
    for mode, g in PASS_PAIRS:
        f = pl.pallas_call(
            functools.partial(mp.kern, mode=mode, g=g),
            out_shape=jax.ShapeDtypeStruct((mp.L, mp.C, mp.M2), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((mp.L, mp.C, mp.M2), jnp.float32)],
            interpret=True)
        out[f"pass_{mode}_{g}"] = np.asarray(f(ones))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
