"""The guard against the JAX package compares whole top-level names: the
port (``sos_rt_tpu_torch``) passes, the JAX package and JAX fail."""
from __future__ import annotations

import subprocess
import sys

from sosbench import guard
from sosbench.tests.helpers import ROOT


def test_port_passes():
    assert guard.forbidden_loaded({"sos_rt_tpu_torch": 1, "sos_rt_tpu_torch.ops.megastream": 1,
                                   "torch": 1, "jaxtyping": 1, "sosbench.run": 1}) == []


def test_jax_package_and_jax_fail():
    assert guard.forbidden_loaded({"sos_rt_tpu": 1, "sos_rt_tpu_torch": 1}) == ["sos_rt_tpu"]
    assert guard.forbidden_loaded({"sos_rt_tpu.solver": 1}) == ["sos_rt_tpu"]
    assert guard.forbidden_loaded({"jax.numpy": 1, "jaxlib.xla_client": 1, "flax": 1}) == \
        ["flax", "jax", "jaxlib"]


def test_a_run_loads_neither():
    """The harness, its entries, its reference and the port's modules that
    a run imports leave no forbidden module loaded."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import sosbench.run, sosbench.calibrate\n"
            "from sosbench import spec\n"
            "b = spec.benchmark()\n"
            "for w in b['workloads']: spec.Cell(w['name'], b).entry()\n"
            "for m in b['per_layer']: spec.layer_metric(m['name'])\n"
            "import sos_rt_tpu_torch.sweep, sos_rt_tpu_torch.parallel, sos_rt_tpu_torch.fused\n"
            "import sos_rt_tpu_torch.ops.megastream\n"
            "from sosbench import guard\n"
            "print(guard.forbidden_loaded())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
