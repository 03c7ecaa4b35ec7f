"""The port's micro kernels' plain versions against the JAX package's tools.

``sos_rt_tpu_torch.ops.micro.micro_ops_call`` / ``micro_pass_call`` on
CPU tensors (the plain versions) against ``tools/micro_ops.py::kern`` and
``tools/micro_pass.py::kern`` in Pallas interpret mode, built and run by
``tests/jax_micro_ref.py`` in a process of its own (XLA:CPU without FMA
instructions, so that it rounds products and sums separately, as the TPU
and the port do; see that file), on the tools' own inputs:

| patterns | against JAX at k = 2 |
| --- | --- |
| fma, rowscalar, rowscalar_slice, lanemask, lanebrd, roll, tworefs | to the bit (tworefs is all NaN in both) |
| exp, reduce | rtol 1e-6 (XLA's exp; another summation order) |
| matmul | 1e-5 of scale |
| matmul_high | 1e-4 of scale (interpret mode multiplies in float32, whatever precision is asked), and to the bit against a numpy emulation of the bf16 split |
| matmul_def | 3e-2 of scale, and to the bit against its numpy split |
| smooth | 1e-6 of scale against ``_smooth_up`` on the same up-half rows |

The nine ``micro_pass`` (mode, g) pairs equal JAX to the bit.  The tools
themselves run end to end on the CPU (``--device cpu``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sos_rt_tpu_torch.ops import micro
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.tools import micro_ops as tool_ops, micro_pass as tool_pass

HERE = os.path.dirname(os.path.abspath(__file__))
BIT_EQUAL = ("fma", "rowscalar", "rowscalar_slice", "lanemask", "lanebrd", "roll",
             "tworefs")
TOL = {"exp": ("rtol", 1e-6), "reduce": ("rtol", 1e-6), "matmul": ("scale", 1e-5),
       "matmul_high": ("scale", 1e-4), "matmul_def": ("scale", 3e-2)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_micro") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(HERE, "jax_micro_ref.py"), str(path)],
                   env=env, check=True, timeout=600)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def inputs():
    return micro.make_inputs(0)


def _port(pat, inputs, k=2):
    xs, pk, a2 = inputs
    return micro.micro_ops_call(pat, k, xs[0], pk, a2).numpy()


@pytest.mark.parametrize("pat", [p for p in micro.PATTERNS if p != "smooth"])
def test_pattern_matches_jax(ref, inputs, pat):
    got, want = _port(pat, inputs), ref["ops_" + pat]
    assert got.shape == want.shape and got.dtype == want.dtype
    if pat in BIT_EQUAL:
        np.testing.assert_array_equal(got, want)      # NaN == NaN here
        assert np.isnan(got).all() == (pat == "tworefs")
        return
    kind, tol = TOL[pat]
    assert np.isfinite(got).all()
    if kind == "rtol":
        np.testing.assert_allclose(got, want, rtol=tol, atol=0)
    else:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= tol * scale


def _bf16_rne(a):
    """float32 → the nearest bf16, ties to even, by integer rounding."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("pat,passes", [("matmul_high", 3), ("matmul_def", 1)])
def test_split_products_equal_their_numpy_split(inputs, pat, passes):
    xs, pk, a2 = inputs
    v = xs[0].numpy()
    a = a2.numpy()
    hi = _bf16_rne(a)
    lo = _bf16_rne(a - hi)
    for _ in range(2):
        x1 = _bf16_rne(v)
        x2 = _bf16_rne(v - x1)
        out = x1.astype(np.float64) @ hi.astype(np.float64)
        if passes == 3:
            out = (out + x2.astype(np.float64) @ hi.astype(np.float64)
                   + x1.astype(np.float64) @ lo.astype(np.float64))
        v = out.astype(np.float32)
    np.testing.assert_array_equal(_port(pat, inputs), v)


def test_smooth_matches_jax_smooth_up(ref, inputs):
    got, want = _port("smooth", inputs), ref["smooth"]
    np.testing.assert_array_equal(got[..., :micro.M], inputs[0][0].numpy()[..., :micro.M])
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())
    # the walk blends somewhere: the up half moved
    assert not np.array_equal(got, inputs[0][0].numpy())


@pytest.mark.parametrize("mode,g", micro.PASS_PAIRS,
                         ids=[f"{m}-{g}" for m, g in micro.PASS_PAIRS])
def test_micro_pass_matches_jax(ref, mode, g):
    x = torch.ones((micro.L, micro.C, micro.M2), dtype=torch.float32)
    np.testing.assert_array_equal(micro.micro_pass_call(mode, g, x).numpy(),
                                  ref[f"pass_{mode}_{g}"])


def test_cpu_runs_plain_without_launches(inputs):
    ms.reset_launches()
    xs, pk, a2 = inputs
    micro.micro_ops_call("fma", 1, xs[0], pk, a2)
    micro.micro_pass_call("chunk", 8, xs[0])
    assert micro.micro_ops_call.launches == micro.micro_pass_call.launches == 0
    assert set(micro.KERNELS) <= set(ms.ALL_KERNELS)


def test_wrappers_reject_what_the_kernels_do_not_take(inputs):
    xs, pk, a2 = inputs
    with pytest.raises(ValueError, match="unknown pattern"):
        micro.micro_ops_call("nope", 1, xs[0], pk, a2)
    with pytest.raises(ValueError, match="micro_ops takes"):
        micro.micro_ops_call("fma", 1, xs[0][:8], pk, a2)
    with pytest.raises(ValueError, match="g in 8, 16, 32"):
        micro.micro_pass_call("static", 64, xs[0])
    with pytest.raises(ValueError, match="unknown mode"):
        micro.micro_pass_call("rows", 8, xs[0])


def test_tools_run_on_the_cpu(capsys):
    res = tool_ops.main(["fma", "smooth", "matmul_high", "--k1", "1", "--k2", "2",
                         "--device", "cpu"])
    assert [r["pattern"] for r in res] == ["fma", "smooth", "matmul_high"]
    res = tool_pass.main(["--device", "cpu"])
    assert [(r["mode"], r["g"]) for r in res] == list(micro.PASS_PAIRS)
    out = capsys.readouterr().out
    assert "us/pass" in out and "GB/s eff" in out and "not a card time" in out


def test_bounds_follow_the_shapes():
    rate = 132 * 128 * 1.98e9
    assert tool_ops.pass_bound_us("fma", rate) == pytest.approx(
        (8 * 2**20 / rate * 1e6, "bytes"))
    us, by = tool_ops.pass_bound_us("matmul_high", rate)
    assert by == "operations" and us == pytest.approx(3 * 2 * 8192 * 128 * 128 / 989e12 * 1e6)
    us, by = tool_ops.pass_bound_us("matmul", rate)
    assert by == "operations" and us == pytest.approx(4.006, rel=1e-3)


# a cuobjdump -sass listing of two kernels: one whose loop branches back to
# an address, one (nvdisasm style) to a label
SASS = """
        Function : _ZN12_GLOBAL__N_116micro_ops_kernelILi0EEEviPKfS2_S2_PKtS4_S2_Pf
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;   /* 0x0 */
        /*0010*/                   STS.128 [R0], R4 ;                  /* 0x0 */
        /*0020*/                   LDS.128 R8, [R0] ;                  /* 0x0 */
        /*0030*/                   FMUL R8, R8, 1.0001 ;               /* 0x0 */
        /*0040*/                   STS.128 [R0], R8 ;                  /* 0x0 */
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;       /* 0x0 */
        /*0060*/               @P0 BRA 0x20 ;                          /* 0x0 */
        /*0070*/                   LDS.128 R8, [R0] ;                  /* 0x0 */
        /*0080*/                   STG.E.128 desc[UR4][R2.64], R8 ;    /* 0x0 */
        /*0090*/                   EXIT ;                              /* 0x0 */
        Function : _ZN12_GLOBAL__N_117micro_pass_kernelILi0ELi0EEEviPKfPf
.L_x_0:
        /*0000*/                   LDS.64 R2, [R0] ;                   /* 0x0 */
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, R4, gdesc[UR4], RZ ;
        /*0020*/              @!P1 BRA `(.L_x_0) ;                     /* 0x0 */
"""


def test_sass_loops_count_shared_traffic():
    from sos_rt_tpu_torch.tools import sass

    funcs = sass.functions(SASS)
    assert len(funcs) == 2
    ops = [n for n in funcs if "micro_ops" in n][0]
    rows = sass.loops(*funcs[ops])
    assert rows == [{"start": 0x20, "end": 0x60, "lds": 1, "sts": 1, "ldg": 0, "stg": 0,
                     "bar": 1, "mma": 0}]
    assert sass.rep_loop(rows) == rows[0]
    pas = [n for n in funcs if "micro_pass" in n][0]
    rows = sass.loops(*funcs[pas])
    assert [(r["lds"], r["sts"], r["mma"]) for r in rows] == [(1, 0, 1)]
    assert sass.rep_loop(rows) is None
