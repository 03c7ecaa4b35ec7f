"""The host side of the tensor-core mainloop of passA / passI.

In float32 'bf16x3' / 'bf16x5' the products of the streamed passes run on
the tensor cores (csrc/quad_mma.cuh) and read bf16 copies of the split
operators that ``StreamOps.build`` makes on the card
(``megastream.tc_operator``).  Here, on the CPU: those copies hold hi and lo
exactly, pad K with zeros to the mainloop's k-tile and keep the operator's
rows where the kernel reads them, at the three angle counts of the main
paths (Mp = 504, 64, 8) for the source operator (K = 2Mp) and the surface
operator (K = Mp); StreamOps on the CPU builds no copies; and the plain
versions the CPU runs still equal the JAX package's streamed engine in
float64 (rtol 1e-12, as tests/test_torch_megastream.py holds them).  The
kernel itself is held against the plain versions on the card
(tests/test_torch_cuda.py).
"""
import functools

import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import prepare_batch, solve_batch_mega
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.parallel import broadcast_scene
from sos_rt_tpu_torch.solver import PhaseTables

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

# real angle count -> padded angle count Mp of the main paths: canonical
# 501x800 (504), the 64x128 sweep (64), the predictor's coarse 8x16 grid (8)
ANGLES = {504: 501, 64: 64, 8: 8}


@functools.lru_cache(maxsize=None)
def _ops(mp: int, mm: str, dtype=torch.float32):
    grid = GridSpec(ANGLES[mp], 16)
    tables = PhaseTables.from_models(grid, 0.5, atm=("rayleigh", {}),
                                     aer=("hg", {"g": 0.7}), dtype=dtype,
                                     device="cpu", cache=False)
    opts = SolverOptions(surface="lambertian", dtype=str(dtype).split(".")[1], mm=mm)
    return prepare_batch(broadcast_scene(Scene(), 2, device="cpu"), tables, grid, opts,
                         device="cpu").ops


@pytest.mark.parametrize("mm", ["bf16x3", "bf16x5"])
@pytest.mark.parametrize("which", ["source", "surface"])
@pytest.mark.parametrize("mp", sorted(ANGLES))
def test_tc_operator_copies_the_split_operator(mp, which, mm):
    ops = _ops(mp, mm)
    assert ops.mp == mp
    hi, lo = ops.ws if which == "source" else ops.astk
    k = 2 * mp if which == "source" else mp
    assert hi.shape == lo.shape == (4 * mp, k)
    w = ms.tc_operator(hi, lo)
    kp = w.shape[-1]
    assert w.dtype == torch.bfloat16 and w.shape == (2, 4 * mp, kp)
    assert kp % ms.TC_K_TILE == 0 and 0 <= kp - k < ms.TC_K_TILE
    # the bf16 copies hold hi and lo exactly
    assert torch.equal(w[0, :, :k].float(), hi)
    assert torch.equal(w[1, :, :k].float(), lo)
    assert bool(lo.abs().max() > 0)                  # lo is a real part
    # the padding is zero
    assert not w[:, :, k:].any()
    # the layout gives back W: element (part, q*Mp + n, j) of the flat copy
    # at the offset the kernel reads, ((part*4Mp + q*Mp + n) * Kp + j)
    flat = w.flatten().float()
    rng = np.random.default_rng(mp + k)
    part = torch.as_tensor(rng.integers(0, 2, 256))
    q = torch.as_tensor(rng.integers(0, 4, 256))
    n = torch.as_tensor(rng.integers(0, mp, 256))
    j = torch.as_tensor(rng.integers(0, k, 256))
    got = flat[((part * 4 * mp + q * mp + n) * kp + j)]
    want = torch.where(part == 0, hi[q * mp + n, j], lo[q * mp + n, j])
    assert torch.equal(got, want)
    # and the quad product over the padded copy equals it over (hi, lo)
    x = torch.as_tensor(rng.standard_normal((5, k)))
    xp = torch.nn.functional.pad(x, (0, kp - k))
    got = xp @ (w[0].double() + w[1].double()).T
    torch.testing.assert_close(got, x @ (hi.double() + lo.double()).T,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,mm", [(torch.float32, "bf16x3"), (torch.float32, "bf16x5"),
                                      (torch.float32, "highest"), (torch.float64, "highest")])
def test_stream_ops_on_the_cpu_build_no_bf16_copies(dtype, mm):
    ops = _ops(8, mm, dtype)
    assert ops.ws_tc is None and ops.astk_tc is None


def test_tensor_cores_take_float32_split_modes_only():
    assert ms.takes_tensor_cores(torch.float32, "bf16x3")
    assert ms.takes_tensor_cores(torch.float32, "bf16x5")
    assert not ms.takes_tensor_cores(torch.float32, "highest")
    assert not ms.takes_tensor_cores(torch.float64, "highest")


@pytest.mark.parametrize("m,surface", [(8, "lambertian"), (8, "specular"), (64, "lambertian")])
def test_plain_passes_match_jax_stream(m, surface):
    """passI (the first order) and passA + passB (the second) through the
    CPU solve, against the JAX streamed engine in interpreter mode, float64."""
    grid = JGrid(m, 16)
    tables = jax_tables(grid)
    scenes = jax_scenes(3)
    opts = JOpts(surface=surface, dtype="float64", max_orders=2)
    ref = j_solve_mega(scenes, tables, grid, opts, cols_per_block=3,
                       interpret=True, stream=True, outputs="full")
    got = solve_batch_mega(*port_inputs(scenes, tables, grid, opts), cols_per_block=3,
                           outputs="full", device="cpu")
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-12, atol_scale=1e-14)


def test_cpu_wrappers_count_no_launches():
    grid = GridSpec(8, 16)
    tables = PhaseTables.from_models(grid, 0.5, aer=("hg", {"g": 0.7}),
                                     dtype=torch.float32, device="cpu", cache=False)
    sb = prepare_batch(broadcast_scene(Scene(), 2, device="cpu"), tables, grid,
                       SolverOptions(dtype="float32"), device="cpu")
    pack, cpar, tiles = sb.block(0)
    ms.reset_launches()
    fdn, fup = ms.passI(pack, tiles, cpar, sb.ops)
    ms.passA(pack, fdn, fup, sb.ops)
    assert [(k.launches, k.tc_launches) for k in ms.TC_KERNELS] == [(0, 0), (0, 0)]
