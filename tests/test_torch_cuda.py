"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
(sm_90a) with nvcc; without one they skip.  On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which a machine with
only the port installed does not have.)

Tolerances, relative to each output's largest magnitude: 1e-12 in
float64 ('highest'); 1e-5 in float32, where the kernel and cuBLAS sum the
split products of passA/passI in another order (passB's sums are done in
the same order by both and agree to the bit).
"""
import dataclasses

import numpy as np
import pytest
import torch

from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import prepare_stream
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.parallel import broadcast_scene, solve_batch
from sos_rt_tpu_torch.solver import PhaseTables

pytestmark = pytest.mark.cuda
GRID = GridSpec(56, 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, dtype, batch=8):
    rng = np.random.default_rng(7)
    t = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, batch), device=device)
    scenes = broadcast_scene(Scene(), batch, device=device)
    scenes = dataclasses.replace(scenes, grd_alb=t(0.0, 0.9),
                                 tau_star_aer=t(0.01, 0.4), alb_aer=t(0.7, 1.0))
    tables = PhaseTables.from_models(GRID, 0.5, aer=("hg", {"g": 0.7}),
                                     dtype=dtype, device=device, cache=False)
    return scenes, tables


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("dtype,mm,tol", [(torch.float64, "highest", 1e-12),
                                          (torch.float32, "bf16x3", 1e-5),
                                          (torch.float32, "bf16x5", 1e-5),
                                          (torch.float32, "highest", 1e-5)])
def test_kernels_match_plain(cuda, surface, dtype, mm, tol):
    scenes, tables = _inputs(cuda, dtype)
    opts = SolverOptions(surface=surface, dtype=str(dtype).split(".")[1], mm=mm)
    sb = prepare_stream(scenes, tables, GRID, opts, device=cuda)
    pack, cpar, tiles = sb.block(0)
    ops = sb.ops
    fdn, fup = ms.passI_plain(pack, tiles, cpar, ops)
    for k, p in zip(ms.passI(pack, tiles, cpar, ops), (fdn, fup)):
        assert _rel(k, p) <= tol
    sdn, jn = ms.passA_plain(pack, fdn, fup, ops)
    for k, p in zip(ms.passA(pack, fdn, fup, ops), (sdn, jn)):
        assert _rel(k, p) <= tol
    for k, p in zip(ms.passB(pack, sdn, jn, cpar, ops),
                    ms.passB_plain(pack, sdn, jn, cpar, ops)):
        assert torch.equal(k, p)


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
def test_slice_on_card_matches_cpu(cuda, surface):
    opts = SolverOptions(surface=surface, dtype="float64")
    got = solve_batch(*_inputs(cuda, torch.float64), GRID, opts, device=cuda)
    cpu = torch.device("cpu")
    scenes, tables = _inputs(cuda, torch.float64)
    want = solve_batch(scenes.map(lambda x: x.cpu()),
                       PhaseTables(tables.p0_atm.cpu(), tables.p_atm.cpu(),
                                   tables.p0_aer.cpu(), tables.p_aer.cpu()),
                       GRID, opts, device=cpu)
    assert torch.equal(got.n_orders.cpu(), want.n_orders)
    scale = float(want.i_total.abs().max())
    torch.testing.assert_close(got.i_total.cpu(), want.i_total, rtol=1e-9,
                               atol=1e-11 * scale)


def test_wrappers_count_launches(cuda):
    scenes, tables = _inputs(cuda, torch.float32)
    ms.reset_launches()
    sol = solve_batch(scenes, tables, GRID, SolverOptions(dtype="float32"),
                      outputs="summary", device=cuda)
    n = int(sol.n_orders.max())
    assert ms.passI.launches == 1
    assert ms.passA.launches == ms.passB.launches == n - 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    scenes, tables = _inputs(cuda, torch.float64)
    sb = prepare_stream(scenes, tables, GRID, SolverOptions(), device=cuda)
    pack, cpar, tiles = sb.block(0)
    with pytest.raises(ValueError):
        ms.passI(pack.float(), tiles, cpar, sb.ops)
    with pytest.raises(ValueError):
        ms.passI(pack, tiles.transpose(1, 2), cpar, sb.ops)
