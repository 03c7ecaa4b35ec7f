"""The decompositions of the passB and up-sweep kernels, on the CPU.

The streamed passB runs as three kernels (csrc/pass_b_split.cuh): the band
fix of every (layer, column) row; the upward walk, which smooths only the
join rows (PK_R1, PK_R2), where the smoothing feeds the q1/q2 corrections
back; then the smoothing of every row.  The fused engine's up sweep runs
its walk and the two join smoothings first and then every (column, layer)
row alone: the chained corrections and the smoothing.  A torch twin of
each decomposition lives here, and each is held to the bit (torch.equal)
against the package's one plain version (megastream.passB_plain,
fused_sweeps.up_sweep_smooth_plain), which the kernels are held to on the
card: float64 and float32 (highest, bf16x3, bf16x5), Mp = 504 (a few
layers; three pad angles), 64 and 8, both surfaces, with the join rows
moved to the edge cases (both joins on one layer, a join on the first
layer walked, t = L-1, and on the last, t = 0).  The twins compute every
value with the same operations as the plain versions; exponentials are
taken in the plain versions' tensor shapes, because PyTorch's CPU exp
takes a vector path and a scalar tail that can differ in the last bit.
Also: the streamed engine with the three-stage passB against the JAX
package's streamed engine (_passB_kernel in interpret mode), float64.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import FusedBatch, prepare_batch, solve_batch_mega
from sos_rt_tpu_torch.ops import fused_sweeps as fs
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.ops.megakernel import (
    CP_GRD, PK_CHOICE, PK_CUP, PK_GS, PK_HDT_UP, PK_R1, PK_R2, RC_EMU_UP, RC_IVDN,
    RC_IVUP, RC_MUUP, _smooth_up, add_terms, band_fix_tile, split_parts)
from sos_rt_tpu_torch.parallel import broadcast_scene
from sos_rt_tpu_torch.solver import PhaseTables

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

CPU = torch.device("cpu")
# padded angle count → (real angles, layers)
GRIDS = {504: (501, 6), 64: (64, 12), 8: (8, 16)}
MODES = [(torch.float64, "highest"), (torch.float32, "highest"),
         (torch.float32, "bf16x3"), (torch.float32, "bf16x5")]
COLS = 4


# --------------------------------------------------------------------------
# The twins
# --------------------------------------------------------------------------

def passb_three_stage(pack, sdn, jnup, cpar, ops):
    """passB as its three kernels split it → (fdn, fup)."""
    L, C, Mp = sdn.shape
    mr, colc = ops.nb_angles, ops.colc
    rowf = torch.arange(Mp)
    row0 = rowf < 0.5
    corr = (rowf >= 0.5).to(sdn.dtype)
    # 1. the band fix of every row: fdn
    fdn = band_fix_tile(-sdn * colc[RC_IVDN], pack[PK_CHOICE], rowf > mr - 1.5,
                        taps=ops.taps, pvt=ops.pvt, mm=ops.mm, nb_angles=mr)
    # 2. the walk from the BC of stage 1's deepest row; the smoothing only
    #    on a column's join rows, where it feeds q1 / q2; f unsmoothed
    parts = split_parts(fdn[L - 1], ops.mm)
    bc = torch.zeros_like(fdn[L - 1])
    for k in range(Mp):
        bc = add_terms(bc, ops.bct[0][k], ops.bct[1][k], [p[:, k:k + 1] for p in parts],
                       ops.mm)
    r = torch.where(row0, jnup[L - 1], cpar[CP_GRD][:, None] * bc)
    aup = torch.exp(2.0 * pack[PK_HDT_UP][..., None] * colc[RC_EMU_UP])
    attu = torch.where(row0, 0.0, aup)
    jiv = colc[RC_IVUP] * jnup
    src = torch.where(row0, jnup, pack[PK_CUP][..., None] * jiv)
    gsv = pack[PK_GS][..., None] * jiv
    r1, r2 = pack[PK_R1] > 0.5, pack[PK_R2] > 0.5           # (L, C)
    q1 = q2 = torch.zeros_like(r)
    f_all = torch.empty_like(sdn)
    for t in range(L - 1, -1, -1):
        r = attu[t] * r + src[t]
        q1 = q1 * attu[t]
        q2 = q2 * attu[t]
        f = r - gsv[t] + corr * (q1 + q2)
        join = r1[t] | r2[t]
        if bool(join.any()):
            d = torch.zeros_like(f)
            d[join] = _smooth_up(f[join], mr, colc[RC_MUUP]) - f[join]
            q1 = torch.where(r1[t][:, None], d, q1)
            q2 = torch.where(r2[t][:, None], d, q2)
        f_all[t] = f
    # 3. the smoothing of every row
    return fdn, _smooth_up(f_all, mr, colc[RC_MUUP])


def up_sweep_row_parallel(jn_up, pack, cparams, mu_up_row, bc):
    """up_sweep_smooth as its three kernels split it → I↑ (B, L, M)."""
    B, L, m = jn_up.shape
    mu_row = mu_up_row[None, :]
    inv_mu = 1.0 / torch.where(mu_row == 0, 1.0, mu_row)
    lane0 = torch.arange(m)[None, :] == 0
    # 1. the walk: the raw field and the join rows into a (B, 2, M) buffer
    s = torch.where(lane0, jn_up[:, L - 1], bc)
    j_next = torch.zeros_like(s)
    rows = torch.zeros((B, 2, m), dtype=jn_up.dtype)
    raw = torch.empty_like(jn_up)
    for t in range(L - 1, -1, -1):
        w = pack[:, t, fs.PK_HDT_UP][:, None]
        j_t = jn_up[:, t]
        a = torch.exp((-2.0 * w) * inv_mu)
        c = torch.where(pack[:, t, fs.PK_DROP][:, None] > 0.5, 0.0,
                        w * inv_mu * (j_t + j_next * a))
        s = torch.where(lane0, j_t, a * s + c)
        j_next = j_t
        raw[:, t] = s
        rows[:, 0] = rows[:, 0] + pack[:, t, fs.PK_R1][:, None] * s
        rows[:, 1] = rows[:, 1] + pack[:, t, fs.PK_R2][:, None] * s
    # 2. the two join smoothings of each column: their deltas replace the rows
    tau_r1, tau_r2 = cparams[:, 0:1], cparams[:, 1:2]
    d1 = fs.smooth_rows(rows[:, 0], mu_up_row) - rows[:, 0]
    row2c = rows[:, 1] + d1 * torch.exp(-torch.clamp(tau_r1 - tau_r2, min=0.0) * inv_mu)
    rows = torch.stack([d1, fs.smooth_rows(row2c, mu_up_row) - row2c], 1)
    # 3. every (column, layer) row alone: corrections, then the smoothing
    corrected = torch.empty_like(raw)
    for t in range(L):
        tau_t = pack[:, t, fs.PK_TAU][:, None]
        att1 = torch.exp(-torch.clamp(tau_r1 - tau_t, min=0.0) * inv_mu)
        att2 = torch.exp(-torch.clamp(tau_r2 - tau_t, min=0.0) * inv_mu)
        corrected[:, t] = raw[:, t] + torch.where(
            lane0, 0.0, pack[:, t, fs.PK_CH1][:, None] * rows[:, 0] * att1
            + pack[:, t, fs.PK_CH2][:, None] * rows[:, 1] * att2)
    return fs.smooth_rows(corrected, mu_up_row)


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tables(m: int, layers: int, dtype):
    return PhaseTables.from_models(GridSpec(m, layers), 0.5, aer=("hg", {"g": 0.7}),
                                   dtype=dtype, device=CPU, cache=False)


@functools.lru_cache(maxsize=None)
def _order2(mp: int, dtype, mm: str, surface: str):
    """(pack, sdn, jnup, cpar, ops) of one block's second order."""
    m, layers = GRIDS[mp]
    grid = GridSpec(m, layers)
    scenes = dataclasses.replace(
        broadcast_scene(Scene(), COLS, device=CPU),
        grd_alb=torch.linspace(0.05, 0.8, COLS, dtype=torch.float64),
        tau_star_aer=torch.linspace(0.02, 0.35, COLS, dtype=torch.float64))
    opts = SolverOptions(surface=surface, dtype=str(dtype).split(".")[1], mm=mm)
    sb = prepare_batch(scenes, _tables(m, layers, dtype), grid, opts,
                       cols_per_block=COLS, device=CPU)
    pack, cpar, tiles = sb.block(0)
    fdn, fup = ms.passI_plain(pack, tiles, cpar, sb.ops)
    sdn, jnup = ms.passA_plain(pack, fdn, fup, sb.ops)
    return pack, sdn, jnup, cpar, sb.ops


def _edge_joins(pack):
    """The pack with each column's join rows at an edge case: column 0 both
    on one middle layer, column 1 both on the first layer walked (t = L-1),
    column 2 R1 at t = L-1 and R2 at t = 0, column 3 as the batch has them."""
    L = pack.shape[1]
    out = pack.clone()
    for c, (t1, t2) in enumerate([(L // 2, L // 2), (L - 1, L - 1), (L - 1, 0)]):
        out[PK_R1, :, c] = 0.0
        out[PK_R2, :, c] = 0.0
        out[PK_R1, t1, c] = 1.0
        out[PK_R2, t2, c] = 1.0
    return out


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("joins", ["batch", "edges"])
@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("dtype,mm", MODES, ids=[f"{str(d)[6:]}-{m}" for d, m in MODES])
@pytest.mark.parametrize("mp", list(GRIDS), ids=[f"mp{k}" for k in GRIDS])
def test_passb_three_stages_equal_plain(mp, dtype, mm, surface, joins):
    pack, sdn, jnup, cpar, ops = _order2(mp, dtype, mm, surface)
    if joins == "edges":
        pack = _edge_joins(pack)
    want = ms.passB_plain(pack, sdn, jnup, cpar, ops)
    got = passb_three_stage(pack, sdn, jnup, cpar, ops)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(w).all())
        assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.parametrize("mp", list(GRIDS), ids=[f"mp{k}" for k in GRIDS])
def test_edge_joins_move_the_field(mp):
    """The edge cases are live: moving the join rows changes fup (their
    smoothing deltas feed the walk), and the smoothing changes some rows."""
    pack, sdn, jnup, cpar, ops = _order2(mp, torch.float64, "highest", "lambertian")
    base = ms.passB_plain(pack, sdn, jnup, cpar, ops)[1]
    moved = ms.passB_plain(_edge_joins(pack), sdn, jnup, cpar, ops)[1]
    assert not torch.equal(base, moved)
    raw = ms.passB_plain(pack, sdn, jnup, cpar, ops, ab=frozenset({"nosmooth"}))[1]
    assert not torch.equal(base, raw)


def _fused(m: int, layers: int, dtype, surface: str, batch: int = 3):
    grid = GridSpec(m, layers)
    scenes = dataclasses.replace(
        broadcast_scene(Scene(), batch, device=CPU),
        grd_alb=torch.linspace(0.05, 0.8, batch, dtype=torch.float64),
        tau_star_aer=torch.linspace(0.02, 0.35, batch, dtype=torch.float64))
    opts = SolverOptions(surface=surface, dtype=str(dtype).split(".")[1])
    fb = FusedBatch(scenes, _tables(m, layers, dtype), grid, opts, CPU)
    jn = fb.source(fb.i1[:, :, :m], fb.i1[:, :, m:])
    bc = fb.surface_bc(fb.narrow_down_fixes(
        fs.down_sweep_plain(jn[:, :, :m], fb.pack, fb.mu_down_safe), jn))
    return jn[:, :, m:], fb.pack, fb.cparams, fb.mu_up_row, bc


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,layers", [(501, 6), (64, 12), (56, 30)])
def test_up_sweep_row_parallel_equals_plain(m, layers, dtype, surface):
    args = _fused(m, layers, dtype, surface)
    want = fs.up_sweep_smooth_plain(*args)
    got = up_sweep_row_parallel(*args)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got, want), float((got - want).abs().max())


def test_streamed_engine_with_three_stage_passb_matches_jax(monkeypatch):
    """Two orders (passI, then one passA + passB) of the streamed engine with
    passB as its three stages, against the JAX package's streamed engine in
    interpret mode, float64, rtol 1e-12, as tests/test_torch_megastream.py
    holds the plain version; and the same solve with passB_plain to the bit."""
    grid = JGrid(56, 64)
    tables = jax_tables(grid)
    opts = JOpts(surface="lambertian", dtype="float64", max_orders=2)
    scenes = jax_scenes(4)
    ref = j_solve_mega(scenes, tables, grid, opts, cols_per_block=2, interpret=True,
                       stream=True, outputs="full")
    inputs = port_inputs(scenes, tables, grid, opts)
    plain = solve_batch_mega(*inputs, cols_per_block=2, outputs="full", device="cpu")
    monkeypatch.setattr(ms, "passB", passb_three_stage)
    got = solve_batch_mega(*inputs, cols_per_block=2, outputs="full", device="cpu")
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert int(got.n_orders.max()) == 2
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-12, atol_scale=1e-14)
    assert torch.equal(got.i_total, plain.i_total)
