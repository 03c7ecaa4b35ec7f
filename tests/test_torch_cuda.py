"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
(sm_90a) with nvcc; without one they skip.  On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which a machine with
only the port installed does not have.)

Tolerances, relative to each output's largest magnitude: 1e-12 in
float64 ('highest'); 1e-5 in float32, where the kernel and cuBLAS sum the
split products of passA/passI in another order (passB's sums are done in
the same order by both and agree to the bit); 1e-4 for the tensor-core
product of passA/passI (float32 'bf16x3' / 'bf16x5') at the main paths'
angle counts, where K reaches 2Mp = 1008 (the bound of such a float32 sum
is 3·2Mp·2⁻²⁴ of the sum of |terms|, 1.8e-4 at Mp = 504).  The resident
whole-loop kernel (mega_call) is held against mega_plain with equal order
counts and, on the TOA/surface rows, 1e-4 of scale in float32, the bound
stated for the passes it is made of.  Inside the float32 field a last-bit
difference between the kernel's and cuBLAS's sums can move the endpoint of
the µ→0⁺ smoothing blend (its 1e-4 threshold is discontinuous) and change a
few angles of a layer by 1e-3..1e-2 of scale, so there at most one value in
a thousand may differ by more than 1e-4.  Against the streamed kernels the
resident kernel agrees to the bit in float64, where both run the same SIMT
product; in float32 'bf16x3' / 'bf16x5' both run their products on the
tensor cores, in two mainloops (wgmma in quad_mma.cuh, mma.sync in
mega_mma.cuh) that sum each k16 block apart in the same term order: to
the bit on the 12-column batch, and within the limits of mega_call against
mega_plain (chip_smoke.py's MEGA_BATCH_LIMITS) on the larger ones.
passB's three stage kernels (pass_b_split.cuh) and the fused engine's two
sweep kernels (down_sweep, up_sweep_smooth, the latter in three stages)
repeat their plain versions operation by operation and must equal them to
the bit, in float32 and in float64, at the main paths' widths.  So do the micro kernels (csrc/micro.cu), rep by
rep, but for their three products (1e-5 of scale); the resident kernel's
ablated builds (csrc/mega_ablate.cuh) equal mega_plain with the same flags to
1e-12 in float64, and their build of the solve equals sos_mega to the bit;
the streamed passes' ablated builds (csrc/megastream_ablate.cu) equal
passA_plain / passB_plain with the same flag (passA to the products'
tolerance, passB to the bit), their empty mask equals sos_passA and the
passB stages to the bit, and the streamed loop with every flag of
tools/ablate_stream.py equals the CPU's in float64 (1e-12).
The resident kernel with the first order from the host (sos_mega_i1in) is
held against mega_plain started from the same planes as sos_mega is, and to
sos_mega itself in float64 (1e-12).
The fused and reference engines' split-mode source kernel (sos_fused_source,
csrc/fused_source.cu) is held against fused_source_plain within 1e-4 of
scale, the tensor-core products' tolerance (K = 2Mp, as passA's), at
M = 13, 64 and 501 (rows of odd length), on both call sites' layouts and on
inputs that sit on the bf16 tie; whole float32 split-mode solves of both
engines launch it once an order and agree with the CPU's plain solves as
whole float32 loops do.
The streamed loop's block that gathers its running columns as they
converge equals, in float32 'bf16x3' and to the bit, the same columns
solved one a block, at 56×64 and 501×800.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import FusedBatch, prepare_batch, solve_batch_mega
from sos_rt_tpu_torch.ops import fused_source as fsrc
from sos_rt_tpu_torch.ops import fused_sweeps as fs
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.ops import micro
from sos_rt_tpu_torch.parallel import broadcast_scene, solve_batch
from sos_rt_tpu_torch.solver import PhaseTables
from sos_rt_tpu_torch.tools import ablate_stream

pytestmark = pytest.mark.cuda
GRID = GridSpec(56, 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, dtype, batch=8, grid=GRID):
    rng = np.random.default_rng(7)
    t = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, batch), device=device)
    scenes = broadcast_scene(Scene(), batch, device=device)
    scenes = dataclasses.replace(scenes, grd_alb=t(0.0, 0.9),
                                 tau_star_aer=t(0.01, 0.4), alb_aer=t(0.7, 1.0))
    tables = PhaseTables.from_models(grid, 0.5, aer=("hg", {"g": 0.7}),
                                     dtype=dtype, device=device, cache=False)
    return scenes, tables


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def _f32_loops_agree(a, b, tol=1e-4):
    """Two whole float32 loops with another product summation: every value
    within 5e-2 of scale (a moved smoothing endpoint) and all but one in a
    hundred within ``tol`` (the endpoint carries into the layers below it
    and the later orders: up to 4.2e-3 of the full field of a 4-column
    batch on an H100)."""
    off = (a - b).abs() > tol * float(b.abs().max())
    return float(off.float().mean()) <= 1e-2 and _rel(a, b) <= 5e-2


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("dtype,mm,tol", [(torch.float64, "highest", 1e-12),
                                          (torch.float32, "bf16x3", 1e-5),
                                          (torch.float32, "bf16x5", 1e-5),
                                          (torch.float32, "highest", 1e-5)])
def test_kernels_match_plain(cuda, surface, dtype, mm, tol):
    scenes, tables = _inputs(cuda, dtype)
    opts = SolverOptions(surface=surface, dtype=str(dtype).split(".")[1], mm=mm)
    sb = prepare_batch(scenes, tables, GRID, opts, device=cuda)
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
    got = solve_batch(*_inputs(cuda, torch.float64), GRID, opts, engine="mega",
                      device=cuda)
    cpu = torch.device("cpu")
    scenes, tables = _inputs(cuda, torch.float64)
    want = solve_batch(scenes.map(lambda x: x.cpu()),
                       PhaseTables(tables.p0_atm.cpu(), tables.p_atm.cpu(),
                                   tables.p0_aer.cpu(), tables.p_aer.cpu()),
                       GRID, opts, engine="mega", device=cpu)
    assert torch.equal(got.n_orders.cpu(), want.n_orders)
    scale = float(want.i_total.abs().max())
    torch.testing.assert_close(got.i_total.cpu(), want.i_total, rtol=1e-9,
                               atol=1e-11 * scale)


@pytest.mark.parametrize("scan_impl", ["associative", "sequential"])
@pytest.mark.parametrize("surface", ["lambertian", "specular"])
def test_reference_engine_on_card_matches_cpu(cuda, surface, scan_impl):
    """The reference engine (plain PyTorch, no kernel) on the card against
    the CPU in float64: equal order counts, rtol 1e-9."""
    opts = SolverOptions(surface=surface, dtype="float64", scan_impl=scan_impl)
    ms.reset_launches()
    got = solve_batch(*_inputs(cuda, torch.float64), GRID, opts, device=cuda)
    assert not any(k.launches for k in ms.ALL_KERNELS)
    scenes, tables = _inputs(cuda, torch.float64)
    want = solve_batch(scenes.map(lambda x: x.cpu()),
                       PhaseTables(tables.p0_atm.cpu(), tables.p_atm.cpu(),
                                   tables.p0_aer.cpu(), tables.p_aer.cpu()),
                       GRID, opts, device=torch.device("cpu"))
    assert torch.equal(got.n_orders.cpu(), want.n_orders)
    for name in ("i_total", "i1"):
        w = getattr(want, name)
        torch.testing.assert_close(getattr(got, name).cpu(), w, rtol=1e-9,
                                   atol=1e-11 * float(w.abs().max()))


def test_wrappers_count_launches(cuda):
    scenes, tables = _inputs(cuda, torch.float32)
    opts = SolverOptions(dtype="float32")
    ms.reset_launches()
    sol = solve_batch_mega(scenes, tables, GRID, opts, outputs="summary",
                           stream=True, device=cuda)
    n = int(sol.n_orders.max())
    assert ms.passI.launches == 1
    assert ms.passA.launches == ms.passB.launches == n - 1
    assert mk.mega_call.launches == 0
    ms.reset_launches()
    solve_batch_mega(scenes, tables, GRID, opts, outputs="summary", stream=False,
                     device=cuda)
    assert mk.mega_call.launches == 1
    assert ms.passI.launches == ms.passA.launches == ms.passB.launches == 0


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("full", [False, True], ids=["summary", "full"])
@pytest.mark.parametrize("dtype,mm,tol", [(torch.float64, "highest", 1e-12),
                                          (torch.float32, "bf16x3", 1e-4),
                                          (torch.float32, "bf16x5", 1e-4),
                                          (torch.float32, "highest", 1e-4)])
def test_mega_call_matches_plain(cuda, surface, full, dtype, mm, tol):
    scenes, tables = _inputs(cuda, dtype)
    opts = SolverOptions(surface=surface, dtype=str(dtype).split(".")[1], mm=mm)
    sb = prepare_batch(scenes, tables, GRID, opts, device=cuda)
    kw = dict(tol=opts.tol, max_orders=opts.max_orders, full=full)
    want = mk.mega_plain(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    for cb in (None, 1, 8):
        got = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, cols_per_tile=cb, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[-1][mk.ST_N], want[-1][mk.ST_N]), cb
        assert torch.equal(got[-1][mk.ST_CONV], want[-1][mk.ST_CONV])
        for k, p in zip(got[:-1], want[:-1]):
            if full and dtype == torch.float32:
                rows = [0, GRID.nb_layers - 1]
                assert _rel(k[rows], p[rows]) <= tol, cb
                off = (k - p).abs() > tol * float(p.abs().max())
                assert float(off.float().mean()) <= 1e-3, cb
            else:
                assert _rel(k, p) <= tol, cb


# the resident design's edge shapes for sos_mega_i1in: (angles, layers), Mp
# 8, 64 and 256 (the widest 256-thread block)
I1IN_GRIDS = {"mp8": (8, 16), "mp64": (64, 128), "mp256": (256, 24)}


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("dtype,mm,tol", [(torch.float64, "highest", 1e-12),
                                          (torch.float32, "bf16x3", 1e-4)])
@pytest.mark.parametrize("grid", list(I1IN_GRIDS), ids=list(I1IN_GRIDS))
def test_mega_i1in_matches_plain(cuda, grid, dtype, mm, tol, surface):
    """sos_mega_i1in (the first order from the host's planes) against
    mega_plain started from the same planes: equal order counts and flags,
    rows within 1e-12 (float64) / 1e-4 (float32, the products on the tensor
    cores) of scale, summary and full outputs; in float64 also against
    sos_mega, which evaluates I₁ itself (rtol 1e-12, equal counts).  Each
    launch counts in mega_call.launches and mega_call.i1in_launches."""
    grid = GridSpec(*I1IN_GRIDS[grid])
    scenes, tables = _inputs(cuda, dtype, batch=16, grid=grid)
    opts = SolverOptions(surface=surface, dtype=str(dtype).split(".")[1], mm=mm)
    host = prepare_batch(scenes, tables, grid, opts, device=cuda, i1="host",
                         cols_per_block=mk.default_cols_per_tile(mk.pad_angles(
                             grid.nb_angles)))
    for full in (False, True):
        kw = dict(tol=opts.tol, max_orders=opts.max_orders, full=full)
        ms.reset_launches()
        got = mk.mega_call(host.pack, host.cpar, host.tiles, host.ops, **kw,
                           **host.i1_planes())
        torch.cuda.synchronize()
        assert (mk.mega_call.launches, mk.mega_call.i1in_launches) == (1, 1)
        assert mk.mega_call.tc_launches == (dtype == torch.float32 and mm != "highest")
        want = mk.mega_plain(host.pack, host.cpar, host.tiles, host.ops, **kw,
                             **host.i1_planes())
        assert torch.equal(got[-1][mk.ST_N], want[-1][mk.ST_N]), full
        assert torch.equal(got[-1][mk.ST_CONV], want[-1][mk.ST_CONV])
        for k, p in zip(got[:-1], want[:-1]):
            assert bool(torch.isfinite(k).all())
            rows = [0, grid.nb_layers - 1] if full else slice(None)
            assert _rel(k[rows], p[rows]) <= tol, full
    if dtype == torch.float64:
        kern = prepare_batch(scenes, tables, grid, opts, device=cuda,
                             cols_per_block=host.cols_per_block)
        kw = dict(tol=opts.tol, max_orders=opts.max_orders, full=False)
        a = mk.mega_call(host.pack, host.cpar, host.tiles, host.ops, **kw,
                         **host.i1_planes())
        b = mk.mega_call(kern.pack, kern.cpar, kern.tiles, kern.ops, **kw)
        assert torch.equal(a[-1][mk.ST_N], b[-1][mk.ST_N])
        for x, y in zip(a[:4], b[:4]):
            torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-14 * float(y.abs().max()))


def test_mega_i1in_rejects_what_it_does_not_take(cuda):
    scenes, tables = _inputs(cuda, torch.float64)
    opts = SolverOptions(dtype="float64")
    host = prepare_batch(scenes, tables, GRID, opts, device=cuda, i1="host")
    kw = dict(tol=opts.tol, max_orders=opts.max_orders, full=False)
    planes = host.i1_planes()
    with pytest.raises(ValueError, match="ablate"):
        mk.mega_call(host.pack, host.cpar, host.tiles, host.ops, ablate="noconv",
                     **kw, **planes)
    with pytest.raises(ValueError, match="i1dn"):
        mk.mega_call(host.pack, host.cpar, host.tiles, host.ops, **kw,
                     i1dn=planes["i1dn"][:-1].contiguous(),
                     i1up=planes["i1up"][:-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        mk.mega_call(host.pack, host.cpar, host.tiles, host.ops, **kw,
                     i1dn=planes["i1dn"].float(), i1up=planes["i1up"])


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "streamed"])
def test_host_i1_solve_on_card_matches_cpu(cuda, stream):
    """solve_batch_mega(i1='host') in float64 on the card against the CPU:
    equal order counts, I_total and I₁ within rtol 1e-9; no passI launched."""
    opts = SolverOptions(dtype="float64")
    ms.reset_launches()
    got = solve_batch_mega(*_inputs(cuda, torch.float64), GRID, opts, i1="host",
                           stream=stream, device=cuda)
    assert ms.passI.launches == 0
    assert (mk.mega_call.i1in_launches == 1) != stream
    scenes, tables = _inputs(cuda, torch.float64)
    cpu = torch.device("cpu")
    want = solve_batch_mega(scenes.map(lambda x: x.cpu()),
                            PhaseTables(*(t.cpu() for t in (tables.p0_atm, tables.p_atm,
                                                            tables.p0_aer, tables.p_aer))),
                            GRID, opts, i1="host", stream=stream, device=cpu)
    assert torch.equal(got.n_orders.cpu(), want.n_orders)
    for x, y in ((got.i_total, want.i_total), (got.i1, want.i1)):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-9, atol=1e-11 * float(y.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("outputs", ["summary", "full"])
def test_resident_equals_streamed_to_the_bit(cuda, dtype, outputs):
    # 12 columns: a multiple of the resident tile (4) and one streamed block,
    # so both executions prepare the same unpadded batch (cuBLAS may sum the
    # host preparation's products in another order for another batch shape).
    # To the bit in float64 (the same SIMT product) and in float32 'bf16x3',
    # where both products run on the tensor cores in two mainloops that sum
    # each k16 block apart in the same term order
    scenes, tables = _inputs(cuda, dtype, batch=12)
    opts = SolverOptions(dtype=str(dtype).split(".")[1], max_orders=40)
    a, b = (solve_batch_mega(scenes, tables, GRID, opts, outputs=outputs,
                             stream=stream, device=cuda) for stream in (True, False))
    assert torch.equal(a.n_orders, b.n_orders)
    assert torch.equal(a.converged, b.converged)
    field = "i_toa" if outputs == "summary" else "i_total"
    assert torch.equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("grid", [GRID, GridSpec(501, 800)], ids=["56x64", "501x800"])
def test_compacted_block_equals_one_column_blocks_to_the_bit(cuda, grid, surface):
    """float32 'bf16x3', 16 columns whose order counts spread (ρ, τ*_aer,
    ω_aer varied): solved as one block, which gathers its running columns
    into narrower planes as they converge, its summary equals to the bit
    the same columns solved one a block (which never gathers).  Each
    product row sums its k16 blocks in the same order whatever the planes'
    width, and every other step is per column."""
    batch = 16      # every column's bands cover the 501 grid's small µ (mega_small_ok)
    lin = lambda lo, hi: torch.linspace(lo, hi, batch, dtype=torch.float64, device=cuda)
    scenes = dataclasses.replace(broadcast_scene(Scene(), batch, device=cuda),
                                 grd_alb=lin(0.0, 0.9), tau_star_aer=lin(0.01, 1.0),
                                 alb_aer=lin(0.8, 0.98))
    tables = PhaseTables.from_models(grid, 0.5, aer=("hg", {"g": 0.7}),
                                     dtype=torch.float32, device=cuda, cache=False)
    opts = SolverOptions(surface=surface, dtype="float32", mm="bf16x3")
    runs = []
    for block in (batch, 1):
        ms.reset_launches()
        sol = solve_batch_mega(scenes, tables, grid, opts, cols_per_block=block,
                               outputs="summary", sort=False, stream=True,
                               allow_small=True, device=cuda)
        runs.append((sol, ms.solve_block.compactions))
    (a, gathers), (b, alone) = runs
    assert gathers > 0 and alone == 0
    assert int(a.n_orders.max()) >= 3 * int(a.n_orders.min())
    assert torch.equal(a.n_orders, b.n_orders)
    assert torch.equal(a.converged, b.converged)
    assert torch.equal(a.i_toa, b.i_toa)
    assert torch.equal(a.i_surface, b.i_surface)


@pytest.mark.parametrize("mm", ["highest", "bf16x3"])
@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("angles,layers", [(75, 40), (100, 24), (260, 16)])
def test_resident_thread_shapes(cuda, angles, layers, surface, mm):
    """The block's other thread shapes: Mp = 80 (pass-B groups of 96 threads,
    64 threads without a group), Mp = 104 (two groups of 128) and Mp = 264
    (one group in a block of 512), each against the streamed kernels: to the
    bit in float32 'highest' (both on the SIMT product), within the limits
    of two float32 loops in 'bf16x3' (both products on the tensor cores in
    two mainloops at Mp = 80 and 104; the resident one on SIMT FMAs at
    Mp = 264)."""
    grid = GridSpec(angles, layers)
    scenes, tables = _inputs(cuda, torch.float32, batch=4, grid=grid)
    opts = SolverOptions(surface=surface, dtype="float32", mm=mm, max_orders=12)
    a, b = (solve_batch_mega(scenes, tables, grid, opts, outputs="full",
                             allow_small=True, stream=stream, device=cuda)
            for stream in (True, False))
    assert torch.equal(a.n_orders, b.n_orders)
    assert bool(torch.isfinite(b.i_total).all())
    if mm == "highest":
        assert torch.equal(a.i_total, b.i_total)
    else:
        assert _f32_loops_agree(a.i_total, b.i_total)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    scenes, tables = _inputs(cuda, torch.float64)
    sb = prepare_batch(scenes, tables, GRID, SolverOptions(), device=cuda)
    pack, cpar, tiles = sb.block(0)
    with pytest.raises(ValueError):
        ms.passI(pack.float(), tiles, cpar, sb.ops)
    with pytest.raises(ValueError):
        ms.passI(pack, tiles.transpose(1, 2), cpar, sb.ops)
    kw = dict(tol=1e-4, max_orders=10, full=False)
    with pytest.raises(ValueError):
        mk.mega_call(sb.pack.float(), sb.cpar, sb.tiles, sb.ops, **kw)
    with pytest.raises(ValueError):
        mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, cols_per_tile=3, **kw)


# ---- the tensor-core mainloop of passA / passI (csrc/quad_mma.cuh) ----

@pytest.mark.parametrize("mm", ["bf16x3", "bf16x5"])
@pytest.mark.parametrize("angles,layers,batch", [(501, 16, 9), (64, 24, 7), (8, 16, 13)],
                         ids=["mp504", "mp64", "mp8"])
def test_tc_mainloop_matches_plain(cuda, angles, layers, batch, mm):
    """At the main paths' angle counts (Mp = 504, 64, 8; passI's K = 504
    and K = 8 are not multiples of 16) and a ragged R = L·C (144, 168, 208:
    no multiple of the 128-row tile), passI and passA on the tensor cores
    against their plain versions, within 1e-4 of scale; each launch counts
    in tc_launches."""
    grid = GridSpec(angles, layers)
    scenes, tables = _inputs(cuda, torch.float32, batch=batch, grid=grid)
    opts = SolverOptions(dtype="float32", mm=mm)
    sb = prepare_batch(scenes, tables, grid, opts, cols_per_block=batch, device=cuda)
    pack, cpar, tiles = sb.block(0)
    ops = sb.ops
    assert ops.ws_tc is not None and ops.astk_tc is not None
    ms.reset_launches()
    fdn, fup = ms.passI_plain(pack, tiles, cpar, ops)
    for k, p in zip(ms.passI(pack, tiles, cpar, ops), (fdn, fup)):
        assert bool(torch.isfinite(k).all()) and _rel(k, p) <= 1e-4
    sdn, jn = ms.passA_plain(pack, fdn, fup, ops)
    for k, p in zip(ms.passA(pack, fdn, fup, ops), (sdn, jn)):
        assert bool(torch.isfinite(k).all()) and _rel(k, p) <= 1e-4
    assert [(k.launches, k.tc_launches) for k in ms.TC_KERNELS] == [(1, 1), (1, 1)]


def test_tc_mainloop_specular_passI_has_no_product(cuda):
    """A specular surface has no surface product: passI's tensor-core
    mainloop runs with K = 0 (and no operator copy) and only its epilogue
    writes I1."""
    scenes, tables = _inputs(cuda, torch.float32)
    opts = SolverOptions(surface="specular", dtype="float32")
    sb = prepare_batch(scenes, tables, GRID, opts, device=cuda)
    pack, cpar, tiles = sb.block(0)
    assert sb.ops.astk_tc is None and sb.ops.ws_tc is not None
    ms.reset_launches()
    for k, p in zip(ms.passI(pack, tiles, cpar, sb.ops),
                    ms.passI_plain(pack, tiles, cpar, sb.ops)):
        assert _rel(k, p) <= 1e-5
    assert (ms.passI.launches, ms.passI.tc_launches) == (1, 1)


@pytest.mark.parametrize("dtype,mm", [(torch.float64, "highest"), (torch.float32, "highest")])
def test_simt_modes_launch_no_tensor_core_product(cuda, dtype, mm):
    scenes, tables = _inputs(cuda, dtype)
    opts = SolverOptions(dtype=str(dtype).split(".")[1], mm=mm)
    sb = prepare_batch(scenes, tables, GRID, opts, device=cuda)
    pack, cpar, tiles = sb.block(0)
    assert sb.ops.ws_tc is None and sb.ops.astk_tc is None
    ms.reset_launches()
    fdn, fup = ms.passI(pack, tiles, cpar, sb.ops)
    ms.passA(pack, fdn, fup, sb.ops)
    assert [(k.launches, k.tc_launches) for k in ms.TC_KERNELS] == [(1, 0), (1, 0)]


# ---- the resident kernel's tensor-core product (csrc/mega_mma.cuh) ----

# chip_smoke.py's MEGA_BATCH_LIMITS: two whole float32 loops whose products
# sum in another order, over a batch of a thousand columns or more (the
# shares of columns whose order counts differ and of summary-row values off
# by more than 1e-4 of scale; the largest difference)
MEGA_BATCH_LIMITS = {"n_differs_frac": 1e-3, "n_differs_max": 1.0,
                     "rows_off_frac": 3e-3, "rows_max_rel": 5e-2}
# the resident kernel's main-path Mp (the sweep's 64, the predictor's 8) and
# ragged ones, no multiple of the 32-angle step (Mp = 80, 104)
MEGA_TC_GRIDS = {"mp64": (64, 128), "mp8": (8, 16), "mp80": (75, 40), "mp104": (100, 24)}
MEGA_TC_BATCH = 1024


def _within_batch_limits(n_a, n_b, rows_a, rows_b, tol=1e-4):
    """(within MEGA_BATCH_LIMITS, the findings, the mask of the columns whose
    order count differs or that have a value off)."""
    dn = (n_a - n_b).abs()
    off = torch.cat([(a - b).abs() > tol * float(b.abs().max())
                     for a, b in zip(rows_a, rows_b)], 1)
    found = {"n_differs_frac": float((dn > 0).float().mean()),
             "n_differs_max": float(dn.max()),
             "rows_off_frac": float(off.float().mean()),
             "rows_max_rel": max(_rel(a, b) for a, b in zip(rows_a, rows_b))}
    ok = all(found[k] <= lim for k, lim in MEGA_BATCH_LIMITS.items())
    return ok, found, (dn > 0) | off.any(1)


def _tc_batch(device, grid, mm, surface):
    grid = GridSpec(*MEGA_TC_GRIDS[grid])
    scenes, tables = _inputs(device, torch.float32, batch=MEGA_TC_BATCH, grid=grid)
    opts = SolverOptions(surface=surface, dtype="float32", mm=mm)
    return grid, scenes, tables, opts


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("mm", ["bf16x3", "bf16x5"])
@pytest.mark.parametrize("grid", list(MEGA_TC_GRIDS), ids=list(MEGA_TC_GRIDS))
def test_tc_mega_matches_plain(cuda, grid, mm, surface):
    """sos_mega with its products on the tensor cores against mega_plain,
    float32, 1024 columns, within MEGA_BATCH_LIMITS; the columns that are
    off agree with it in float64 (equal order counts, 1e-12), where no
    sum's last bit reaches the smoothing threshold; each launch counts in
    mega_call.tc_launches."""
    grid, scenes, tables, opts = _tc_batch(cuda, grid, mm, surface)
    sb = prepare_batch(scenes, tables, grid, opts, device=cuda)
    kw = dict(tol=opts.tol, max_orders=opts.max_orders, full=False)
    ms.reset_launches()
    got = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    torch.cuda.synchronize()
    assert (mk.mega_call.launches, mk.mega_call.tc_launches) == (1, 1)
    want = mk.mega_plain(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    ok, found, off = _within_batch_limits(got[-1][mk.ST_N], want[-1][mk.ST_N],
                                          got[:4], want[:4])
    assert ok, found
    cols = torch.nonzero(off)[:, 0]
    if cols.numel():
        s64, t64 = _inputs(cuda, torch.float64, batch=MEGA_TC_BATCH, grid=grid)
        o64 = dataclasses.replace(opts, dtype="float64", mm="highest")
        sb64 = prepare_batch(s64.map(lambda x: x[cols]), t64, grid, o64, device=cuda,
                             cols_per_block=mk.default_cols_per_tile(sb.ops.mp))
        g64 = mk.mega_call(sb64.pack, sb64.cpar, sb64.tiles, sb64.ops, **kw)
        w64 = mk.mega_plain(sb64.pack, sb64.cpar, sb64.tiles, sb64.ops, **kw)
        assert torch.equal(g64[-1][mk.ST_N], w64[-1][mk.ST_N])
        for k, p in zip(g64[:4], w64[:4]):
            assert _rel(k, p) <= 1e-12


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("mm", ["bf16x3", "bf16x5"])
@pytest.mark.parametrize("grid", list(MEGA_TC_GRIDS), ids=list(MEGA_TC_GRIDS))
def test_tc_mega_matches_streamed(cuda, grid, mm, surface):
    """The resident execution (mega_mma.cuh's product) against the streamed
    one (quad_mma.cuh's wgmma mainloop), float32, 1024 columns, within
    MEGA_BATCH_LIMITS.  Where they are not, the message also gives each
    against the plain version on the same batch (mega_plain), which tells
    which of the two loops moved."""
    grid, scenes, tables, opts = _tc_batch(cuda, grid, mm, surface)
    a, b = (solve_batch_mega(scenes, tables, grid, opts, outputs="summary", sort=False,
                             allow_small=True, stream=stream, device=cuda)
            for stream in (False, True))
    ok, found, _ = _within_batch_limits(a.n_orders, b.n_orders, (a.i_toa, a.i_surface),
                                        (b.i_toa, b.i_surface))
    if not ok:
        sb = prepare_batch(scenes, tables, grid, opts, device=cuda)
        want = mk.mega_plain(sb.pack, sb.cpar, sb.tiles, sb.ops, tol=opts.tol,
                             max_orders=opts.max_orders, full=False)
        B, m = MEGA_TC_BATCH, grid.nb_angles
        plain = (torch.cat([want[0][:, :m], want[1][:, :m]], 1)[:B],
                 torch.cat([want[2][:, :m], want[3][:, :m]], 1)[:B])
        found = {"resident_vs_streamed": found, **{
            f"{name}_vs_plain": _within_batch_limits(
                s.n_orders, want[-1][mk.ST_N][:B], (s.i_toa, s.i_surface), plain)[1]
            for name, s in (("resident", a), ("streamed", b))}}
    assert ok, found


@pytest.mark.parametrize("grid", list(MEGA_TC_GRIDS), ids=list(MEGA_TC_GRIDS))
def test_simt_mega_float64_matches_plain_and_streamed(cuda, grid):
    """float64 keeps the SIMT product: mega_call against mega_plain and the
    resident against the streamed loop with equal order counts, rtol 1e-12;
    no launch takes the tensor cores."""
    grid = GridSpec(*MEGA_TC_GRIDS[grid])
    scenes, tables = _inputs(cuda, torch.float64, batch=16, grid=grid)
    opts = SolverOptions(dtype="float64")
    sb = prepare_batch(scenes, tables, grid, opts, device=cuda)
    kw = dict(tol=opts.tol, max_orders=opts.max_orders, full=False)
    ms.reset_launches()
    got = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    want = mk.mega_plain(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    assert (mk.mega_call.launches, mk.mega_call.tc_launches) == (1, 0)
    assert torch.equal(got[-1][mk.ST_N], want[-1][mk.ST_N])
    for k, p in zip(got[:4], want[:4]):
        torch.testing.assert_close(k, p, rtol=1e-12, atol=0.0)
    a, b = (solve_batch_mega(scenes, tables, grid, opts, outputs="summary",
                             allow_small=True, stream=stream, device=cuda)
            for stream in (False, True))
    assert torch.equal(a.n_orders, b.n_orders)
    for x, y in ((a.i_toa, b.i_toa), (a.i_surface, b.i_surface)):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=0.0)


def _second_order(device, dtype, grid, surface="lambertian", batch=3):
    """A fused batch and the Jₙ of its second order (smooth in µ, as the
    sweeps meet it)."""
    scenes, tables = _inputs(device, dtype, batch=batch, grid=grid)
    opts = SolverOptions(surface=surface, dtype=str(dtype).split(".")[1])
    fb = FusedBatch(scenes, tables, grid, opts, device)
    m = grid.nb_angles
    return fb, fb.source(fb.i1[:, :, :m], fb.i1[:, :, m:])


# layers below the down sweep's ring depth (32 by its plan), a whole number
# of rings and one ring and a part; odd angle counts leave a ragged tile
@pytest.mark.parametrize("layers", [9, 30, 64, 77])
@pytest.mark.parametrize("angles", [56, 64, 201, 501])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sweep_kernels_match_plain(cuda, dtype, angles, layers):
    surface = "specular" if angles == 64 else "lambertian"
    fb, jn = _second_order(cuda, dtype, GridSpec(angles, layers), surface)
    m = angles
    fs.down_sweep.launches = fs.up_sweep_smooth.launches = 0
    got = fs.down_sweep(jn[:, :, :m], fb.pack, fb.mu_down_safe)
    torch.cuda.synchronize()
    want = fs.down_sweep_plain(jn[:, :, :m], fb.pack, fb.mu_down_safe)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), float((got - want).abs().max())
    down = got
    bc = fb.surface_bc(fb.narrow_down_fixes(want.clone(), jn))
    args = (jn[:, :, m:], fb.pack, fb.cparams, fb.mu_up_row, bc)
    got = fs.up_sweep_smooth(*args)
    torch.cuda.synchronize()
    want = fs.up_sweep_smooth_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), (float((got - want).abs().max()),
                                    int((got != want).sum()))
    assert fs.down_sweep.launches == fs.up_sweep_smooth.launches == 1
    # the same source made contiguous gives the same bits
    again = fs.up_sweep_smooth(jn[:, :, m:].contiguous(), *args[1:])
    assert torch.equal(again, got)
    again = fs.down_sweep(jn[:, :, :m].contiguous(), fb.pack, fb.mu_down_safe)
    assert torch.equal(again, down)


# (B, L, M): one layer, layers below, at and past the 32-layer ring, one
# column, one angle, odd angle counts whose last block is ragged, a row
# wider than one 256-angle block
DOWN_SHAPES = [(1, 1, 1), (1, 1, 501), (3, 5, 33), (1, 8, 95), (2, 37, 501),
               (4, 100, 64), (1, 129, 7), (2, 40, 1500)]


@pytest.mark.parametrize("shape", DOWN_SHAPES, ids=["x".join(map(str, s)) for s in DOWN_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_down_sweep_edge_shapes_match_plain(cuda, dtype, shape):
    """sos_down_sweep equals down_sweep_plain to the bit at the design's
    edges, on the strided half-view of a (B, L, 2M) source and on its
    contiguous copy, one launch a call."""
    from torch_sweep_cases import down_inputs

    jn, pack, mu = down_inputs(*shape, dtype, cuda)
    want = fs.down_sweep_plain(jn, pack, mu)
    assert bool(torch.isfinite(want).all())
    fs.down_sweep.launches = 0
    for src in (jn, jn.contiguous()):
        got = fs.down_sweep(src, pack, mu)
        torch.cuda.synchronize()
        assert torch.equal(got, want), float((got - want).abs().max())
    assert fs.down_sweep.launches == 2


def test_down_sweep_at_the_fused_canonical_block(cuda):
    """The fused_canonical block itself: B = 64, L = 800, M = 501, float32,
    on the J_n of a real second order, to the bit."""
    fb, jn = _second_order(cuda, torch.float32, GridSpec(501, 800), batch=64)
    m = 501
    fs.down_sweep.launches = 0
    got = fs.down_sweep(jn[:, :, :m], fb.pack, fb.mu_down_safe)
    torch.cuda.synchronize()
    want = fs.down_sweep_plain(jn[:, :, :m], fb.pack, fb.mu_down_safe)
    assert fs.down_sweep.launches == 1
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got, want), (float((got - want).abs().max()), int((got != want).sum()))
    assert torch.equal(fs.down_sweep(jn[:, :, :m].contiguous(), fb.pack, fb.mu_down_safe),
                       got)


def test_fused_order_step_copies_nothing_to_the_card_in_the_down_sweep(cuda):
    """One order step at the fused_canonical block (B = 64, 501×800, float32)
    under torch.profiler: the down sweep's span launches kernels and copies
    nothing from the host (the µ→0⁻ fix reads the stencils that
    ops.sweeps.device_stencils copied to the card once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sos_rt_tpu_torch.spans import DOWN_SWEEP

    fb, _ = _second_order(cuda, torch.float32, GridSpec(501, 800), batch=64)
    m = 501
    dn, up = fb.i1[:, :, :m], fb.i1[:, :, m:]
    fb.order_step(dn, up)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fb.order_step(dn, up)
        torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in host if e.name == DOWN_SWEEP]
    calls = [e for e in host if e.name.startswith("cu")
             and any(a <= e.time_range.start <= b for a, b in spans)]
    copies = {e.id for e in calls if "Memcpy" in e.name}
    htod = [e.name for e in events if e.device_type != DeviceType.CPU and e.id in copies
            and "HtoD" in e.name]
    assert len(spans) == 1 and any("Launch" in e.name for e in calls)
    assert htod == [] and copies == set(), sorted(e.name for e in calls)


@pytest.mark.parametrize("grid", [GRID, GridSpec(51, 24, spacing="gauss")],
                         ids=["uniform", "gauss"])
@pytest.mark.parametrize("surface", ["lambertian", "specular"])
def test_fused_engine_on_card_matches_cpu(cuda, surface, grid):
    opts = SolverOptions(surface=surface, dtype="float64")
    scenes, tables = _inputs(cuda, torch.float64, grid=grid)
    fs.down_sweep.launches = fs.up_sweep_smooth.launches = 0
    got = solve_batch(scenes, tables, grid, opts, engine="fused", device=cuda)
    n = int(got.n_orders.max())
    assert fs.down_sweep.launches == fs.up_sweep_smooth.launches == n - 1
    want = solve_batch(scenes.map(lambda x: x.cpu()),
                       PhaseTables(tables.p0_atm.cpu(), tables.p_atm.cpu(),
                                   tables.p0_aer.cpu(), tables.p_aer.cpu()),
                       grid, opts, engine="fused", device=torch.device("cpu"))
    assert torch.equal(got.n_orders.cpu(), want.n_orders)
    scale = float(want.i_total.abs().max())
    torch.testing.assert_close(got.i_total.cpu(), want.i_total, rtol=1e-9,
                               atol=1e-11 * scale)


# ---- passB's and up_sweep_smooth's stage kernels at the main paths'
# widths ----

# passB's blocks: the canonical block's 128 columns at Mp = 504 (a few
# layers), a ragged Mp = 80 and the sweep grid's Mp = 64
PASSB_GRIDS = {"mp504": (501, 12, 128), "mp80": (75, 24, 16), "mp64": (64, 32, 64)}
MODES = [(torch.float64, "highest"), (torch.float32, "highest"),
         (torch.float32, "bf16x3"), (torch.float32, "bf16x5")]


def _edge_joins(pack):
    """The join rows of columns 0-2 moved to the edge cases: both on one
    middle layer, both on the first layer walked (t = L-1), R1 at t = L-1
    and R2 at t = 0; the other columns keep theirs."""
    L = pack.shape[1]
    out = pack.clone()
    for c, (t1, t2) in enumerate([(L // 2, L // 2), (L - 1, L - 1), (L - 1, 0)]):
        out[mk.PK_R1, :, c] = 0.0
        out[mk.PK_R2, :, c] = 0.0
        out[mk.PK_R1, t1, c] = 1.0
        out[mk.PK_R2, t2, c] = 1.0
    return out


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("dtype,mm", MODES, ids=[f"{str(d)[6:]}-{m}" for d, m in MODES])
@pytest.mark.parametrize("grid", list(PASSB_GRIDS))
def test_passb_stages_equal_plain(cuda, grid, dtype, mm, surface):
    """passB's three kernels against passB_plain to the bit, on the batch's
    join rows and on the edge cases; one launch counted a call."""
    angles, layers, cols = PASSB_GRIDS[grid]
    grid = GridSpec(angles, layers)
    scenes, tables = _inputs(cuda, dtype, batch=cols, grid=grid)
    opts = SolverOptions(surface=surface, dtype=str(dtype).split(".")[1], mm=mm)
    sb = prepare_batch(scenes, tables, grid, opts, cols_per_block=cols, device=cuda)
    pack, cpar, tiles = sb.block(0)
    fdn, fup = ms.passI_plain(pack, tiles, cpar, sb.ops)
    sdn, jn = ms.passA_plain(pack, fdn, fup, sb.ops)
    for pk in (pack, _edge_joins(pack)):
        ms.reset_launches()
        got = ms.passB(pk, sdn, jn, cpar, sb.ops)
        torch.cuda.synchronize()
        assert ms.passB.launches == 1
        for k, p in zip(got, ms.passB_plain(pk, sdn, jn, cpar, sb.ops)):
            assert bool(torch.isfinite(p).all())
            assert torch.equal(k, p), (float((k - p).abs().max()), int((k != p).sum()))


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_up_sweep_stages_equal_plain_at_the_fused_block(cuda, dtype, surface):
    """up_sweep_smooth's three kernels at the fused_canonical block's width
    (B = 64, M = 501; a few layers) against the plain version, to the bit."""
    fb, jn = _second_order(cuda, dtype, GridSpec(501, 24), surface, batch=64)
    m = 501
    bc = fb.surface_bc(fb.narrow_down_fixes(
        fs.down_sweep_plain(jn[:, :, :m], fb.pack, fb.mu_down_safe), jn))
    args = (jn[:, :, m:], fb.pack, fb.cparams, fb.mu_up_row, bc)
    fs.up_sweep_smooth.launches = 0
    got = fs.up_sweep_smooth(*args)
    torch.cuda.synchronize()
    want = fs.up_sweep_smooth_plain(*args)
    assert fs.up_sweep_smooth.launches == 1
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got, want), (float((got - want).abs().max()), int((got != want).sum()))


def test_sweep_wrappers_reject_what_the_kernels_do_not_take(cuda):
    fb, jn = _second_order(cuda, torch.float64, GRID)
    m = GRID.nb_angles
    with pytest.raises(ValueError):
        fs.down_sweep(jn[:, :, :m], fb.pack.float(), fb.mu_down_safe)
    with pytest.raises(ValueError):
        fs.down_sweep(jn[:, :, :m].transpose(1, 2), fb.pack, fb.mu_down_safe)
    with pytest.raises(ValueError):
        fs.up_sweep_smooth(jn[:, :, m:], fb.pack, fb.cparams, fb.mu_up_row,
                           torch.zeros((fb.B, m + 1), dtype=jn.dtype, device=cuda))


# ---- the tools' kernels: micro_ops, micro_pass and the ablated resident
# kernel (csrc/micro.cu, csrc/mega_ablate.cuh) ----

@pytest.mark.parametrize("pat", micro.PATTERNS)
def test_micro_ops_kernel_matches_plain(cuda, pat):
    """Each rep against the plain version on the same input: to the bit but
    for the products (1e-5 of scale: another summation order, or float32
    accumulators against one rounding of a float64 sum)."""
    xs, pk, a2 = micro.make_inputs(0, cuda)
    first = micro.micro_ops_call(pat, 1, xs[0], pk, a2)
    second = micro.micro_ops_call(pat, 2, xs[0], pk, a2)
    torch.cuda.synchronize()
    for got, x in ((first, xs[0]), (second, first)):
        want = micro.micro_ops_plain(pat, 1, x, pk, a2)
        if pat.startswith("matmul"):
            assert _rel(got, want) <= 1e-5
        else:
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


@pytest.mark.parametrize("mode,g", micro.PASS_PAIRS,
                         ids=[f"{m}-{g}" for m, g in micro.PASS_PAIRS])
def test_micro_pass_kernel_matches_plain(cuda, mode, g):
    x = micro.make_inputs(0, cuda)[0][1]
    assert torch.equal(micro.micro_pass_call(mode, g, x), micro.micro_pass_plain(mode, g, x))


@pytest.mark.parametrize("pat", ("matmul_def", "matmul_high", "matmul"))
def test_micro_products_three_reps(cuda, pat):
    """The products carry their accumulators from one rep to the next
    (wgmma's start a fresh sum with scale-d 0): each of three reps against
    the plain version on the kernel's previous rep, 1e-5 of scale."""
    xs, pk, a2 = micro.make_inputs(0, cuda)
    x = xs[0] * 1e-2           # three reps stay finite
    outs = [micro.micro_ops_call(pat, k, x, pk, a2) for k in (1, 2, 3)]
    torch.cuda.synchronize()
    for got, prev in zip(outs, [x] + outs[:-1]):
        want = micro.micro_ops_plain(pat, 1, prev, pk, a2)
        assert bool(torch.isfinite(got).all()) and _rel(got, want) <= 1e-5


def test_micro_smooth_walk_stops_at_every_angle(cuda):
    """One warp a row: rows whose up half is noisy below angle p_r and flat
    from it stop the walk at idx = p_r + 1, p_r = 1 .. 60 (odd and even
    idx, so both lanes' halves serve as sv[idx]); to the bit, three reps."""
    xs, pk, a2 = micro.make_inputs(0, cuda)
    rows = xs[0].reshape(-1, micro.M2).clone()
    lane = torch.arange(micro.M, device=cuda)
    p = 1 + torch.arange(rows.shape[0], device=cuda) % 60
    up = rows[:, micro.M:]
    rows[:, micro.M:] = torch.where(lane[None, :] < p[:, None], up, 1.0)
    x = rows.reshape(xs[0].shape)
    prev = x
    for k in (1, 2, 3):
        got = micro.micro_ops_call("smooth", k, x, pk, a2)
        torch.cuda.synchronize()
        want = micro.micro_ops_plain("smooth", 1, prev, pk, a2)
        assert torch.equal(got, want)
        prev = got


@pytest.mark.parametrize("mode,g", micro.PASS_PAIRS + (("chunk", 64), ("chunk2d", 64)),
                         ids=[f"{m}-{g}" for m, g in micro.PASS_PAIRS + (("chunk", 64),
                                                                          ("chunk2d", 64))])
def test_micro_pass_layout_keeps_every_element(cuda, mode, g):
    """256 blocks of half a row: a field whose every value names its
    (layer, column, lane) comes back in place, to the bit."""
    L, C, M2 = micro.L, micro.C, micro.M2
    x = torch.arange(L * C * M2, dtype=torch.float32, device=cuda).reshape(L, C, M2) * 1e-6
    assert torch.equal(micro.micro_pass_call(mode, g, x), micro.micro_pass_plain(mode, g, x))


def test_micro_wrappers_count_launches(cuda):
    xs, pk, a2 = micro.make_inputs(0, cuda)
    ms.reset_launches()
    micro.micro_ops_call("fma", 3, xs[0], pk, a2)
    micro.micro_pass_call("flat", 128, xs[0])
    assert micro.micro_ops_call.launches == micro.micro_pass_call.launches == 1
    with pytest.raises(ValueError):
        micro.micro_ops_call("fma", 1, xs[0].double(), pk, a2)


@pytest.mark.parametrize("ablate", mk.ABLATE_VARIANTS)
def test_ablated_kernel_matches_plain(cuda, ablate):
    """float64: the ablated kernel cuts the stages mega_plain cuts, to 1e-12."""
    scenes, tables = _inputs(cuda, torch.float64)
    opts = SolverOptions(dtype="float64", max_orders=6)
    sb = prepare_batch(scenes, tables, GRID, opts, device=cuda)
    kw = dict(tol=opts.tol, max_orders=opts.max_orders, full=False)
    got = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, ablate=ablate, **kw)
    want = mk.mega_plain(sb.pack, sb.cpar, sb.tiles, sb.ops, ablate=ablate, **kw)
    assert bool((got[-1][mk.ST_N] == opts.max_orders).all())
    assert torch.equal(got[-1][mk.ST_N], want[-1][mk.ST_N])
    for k, p in zip(got[:-1], want[:-1]):
        assert _rel(k, p) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ablate_build_of_the_solve_equals_sos_mega(cuda, dtype):
    scenes, tables = _inputs(cuda, dtype)
    opts = SolverOptions(dtype=str(dtype).split(".")[1])
    sb = prepare_batch(scenes, tables, GRID, opts, device=cuda)
    kw = dict(tol=opts.tol, max_orders=opts.max_orders, full=False)
    a = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    b = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, ablate_build=True, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, ablate="noconv,nobc,nofin", **kw)


@pytest.mark.parametrize("dtype,mm,tol", [(torch.float64, "highest", 1e-12),
                                          (torch.float32, "bf16x3", 1e-5),
                                          (torch.float32, "highest", 1e-5)])
def test_ablated_passes_match_plain(cuda, dtype, mm, tol):
    """Each flag of passA / passB cuts what the plain version cuts; the
    empty mask of the ablated build is the solve's build to the bit."""
    scenes, tables = _inputs(cuda, dtype)
    opts = SolverOptions(dtype=str(dtype).split(".")[1], mm=mm)
    sb = prepare_batch(scenes, tables, GRID, opts, device=cuda)
    pack, cpar, tiles = sb.block(0)
    ops = sb.ops
    fdn, fup = ms.passI_plain(pack, tiles, cpar, ops)
    ms.reset_launches()
    for f in ms.PASS_A_FLAGS:
        for k, p in zip(ms.passA(pack, fdn, fup, ops, ab={f}),
                        ms.passA_plain(pack, fdn, fup, ops, {f})):
            assert _rel(k, p) <= tol, f
    assert all(torch.equal(a, b) for a, b in zip(
        ms.passA(pack, fdn, fup, ops), ms.passA(pack, fdn, fup, ops, ablate_build=True)))
    sdn, jn = ms.passA_plain(pack, fdn, fup, ops)
    outs = {}
    for f in ms.PASS_B_FLAGS:
        outs[f] = ms.passB(pack, sdn, jn, cpar, ops, ab={f})
        for k, p in zip(outs[f], ms.passB_plain(pack, sdn, jn, cpar, ops, {f})):
            assert torch.equal(k, p), f
    assert all(torch.equal(a, b) for a, b in zip(outs["nofin"], outs["nosmooth"]))
    assert all(torch.equal(a, b) for a, b in zip(
        ms.passB(pack, sdn, jn, cpar, ops),
        ms.passB(pack, sdn, jn, cpar, ops, ablate_build=True)))
    assert (ms.passA.ablate_launches, ms.passB.ablate_launches) == (3, 5)
    assert (ms.passA.launches, ms.passB.launches) == (1, 1)
    with pytest.raises(ValueError, match="one flag at a time"):
        ms.passB(pack, sdn, jn, cpar, ops, ab={"nofin", "nopoly"})


@pytest.mark.parametrize("ablate", ablate_stream.variants()
                         + ("sccond", "notiles", "noratio", "nopassA"))
def test_ablated_stream_on_card_matches_cpu(cuda, ablate):
    """The streamed loop with the tool's flags, float64: the card's equals
    the CPU's plain loop, equal order counts, 1e-12 of scale."""
    opts = SolverOptions(dtype="float64", max_orders=6)
    sols = [solve_batch_mega(*_inputs(dev, torch.float64), GRID, opts, outputs="summary",
                             stream=True, sort=False, device=dev, ablate=ablate)
            for dev in (cuda, torch.device("cpu"))]
    assert torch.equal(sols[0].n_orders.cpu(), sols[1].n_orders)
    for f in ("i_toa", "i_surface"):
        assert _rel(getattr(sols[0], f).cpu(), getattr(sols[1], f)) <= 1e-12


# ---- the split-mode J_n source of the fused and reference engines ----

SPLIT = ["bf16x3", "bf16x5"]


def _source_batch(device, m, surface, mm, L=32, B=4):
    grid = GridSpec(m, L)
    scenes, tables = _inputs(device, torch.float32, batch=B, grid=grid)
    opts = SolverOptions(surface=surface, dtype="float32", mm=mm)
    return FusedBatch(scenes, tables, grid, opts, device)


@pytest.mark.parametrize("mm", SPLIT)
@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("m", [13, 64, 501])
def test_fused_source_matches_plain(cuda, m, surface, mm):
    """Both call sites' layouts: the halves of a (B, L, 2M) field (row
    stride 2M: the reference engine's field, the fused engine's first
    order) and (B, L, M) fields (row stride M: the fused engine's later
    orders)."""
    fb = _source_batch(cuda, m, surface, mm)
    halves = (fb.i1[:, :, :m], fb.i1[:, :, m:])
    fsrc.fused_source.launches = 0
    for dn, up in (halves, tuple(h.contiguous() for h in halves)):
        got = fsrc.fused_source(dn, up, fb.wcopy, fb.cols, mm)
        torch.cuda.synchronize()
        want = fsrc.fused_source_plain(dn, up, fb.wcopy, fb.cols, mm)
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert _rel(got, want) <= 1e-4
    assert fsrc.fused_source.launches == 2


@pytest.mark.parametrize("mm", SPLIT)
@pytest.mark.parametrize("m", [13, 501])
def test_fused_source_on_bf16_ties(cuda, m, mm):
    """Every input's low 16 bits sit on the bf16 tie, where the kernel's
    split (ties away from zero) and a round-half-even one part ways."""
    fb = _source_batch(cuda, m, "lambertian", mm, L=16)
    rng = np.random.default_rng(11)

    def ties():
        bits = rng.integers(0x3C000000, 0x3F800000, size=(fb.B, fb.L, m), dtype=np.uint32)
        return torch.as_tensor(((bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000))
                               .view(np.float32), device=cuda)

    dn, up = ties(), ties()
    got = fsrc.fused_source(dn, up, fb.wcopy, fb.cols, mm)
    torch.cuda.synchronize()
    assert _rel(got, fsrc.fused_source_plain(dn, up, fb.wcopy, fb.cols, mm)) <= 1e-4


@pytest.mark.parametrize("engine", ["fused", "reference"])
@pytest.mark.parametrize("mm", SPLIT)
def test_split_mode_solves_launch_the_source_kernel(cuda, mm, engine):
    """A whole float32 split-mode solve on the card launches the source
    kernel once an order (no split product runs) and agrees with the CPU's
    solve, whose source is the plain split products: equal order counts,
    the fields as whole float32 loops with other product sums agree."""
    opts = SolverOptions(surface="lambertian", dtype="float32", mm=mm)
    ms.reset_launches()
    got = solve_batch(*_inputs(cuda, torch.float32), GRID, opts, engine=engine,
                      device=cuda)
    assert fsrc.fused_source.launches == int(got.n_orders.max()) - 1
    scenes, tables = _inputs(cuda, torch.float32)
    want = solve_batch(scenes.map(lambda x: x.cpu()),
                       PhaseTables(tables.p0_atm.cpu(), tables.p_atm.cpu(),
                                   tables.p0_aer.cpu(), tables.p_aer.cpu()),
                       GRID, opts, engine=engine, device=torch.device("cpu"))
    assert torch.equal(got.n_orders.cpu(), want.n_orders)
    assert _f32_loops_agree(got.i_total.cpu(), want.i_total)
