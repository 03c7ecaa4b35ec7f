"""The split-mode Jₙ source of the fused and reference engines, on the CPU.

In float32 'bf16x3' / 'bf16x5' both engines compute each order's source in
one launch of ``sos_fused_source`` on the card (csrc/fused_source.cu,
``ops/fused_source.py``).  Here: its plain version equals the JAX package's
composition (``make_split_dot`` on the four operator blocks, mixed as
``sos_rt_tpu/fused.py``'s ``source_fn``) within 1e-6 of scale; the bf16
operator copy holds hi and lo exactly, with the rows and zero pads where the
kernel's loader reads them, and a Python twin of the kernel's indexing (its
padded X, its split, its epilogue) over that copy gives the plain version's
Jₙ; the split is the plain version's (ties away from zero) on inputs that
sit on the bf16 tie; the split modes call the kernel once an order from
both engines and never the split products, while float64, 'highest',
``mm=None`` and ``shard_tables`` take the matrix products (a faked card, as
in tests/test_torch_mega_tc.py); on the CPU nothing launches; and a whole
float32 'bf16x5' fused solve equals the JAX fused engine's.  The kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py -k fused_source).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_fused as j_solve_batch_fused
from sos_rt_tpu.ops.precision import make_split_dot as j_make_split_dot
from sos_rt_tpu.solver import PhaseTables as JTables
from sos_rt_tpu_torch import solver
from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import FusedBatch, solve_batch_fused
from sos_rt_tpu_torch.ops import cuda_build
from sos_rt_tpu_torch.ops import fused_source as fsrc
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.ops import precision
from sos_rt_tpu_torch.parallel import broadcast_scene
from sos_rt_tpu_torch.solver import PhaseTables, solve_batch_reference

from test_torch_mega_tc import _as_on_the_cpu, fake_card  # noqa: F401
from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

CPU = torch.device("cpu")
SPLIT = ["bf16x3", "bf16x5"]


def _problem(m: int, L: int = 16, B: int = 3, seed: int = 0):
    """numpy-seeded halves (B, L, M), two (2M, 2M) operators and the
    per-column mixing inputs, all float32."""
    rng = np.random.default_rng(seed + m)
    f32 = lambda a: np.asarray(a, np.float32)
    dn, up = (f32(rng.lognormal(-2.0, 1.0, (B, L, m))) for _ in range(2))
    a_atm, a_aer = (f32(rng.uniform(0.0, 2.0 / m, (2 * m, 2 * m))) for _ in range(2))
    alb_atm, alb_aer = f32(rng.uniform(0.8, 1.0, B)), f32(rng.uniform(0.7, 1.0, B))
    w_atm = f32(rng.uniform(0.1, 0.9, B))
    idx_up = rng.integers(0, L // 2, B)
    idx_down = idx_up + rng.integers(0, L // 2, B)
    return dict(dn=dn, up=up, a_atm=a_atm, a_aer=a_aer, alb_atm=alb_atm,
                alb_aer=alb_aer, w_atm=w_atm, w_aer=f32(1.0 - w_atm),
                idx_up=idx_up, idx_down=idx_down)


def _jax_source(p, mm):
    """The JAX package's split-mode source (sos_rt_tpu/fused.py source_fn)."""
    m = p["dn"].shape[-1]
    a = [jnp.asarray(x) for x in (p["a_atm"][:m], p["a_atm"][m:], p["a_aer"][:m],
                                  p["a_aer"][m:])]
    dots = [j_make_split_dot(x, mm, jnp.float32) for x in a]
    dn, up = jnp.asarray(p["dn"]), jnp.asarray(p["up"])
    col = lambda k: jnp.asarray(p[k])[:, None, None]
    jn_atm = (col("alb_atm") / 4.0) * (dots[0](dn) + dots[1](up))
    jn_aer = (col("alb_aer") / 4.0) * (dots[2](dn) + dots[3](up))
    t = jnp.arange(p["dn"].shape[1])
    in_layer = ((t[None, :] >= p["idx_up"][:, None])
                & (t[None, :] <= p["idx_down"][:, None]))[..., None]
    return np.asarray(jnp.where(in_layer, col("w_atm") * jn_atm + col("w_aer") * jn_aer,
                                jn_atm))


def _port(p, mm, halves=False):
    """(dn, up, wcopy, cols) of the port; ``halves``: dn and up as the two
    halves of one (B, L, 2M) field, as the reference engine passes them."""
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    dn, up = t["dn"], t["up"]
    if halves:
        field = torch.cat([dn, up], dim=2)
        dn, up = field[:, :, :dn.shape[-1]], field[:, :, dn.shape[-1]:]
    m = dn.shape[-1]
    wcopy = fsrc.source_copy(t["a_atm"], t["a_aer"], m, mm)
    cols = fsrc.source_columns(t["alb_atm"], t["alb_aer"], t["w_atm"], t["w_aer"],
                               t["idx_up"], t["idx_down"], torch.float32)
    return dn, up, wcopy, cols


@pytest.mark.parametrize("halves", [False, True])
@pytest.mark.parametrize("mm", SPLIT)
@pytest.mark.parametrize("m", [13, 64])
def test_plain_matches_jax_composition(m, mm, halves):
    p = _problem(m)
    args = _port(p, mm, halves)
    got = fsrc.fused_source_plain(*args, mm)
    assert got.dtype == torch.float32 and got.shape == (3, 16, 2 * m)
    assert_close_scaled(got.numpy(), _jax_source(p, mm), rtol=0.0, atol_scale=1e-6)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    ms.reset_launches()
    assert torch.equal(fsrc.fused_source(*args, mm), got)
    assert fsrc.fused_source.launches == 0


def _kernel_twin(dn, up, wcopy, cols, mm):
    """What sos_fused_source computes, index by index as the kernel reads and
    writes: X (R, Kp) as LoadFieldRows fills the ring (I↓ at k = j, I↑ at
    k = Mp + j, zeros elsewhere), x split as split_a splits it, the four
    quads of the copy's rows q·Mp + n, and EpiFusedSource's mixing into
    row r = b·L + l of the (B, L, 2M) output."""
    B, L, m = dn.shape
    mp, kp = wcopy.shape[1] // 4, wcopy.shape[2]
    x = torch.zeros((B * L, kp), dtype=torch.float32)
    x[:, :m] = dn.reshape(B * L, m)
    x[:, mp:mp + m] = up.reshape(B * L, m)
    xs = [torch.as_tensor(v) for v in _split_like_kernel(x.numpy(), mm)]
    hi, lo = wcopy[0].float(), wcopy[1].float()
    quad = []
    for q in range(4):
        h, l_ = hi[q * mp:(q + 1) * mp].T, lo[q * mp:(q + 1) * mp].T
        quad.append(precision.split_dot(xs, h, l_, mm)[:, :m])
    coef, span = cols
    b = torch.arange(B * L) // L
    layer = torch.arange(B * L) % L
    inside = ((layer >= span[0][b]) & (layer <= span[1][b]))[:, None]
    ca, cr, wa, wr = (coef[i][b][:, None] for i in range(4))
    out = torch.empty((B * L, 2 * m), dtype=torch.float32)
    for h in range(2):
        t_atm, a_aer = ca * quad[h], quad[2 + h]
        out[:, h * m:(h + 1) * m] = torch.where(inside, wa * t_atm + wr * (cr * a_aer),
                                                t_atm)
    return out.reshape(B, L, 2 * m)


def _split_like_kernel(x, mm):
    """quad_mma.cuh's split_a for LoadFieldRows, on float32 bit patterns:
    x1 = hi_away(x) (and bf16x5's x2 = hi_away(r1)), the last part rounded
    half to even."""
    away = lambda v: ((v.view(np.uint32) + np.uint32(0x8000))
                      & np.uint32(0xFFFF0000)).view(np.float32)
    even = lambda v: torch.as_tensor(v).to(torch.bfloat16).float().numpy()
    x1 = away(x)
    r1 = (x - x1).astype(np.float32)
    if mm == "bf16x3":
        return x1, even(r1)
    x2 = away(r1)
    return x1, x2, even((r1 - x2).astype(np.float32))


@pytest.mark.parametrize("mm", SPLIT)
@pytest.mark.parametrize("m", [501, 64, 13])
def test_source_copy_holds_the_split_operator_where_the_kernel_reads_it(m, mm):
    p = _problem(m, L=4, B=2)
    dn, up, wcopy, cols = _port(p, mm)
    mp = mk.pad_angles(m)
    kp = wcopy.shape[2]
    assert mp == {501: 504, 64: 64, 13: 16}[m]
    assert wcopy.dtype == torch.bfloat16 and wcopy.shape == (2, 4 * mp, kp)
    assert kp % mk.TC_K_TILE == 0 and 0 <= kp - 2 * mp < mk.TC_K_TILE
    w = wcopy.float()
    for s, a in enumerate((p["a_atm"], p["a_aer"])):
        hi, lo = (x.float() for x in precision.split_bf16(torch.as_tensor(a)))
        assert bool(lo.abs().max() > 0)                  # lo is a real part
        for h in range(2):                               # output half: rows q·Mp + n
            q = 2 * s + h
            for kb in range(2):                          # input half: k = kb·Mp + j
                blk = w[:, q * mp:q * mp + m, kb * mp:kb * mp + m]
                assert torch.equal(blk[0], hi[kb * m:(kb + 1) * m, h * m:(h + 1) * m].T)
                assert torch.equal(blk[1], lo[kb * m:(kb + 1) * m, h * m:(h + 1) * m].T)
    # zero pads: the rows [M, Mp) of each quad, the columns [M, Mp),
    # [Mp + M, 2Mp) and [2Mp, Kp) the loader fills with zeros
    for q in range(4):
        assert not w[:, q * mp + m:(q + 1) * mp].any()
    for lo_k, hi_k in ((m, mp), (mp + m, 2 * mp), (2 * mp, kp)):
        assert not w[:, :, lo_k:hi_k].any()
    # the plain version reads the blocks back exactly
    for i, (hi_b, lo_b) in enumerate(fsrc.operator_blocks(wcopy, m)):
        a = (p["a_atm"], p["a_aer"])[i // 2][(i % 2) * m:(i % 2 + 1) * m]
        want = precision.split_bf16(torch.as_tensor(a))
        assert torch.equal(hi_b, want[0].float()) and torch.equal(lo_b, want[1].float())
        assert hi_b.is_contiguous() and lo_b.is_contiguous()
    # and the kernel's indexing over the copy gives the plain version's J_n
    assert_close_scaled(_kernel_twin(dn, up, wcopy, cols, mm).numpy(),
                        fsrc.fused_source_plain(dn, up, wcopy, cols, mm).numpy(),
                        rtol=0.0, atol_scale=1e-6)


def _tie_values(rng, shape):
    """float32 values whose low 16 bits sit exactly on the bf16 tie."""
    bits = rng.integers(0x3C000000, 0x40000000, size=shape, dtype=np.uint32)
    return ((bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000)).view(np.float32)


@pytest.mark.parametrize("mm", SPLIT)
def test_the_split_is_ties_away_as_make_split_dot(mm):
    rng = np.random.default_rng(3)
    ties = _tie_values(rng, (64,))
    x = np.concatenate([ties, rng.standard_normal(64).astype(np.float32),
                        -ties, _tie_values(rng, (64,)) * np.float32(1.0 + 2.0 ** -9)])
    twin = _split_like_kernel(x, mm)
    parts = precision.split_operand(torch.as_tensor(x), mm, torch.float32)
    for a, b in zip(twin, parts):
        np.testing.assert_array_equal(a, b.numpy())
    # on a tie x1 rounds away from zero, where .to(bfloat16) rounds to even
    x1 = twin[0][:64]
    even = torch.as_tensor(ties).to(torch.bfloat16).float().numpy()
    assert np.all(np.abs(x1) >= np.abs(ties)) and np.any(x1 != even)
    # the parts sum to x exactly: always in bf16x5, on the ties in bf16x3
    total = sum(p.astype(np.float64) for p in twin)
    exact = slice(None) if mm == "bf16x5" else np.r_[0:64, 128:192]
    np.testing.assert_array_equal(total[exact], x[exact].astype(np.float64))


def _fused_batch(dtype, mm, m=24, L=16, B=2):
    grid = GridSpec(m, L)
    tables = PhaseTables.from_models(grid, 0.5, aer=("hg", {"g": 0.7}), dtype=dtype,
                                     device=CPU, cache=False)
    opts = SolverOptions(surface="lambertian", dtype=str(dtype).split(".")[1], mm=mm)
    scenes = dataclasses.replace(broadcast_scene(Scene(), B, device=CPU),
                                 tau_star_aer=torch.linspace(0.05, 0.3, B,
                                                             dtype=torch.float64))
    with _as_on_the_cpu():
        return FusedBatch(scenes, tables, grid, opts, CPU), (scenes, tables, grid, opts)


def _source_calls(lib):
    return [args for name, args, _ in lib.calls if name == "sos_fused_source"]


@pytest.fixture
def no_split_products(monkeypatch):
    """Fail if any split product of ops/precision.py runs."""
    def refuse(*a, **kw):
        raise AssertionError("a split product ran")

    for mod in (precision, fsrc):
        monkeypatch.setattr(mod, "split_dot", refuse)


@pytest.mark.parametrize("mm", SPLIT)
def test_fused_split_modes_launch_the_kernel_once_an_order(fake_card, no_split_products,
                                                            mm):
    fb, _ = _fused_batch(torch.float32, mm)
    B, L, M = fb.B, fb.L, fb.M
    dn, up = fb.i1[:, :, :M], fb.i1[:, :, M:]          # order 1: halves of I1
    for order in range(2):
        ptrs = (dn.data_ptr(), up.data_ptr(), dn.stride(1), up.stride(1))
        dn, up = fb.order_step(dn, up)
        args = _source_calls(fake_card)[order]
        assert args[0] == {"bf16x3": 1, "bf16x5": 2}[mm]
        assert args[1:5] == ptrs
        assert args[5:10] == (fb.wcopy.data_ptr(), fb.wcopy.shape[2], fb.cols[0].data_ptr(),
                              fb.cols[1].data_ptr(), args[9])
        assert args[10:14] == (B, L, M, mk.pad_angles(M))
    # I1's halves (row stride 2M), then the (B, L, M) fields
    assert [a[3] for a in _source_calls(fake_card)] == [2 * M, M]
    assert fsrc.fused_source.launches == 2
    assert fb.wcopy.shape[:2] == (2, 4 * mk.pad_angles(M))


@pytest.mark.parametrize("dtype,mm", [(torch.float64, "bf16x3"), (torch.float32, "highest"),
                                      (torch.float32, None)])
def test_fused_other_modes_take_the_matmul_path(fake_card, dtype, mm):
    fb, _ = _fused_batch(dtype, mm)
    M = fb.M
    fb.order_step(fb.i1[:, :, :M], fb.i1[:, :, M:])
    assert _source_calls(fake_card) == [] and fsrc.fused_source.launches == 0
    assert fb.mm is None and not hasattr(fb, "wcopy")


def _reference_step(dtype, mm, model=None):
    """One order of the reference engine, set up with every tensor claiming
    to be on a card."""
    _, (scenes, tables, grid, opts) = _fused_batch(dtype, mm)
    scenes = scenes.map(lambda x: x.to(dtype))
    i1, step, *_ = solver._setup_column(scenes, tables, grid, opts, model=model)
    step(i1)
    return i1, grid.nb_angles


@pytest.mark.parametrize("mm", SPLIT)
def test_reference_split_modes_launch_the_kernel(fake_card, no_split_products, mm):
    i1, M = _reference_step(torch.float32, mm)
    (args,) = _source_calls(fake_card)
    # the halves of the (B, L, 2M) field as they are: row stride 2M
    assert args[1:5] == (i1.data_ptr(), i1.data_ptr() + 4 * M, 2 * M, 2 * M)
    assert args[10:13] == (i1.shape[0], i1.shape[1], M)
    assert fsrc.fused_source.launches == 1


@pytest.mark.parametrize("dtype,mm", [(torch.float64, "bf16x3"), (torch.float32, "highest"),
                                      (torch.float32, None)])
def test_reference_other_modes_take_the_matmul_path(fake_card, dtype, mm):
    _reference_step(dtype, mm)
    assert _source_calls(fake_card) == [] and fsrc.fused_source.launches == 0


@pytest.mark.parametrize("mm", SPLIT)
def test_reference_shard_tables_keeps_the_split_products(fake_card, monkeypatch, mm):
    """Each rank of shard_tables holds only some of the operators' columns:
    its products stay the plain split ones (one rank here, the gather a
    copy)."""
    made = []
    real = solver.make_split_dot

    def spy(a, mode, dtype):
        made.append((tuple(a.shape), mode))
        return real(a, mode, dtype)

    monkeypatch.setattr(solver, "make_split_dot", spy)
    monkeypatch.setattr(solver.dist, "all_gather_into_tensor",
                        lambda out, y, group=None: out.copy_(y))
    _, M = _reference_step(torch.float32, mm, model=(None, 0, 1))
    assert made == [((2 * M, 2 * M), mm)] * 2
    assert _source_calls(fake_card) == [] and fsrc.fused_source.launches == 0


@pytest.mark.parametrize("mm", SPLIT)
def test_on_the_cpu_nothing_launches(mm):
    fb, (scenes, tables, grid, opts) = _fused_batch(torch.float32, mm)
    ms.reset_launches()
    sol = solve_batch_fused(scenes, tables, grid, opts, device="cpu")
    ref = solve_batch_reference(scenes.map(lambda x: x.to(torch.float32)), tables, grid,
                                opts, device="cpu")
    assert all(k.launches == 0 for k in ms.COUNTED_KERNELS)
    assert fsrc.fused_source in ms.COUNTED_KERNELS
    assert bool(torch.isfinite(sol.i_total).all())
    assert bool(torch.isfinite(ref.i_total).all())
    M = fb.M
    dn, up = fb.i1[:, :, :M], fb.i1[:, :, M:]
    assert torch.equal(fb.source(dn, up), fsrc.fused_source_plain(dn, up, fb.wcopy,
                                                                  fb.cols, mm))


def test_the_wrapper_refuses_what_the_kernel_does_not_take(fake_card):
    p = _problem(13)
    dn, up, wcopy, cols = _port(p, "bf16x3")
    with pytest.raises(ValueError, match="split modes"):
        fsrc.fused_source(dn, up, wcopy, cols, "highest")
    with pytest.raises(ValueError, match="evenly spaced"):
        fsrc.fused_source(dn.transpose(0, 1).contiguous().transpose(0, 1), up, wcopy,
                          cols, "bf16x3")
    with pytest.raises(ValueError, match="does not fit"):
        fsrc.fused_source(dn, up, wcopy[:, :, :16].contiguous(), cols, "bf16x3")
    with pytest.raises(ValueError, match="must fit the batch"):
        fsrc.fused_source(dn, up, wcopy, (cols[0][:, :2].contiguous(), cols[1]), "bf16x3")
    assert fake_card.calls == [] and fsrc.fused_source.launches == 0


def test_a_failing_launch_raises(fake_card):
    """No fallback: a launch the card refuses raises, and counts nothing."""
    fake_card.fail.add("sos_fused_source")
    with pytest.raises(cuda_build.KernelLaunchError, match="sos_fused_source"):
        fsrc.fused_source(*_port(_problem(13), "bf16x5"), "bf16x5")
    assert fsrc.fused_source.launches == 0


def test_float32_bf16x5_matches_jax_fused():
    grid = JGrid(51, 32)
    opts = JOpts(surface="lambertian", dtype="float32", mm="bf16x5")
    scenes, tables = jax_scenes(3), jax_tables(grid)
    t32 = JTables(*(jnp.asarray(x, jnp.float32) for x in
                    (tables.p0_atm, tables.p_atm, tables.p0_aer, tables.p_aer)))
    ref = j_solve_batch_fused(scenes, t32, grid, opts, block_b=4, interpret=True)
    got = solve_batch_fused(*port_inputs(scenes, t32, grid, opts, dtype=torch.float32),
                            device="cpu")
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    for rows in (0, grid.nb_layers - 1):
        assert_close_scaled(got.i_total[:, rows].numpy(), ref.i_total[:, rows],
                            rtol=0.0, atol_scale=1e-5)


def test_a_trace_names_the_kernels_each_scope_launched():
    """tools/profile.py attributes each kernel to the scope whose host
    interval holds its launch, by name: chip_smoke.py's phase ``trace``
    holds the split modes' sos.source_jn to the source kernel alone."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from sos_rt_tpu_torch.tools import profile

    def ev(name, start, end, dev=DeviceType.CPU, id=0):
        return NS(name=name, id=id, device_type=dev, time_range=NS(start=start, end=end),
                  is_user_annotation=False, device_time_total=0.0)

    quad = ("void sos::tc::quad_mma<1, sos::tc::LoadFieldRows, "
            "(anonymous namespace)::X>(int)")
    events = [ev("sos.source_jn", 0, 10), ev("cudaLaunchKernel", 2, 3, id=7),
              ev("sos.down_sweep", 10, 20), ev("cudaLaunchKernel", 12, 13, id=8),
              ev("cudaLaunchKernel", 14, 15, id=9),
              ev(quad, 4, 9, DeviceType.CUDA, 7),
              ev("cutlass::Kernel2<cutlass_80_simt_sgemm>(Params)", 14, 18,
                 DeviceType.CUDA, 8),
              ev("void sos::down_sweep<float>(int)", 18, 19, DeviceType.CUDA, 9)]
    t = profile.read_trace(events, 20.0, torch.device("cuda"))
    assert t["scopes"]["sos.source_jn"]["kernels"] == {
        "sos::tc::quad_mma": {"calls": 1, "ms": 5 / 1e3}}
    assert set(t["scopes"]["sos.down_sweep"]["kernels"]) == {"cutlass::Kernel2",
                                                            "sos::down_sweep"}
