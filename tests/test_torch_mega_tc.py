"""The host side of the resident kernel's tensor-core product, and the
wrappers' device guard, on the CPU.

In float32 'bf16x3' / 'bf16x5' with Mp ≤ 256, ``sos_mega`` runs its two
products (I₁'s surface product, the Jₙ source product) on the tensor cores
(csrc/mega_mma.cuh) from the bf16 operator copies StreamOps builds on the
card.  Here: ``mega_call`` hands exactly those copies to ``sos_mega`` in
those modes and null pointers otherwise (float64, 'highest', Mp > 256, and
the surface copy of a specular surface), counts the launches that take the
tensor cores, and raises rather than launch without a copy the product
needs; the copies at the sweep's Mp = 64 and the predictor's Mp = 8 hold hi
and lo with K zero-padded to the k-tile; on CPU tensors ``mega_call`` still
runs ``mega_plain`` and counts no launch.  Every kernel wrapper launches
with the tensor's device current, so that the launch, the occupancy query
and the shared-memory attribute act on that device; passB and
up_sweep_smooth call their three stage kernels in order on shared buffers,
count one launch a call and raise, launching no later stage, when a stage
returns an error; and the docstrings say what ``mm=None`` and the default
engine mean.

The kernel library, the CUDA calls and ``Tensor.is_cuda`` are faked (the
``fake_card`` fixture), so these run the wrappers' card branch up to the
launch; the kernels themselves run in tests/test_torch_cuda.py on a card.
"""
import contextlib
import dataclasses
import functools
import inspect
import types

import pytest
import torch

from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
from sos_rt_tpu_torch.fused import FusedBatch, prepare_batch
from sos_rt_tpu_torch.ops import cuda_build
from sos_rt_tpu_torch.ops import fused_sweeps as fs
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.parallel import broadcast_scene, solve_batch
from sos_rt_tpu_torch.solver import PhaseTables

CPU = torch.device("cpu")
# real angle count of each padded Mp: the 64x128 sweep grid, the
# predictor's 8x16 grid, a ragged one, and one past the 256-thread block
ANGLES = {64: 64, 8: 8, 104: 100, 264: 260}


@contextlib.contextmanager
def _as_on_the_cpu():
    """Lift the fake card's Tensor.is_cuda for a while: inputs are prepared
    as the CPU prepares them."""
    with pytest.MonkeyPatch.context() as m:
        if "is_cuda" in vars(torch.Tensor):
            m.delattr(torch.Tensor, "is_cuda")
        yield


def _batch(mp: int, mm: str, dtype=torch.float32, surface="lambertian"):
    with _as_on_the_cpu():
        return _prepared(mp, mm, dtype, surface)


@functools.lru_cache(maxsize=None)
def _prepared(mp, mm, dtype, surface):
    grid = GridSpec(ANGLES[mp], 16)
    tables = PhaseTables.from_models(grid, 0.5, aer=("hg", {"g": 0.7}), dtype=dtype,
                                     device=CPU, cache=False)
    opts = SolverOptions(surface=surface, dtype=str(dtype).split(".")[1], mm=mm,
                         max_orders=6)
    scenes = dataclasses.replace(
        broadcast_scene(Scene(), 8, device=CPU),
        grd_alb=torch.linspace(0.0, 0.8, 8, dtype=torch.float64),
        tau_star_aer=torch.linspace(0.02, 0.35, 8, dtype=torch.float64))
    return prepare_batch(scenes, tables, grid, opts, device=CPU)


def _on_card(ops):
    """ops with the bf16 operator copies StreamOps.build makes on a card."""
    tc = ms.takes_tensor_cores(ops.dtype, ops.mm)
    return dataclasses.replace(
        ops, ws_tc=ms.tc_operator(*ops.ws) if tc else None,
        astk_tc=ms.tc_operator(*ops.astk) if tc and ops.lamb else None)


class FakeLibrary:
    """Records each entry point's call and the devices made current then;
    the entry points named in ``fail`` return a CUDA error code (1)."""

    def __init__(self, current):
        self.current, self.calls, self.fail = current, [], set()

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args, tuple(self.current)))
            if name in self.fail:
                return 1
            return 4 if name.endswith("_blocks") else 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor claims to be on a card; the kernel libraries, the
    current stream and torch.cuda.device are fakes that record."""
    current = []

    @contextlib.contextmanager
    def device(dev):
        current.append(torch.device(dev))
        try:
            yield
        finally:
            current.pop()

    lib = FakeLibrary(current)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True),
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(cuda_build, "library", lambda name: lib)
    ms.reset_launches()
    yield lib
    ms.reset_launches()


def _mega_args(lib):
    """{argument name: value} of the one sos_mega call the library saw."""
    (name, args, current), = [c for c in lib.calls if c[0] == "sos_mega"]
    names = ["dtype", "mode", "lamb", "full", "pack", "cpar", "tiles", "colc",
             "ws_hi", "ws_lo", "astk_hi", "astk_lo", "ws_tc", "astk_tc"]
    return dict(zip(names, args)), current


def _call(sb, ops):
    return mk.mega_call(sb.pack, sb.cpar, sb.tiles, ops, tol=1e-4, max_orders=6,
                        full=False)


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("mm", ["bf16x3", "bf16x5"])
@pytest.mark.parametrize("mp", [64, 8, 104])
def test_mega_call_hands_the_bf16_copies_to_sos_mega(fake_card, mp, mm, surface):
    sb = _batch(mp, mm, surface=surface)
    ops = _on_card(sb.ops)
    assert mk.takes_tensor_cores(ops)
    _call(sb, ops)
    args, current = _mega_args(fake_card)
    assert args["ws_tc"] == ops.ws_tc.data_ptr()
    if surface == "lambertian":
        assert args["astk_tc"] == ops.astk_tc.data_ptr()
    else:                              # no surface product: no copy
        assert ops.astk_tc is None and args["astk_tc"] is None
    assert current == (sb.pack.device,)
    assert (mk.mega_call.launches, mk.mega_call.tc_launches) == (1, 1)


@pytest.mark.parametrize("mp,dtype,mm", [(64, torch.float32, "highest"),
                                         (64, torch.float64, "highest"),
                                         (264, torch.float32, "bf16x3"),
                                         (264, torch.float32, "bf16x5")])
def test_simt_builds_get_no_copies(fake_card, mp, dtype, mm):
    """float64, 'highest' and the 512-thread block (Mp > 256) keep the SIMT
    product: sos_mega gets null pointers even where copies exist."""
    sb = _batch(mp, mm, dtype)
    ops = _on_card(sb.ops)
    assert not mk.takes_tensor_cores(ops)
    assert mk.tc_operands(ops) == (None, None)
    _call(sb, ops)
    args, _ = _mega_args(fake_card)
    assert args["ws_tc"] is None and args["astk_tc"] is None
    assert args["ws_hi"] == ops.ws[0].data_ptr()
    assert (mk.mega_call.launches, mk.mega_call.tc_launches) == (1, 0)


@pytest.mark.parametrize("missing", ["ws_tc", "astk_tc"])
def test_no_fallback_without_a_copy(fake_card, missing):
    sb = _batch(64, "bf16x3")
    ops = dataclasses.replace(_on_card(sb.ops), **{missing: None})
    with pytest.raises(ValueError, match=missing):
        _call(sb, ops)
    assert not [c for c in fake_card.calls if c[0] == "sos_mega"]
    assert mk.mega_call.launches == mk.mega_call.tc_launches == 0


@pytest.mark.parametrize("mm", ["bf16x3", "bf16x5"])
@pytest.mark.parametrize("mp", [64, 8])
def test_copies_hold_hi_and_lo_padded(mp, mm):
    ops = _on_card(_batch(mp, mm).ops)
    ws_tc, astk_tc = mk.tc_operands(ops)
    for w, (hi, lo), k in ((ws_tc, ops.ws, 2 * mp), (astk_tc, ops.astk, mp)):
        kp = -(-k // mk.TC_K_TILE) * mk.TC_K_TILE
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == (2, 4 * mp, kp)
        assert torch.equal(w[0, :, :k].float(), hi)
        assert torch.equal(w[1, :, :k].float(), lo)
        assert not w[:, :, k:].any()
    # K = 16 and 8 at the predictor's grid are padded to one k-tile
    assert (ws_tc.shape[-1], astk_tc.shape[-1]) == ((128, 64) if mp == 64 else (32, 32))


@pytest.mark.parametrize("mm", ["bf16x3", "highest"])
def test_cpu_mega_call_runs_mega_plain_without_launches(mm):
    sb = _batch(8, mm)
    ms.reset_launches()
    kw = dict(tol=1e-4, max_orders=6, full=False)
    got = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, cols_per_tile=8, **kw)
    want = mk.mega_plain(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sb.ops.ws_tc is None and sb.ops.astk_tc is None
    assert (mk.mega_call.launches, mk.mega_call.tc_launches) == (0, 0)


def test_streamed_wrappers_launch_on_the_tensors_device(fake_card):
    sb = _batch(64, "bf16x3")
    ops = _on_card(sb.ops)
    pack, cpar, tiles = sb.block(0)
    fdn, fup = ms.passI(pack, tiles, cpar, ops)
    sdn, jn = ms.passA(pack, fdn, fup, ops)
    ms.passB(pack, sdn, jn, cpar, ops)
    seen = {name: current for name, _, current in fake_card.calls}
    assert seen == {k: (pack.device,) for k in ("sos_passI", "sos_passA") + PASSB_STAGES}
    assert [(k.launches, k.tc_launches) for k in ms.TC_KERNELS] == [(1, 1), (1, 1)]


def test_sweep_wrappers_launch_on_the_tensors_device(fake_card):
    grid = GridSpec(56, 16)
    tables = PhaseTables.from_models(grid, 0.5, aer=("hg", {"g": 0.7}),
                                     dtype=torch.float64, device=CPU, cache=False)
    with _as_on_the_cpu():
        fb = FusedBatch(broadcast_scene(Scene(), 2, device=CPU), tables, grid,
                        SolverOptions(), CPU)
    m = fb.M
    jn = torch.zeros((2, grid.nb_layers, 2 * m), dtype=torch.float64)
    fs.down_sweep(jn[:, :, :m], fb.pack, fb.mu_down_safe)
    bc = torch.zeros((2, m), dtype=torch.float64)
    fs.up_sweep_smooth(jn[:, :, m:], fb.pack, fb.cparams, fb.mu_up_row, bc)
    seen = {name: current for name, _, current in fake_card.calls}
    assert seen == {k: (CPU,) for k in ("sos_down_sweep",) + UP_STAGES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_down_sweep_hands_the_half_view_to_the_kernel(fake_card, dtype):
    """The wrapper passes the strided half-view of the (B, L, 2M) source as
    it stands: its pointer and its column and layer strides, no copy."""
    B, L, M = 2, 16, 56
    jn = torch.zeros((B, L, 2 * M), dtype=dtype)
    pack = torch.zeros((B, L, fs.PK_W), dtype=dtype)
    mu = -torch.ones(M, dtype=dtype)
    out = fs.down_sweep(jn[:, :, :M], pack, mu)
    (name, args, current), = fake_card.calls
    assert name == "sos_down_sweep" and current == (CPU,)
    code = {torch.float32: 0, torch.float64: 1}[dtype]
    assert args[:5] == (code, jn.data_ptr(), pack.data_ptr(), mu.data_ptr(), out.data_ptr())
    assert args[5:10] == (B, L, M, L * 2 * M, 2 * M)
    assert out.shape == (B, L, M) and fs.down_sweep.launches == 1


@pytest.mark.parametrize("pack_shape, mu_len", [((2, 15, 8), 56), ((1, 16, 8), 56),
                                                 ((2, 16, 7), 56), ((2, 16, 8), 55)])
def test_down_sweep_refuses_operands_that_do_not_fit(fake_card, pack_shape, mu_len):
    with pytest.raises(ValueError, match="do not fit the source"):
        fs.down_sweep(torch.zeros((2, 16, 56)), torch.zeros(pack_shape), -torch.ones(mu_len))
    assert fake_card.calls == [] and fs.down_sweep.launches == 0


def test_a_failing_down_sweep_raises(fake_card):
    """A launch the card refuses raises; nothing falls back to the plain
    version and no launch is counted."""
    fake_card.fail.add("sos_down_sweep")
    with pytest.raises(cuda_build.KernelLaunchError, match="sos_down_sweep"):
        fs.down_sweep(torch.zeros((2, 16, 56)), torch.zeros((2, 16, fs.PK_W)),
                      -torch.ones(56))
    assert fs.down_sweep.launches == 0


# the C entry points of passB's and up_sweep_smooth's stages, in launch order
PASSB_STAGES = ("sos_passB_band", "sos_passB_walk", "sos_passB_smooth")
UP_STAGES = ("sos_up_walk", "sos_up_joins", "sos_up_rows")


def _passb_call(dtype=torch.float32, mm="bf16x3"):
    """passB on the block of a prepared batch, and what it was called on."""
    sb = _batch(64, mm, dtype)
    ops = _on_card(sb.ops)
    pack, cpar, tiles = sb.block(0)
    L, C, mp = pack.shape[1], pack.shape[2], ops.mp
    sdn = torch.zeros((L, C, mp), dtype=dtype)
    return lambda: ms.passB(pack, sdn, sdn.clone(), cpar, ops), (L, C, mp, ops)


def _up_call(dtype=torch.float64):
    grid = GridSpec(56, 16)
    tables = PhaseTables.from_models(grid, 0.5, aer=("hg", {"g": 0.7}),
                                     dtype=dtype, device=CPU, cache=False)
    with _as_on_the_cpu():
        fb = FusedBatch(broadcast_scene(Scene(), 2, device=CPU), tables, grid,
                        SolverOptions(dtype=str(dtype).split(".")[1]), CPU)
    m = fb.M
    jn = torch.zeros((2, grid.nb_layers, 2 * m), dtype=dtype)
    bc = torch.zeros((2, m), dtype=dtype)
    return (lambda: fs.up_sweep_smooth(jn[:, :, m:], fb.pack, fb.cparams, fb.mu_up_row, bc),
            (2, grid.nb_layers, m))


@pytest.mark.parametrize("dtype,mm", [(torch.float32, "bf16x3"), (torch.float32, "bf16x5"),
                                      (torch.float32, "highest"), (torch.float64, "highest")])
def test_passb_launches_its_three_stages(fake_card, dtype, mm):
    """passB calls the band fix, the walk and the smoothing, in that order,
    each with the tensor's device current and the block's shapes, and counts
    one launch a call; the walk and the smoothing work on the same fup."""
    call, (L, C, mp, ops) = _passb_call(dtype, mm)
    fdn, fup = call()
    calls = [(name, args) for name, args, _ in fake_card.calls]
    assert [name for name, _ in calls] == list(PASSB_STAGES)
    assert {cur for _, _, cur in fake_card.calls} == {(CPU,)}
    (_, band), (_, walk), (_, smooth) = calls
    code = ({torch.float32: 0, torch.float64: 1}[dtype], {"highest": 0, "bf16x3": 1,
                                                           "bf16x5": 2}[mm])
    assert band[:2] == walk[:2] == code and smooth[0] == code[0]
    assert band[-6:-1] == (L, C, mp, ops.nb_angles, ops.slot)
    assert walk[-5:-1] == smooth[-5:-1] == (L, C, mp, ops.nb_angles)
    assert band[9] == walk[8] == fdn.data_ptr()          # stage 1 writes, 2 reads
    assert walk[9] == smooth[1] == fup.data_ptr()         # stage 2 writes, 3 smooths
    assert ms.passB.launches == 1


def test_up_sweep_launches_its_three_stages(fake_card):
    """up_sweep_smooth calls the walk, the join smoothings and the row pass,
    in that order, with the tensor's device current; the three share the
    (B, 2, M) buffer of the join rows, and one call counts one launch."""
    call, (B, L, m) = _up_call()
    out = call()
    calls = [(name, args) for name, args, _ in fake_card.calls]
    assert [name for name, _ in calls] == list(UP_STAGES)
    assert {cur for _, _, cur in fake_card.calls} == {(CPU,)}
    (_, walk), (_, joins), (_, rows) = calls
    assert walk[5] == rows[5] == out.data_ptr()
    assert walk[6] == joins[3] == rows[4]               # the join rows' buffer
    assert walk[7:10] == rows[6:9] == (B, L, m) and joins[4:6] == (B, m)
    assert fs.up_sweep_smooth.launches == 1


@pytest.mark.parametrize("stage", PASSB_STAGES + UP_STAGES)
def test_a_failing_stage_raises(fake_card, stage):
    """A stage whose entry point returns an error raises: no later stage
    is launched, no launch is counted, nothing falls back to the plain
    version."""
    fake_card.fail.add(stage)
    stages = PASSB_STAGES if stage in PASSB_STAGES else UP_STAGES
    call = _passb_call()[0] if stage in PASSB_STAGES else _up_call()[0]
    with pytest.raises(cuda_build.KernelLaunchError, match=stage):
        call()
    names = [name for name, _, _ in fake_card.calls]
    assert names == list(stages[:stages.index(stage) + 1])
    assert ms.passB.launches == fs.up_sweep_smooth.launches == 0


def test_solver_options_mm_docstring_names_each_engines_default():
    doc = " ".join(inspect.getdoc(SolverOptions).split())
    assert ("None is the engine's default: 'bf16x3' for the mega engine, "
            "full-precision products ('highest') for the fused engine") in doc


def test_solve_batch_docstring_states_the_default_engine():
    sig = inspect.signature(solve_batch)
    assert sig.parameters["engine"].default == "reference"      # as in the JAX package
    doc = " ".join(inspect.getdoc(solve_batch).split())
    assert "``engine='reference'`` (default): the reference engine" in doc


@pytest.mark.parametrize("mm", ["bf16x3", "highest"])
def test_mega_call_with_host_i1_launches_sos_mega_i1in(fake_card, mm):
    """With the host's I₁ planes, mega_call launches sos_mega_i1in: the two
    planes first, then sos_mega's arguments, with no surface-operator copy
    (the kernel evaluates no I₁); it counts in mega_call.i1in_launches."""
    sb = _batch(64, mm)
    ops = _on_card(sb.ops)
    L, C, Mp = sb.pack.shape[1], sb.pack.shape[2], ops.mp
    i1dn = torch.zeros((L, C, Mp))
    i1up = torch.ones((L, C, Mp))
    mk.mega_call(sb.pack, sb.cpar, sb.tiles, ops, tol=1e-4, max_orders=6, full=False,
                 i1dn=i1dn, i1up=i1up)
    names = [c[0] for c in fake_card.calls]
    assert names == ["sos_mega_i1in_blocks", "sos_mega_i1in"]
    (_, args, current), = [c for c in fake_card.calls if c[0] == "sos_mega_i1in"]
    assert args[:2] == (i1dn.data_ptr(), i1up.data_ptr())
    assert args[6] == sb.pack.data_ptr() and current == (sb.pack.device,)
    tc = mm != "highest"
    assert args[14] == (ops.ws_tc.data_ptr() if tc else None) and args[15] is None
    assert (mk.mega_call.launches, mk.mega_call.tc_launches,
            mk.mega_call.i1in_launches) == (1, int(tc), 1)
    assert len(args) == len(cuda_build.SIGNATURES["megakernel"]["sos_mega_i1in"])


# the streamed passes' ablated builds (csrc/megastream_ablate.cu): the AB bit
# of each flag (csrc/sos_tiles.cuh)
PASS_FLAG_BITS = {"nosrc": 4, "noloops": 8, "nopoly": 32, "nofin": 256, "nosmooth": 512}


@pytest.mark.parametrize("name,flag", [("passA", f) for f in ms.PASS_A_FLAGS]
                         + [("passB", f) for f in ms.PASS_B_FLAGS])
def test_pass_flags_launch_the_ablated_build(fake_card, name, flag):
    """A pass with a flag calls its ablated build's one entry point with the
    flag's AB bit first, under the tensor's device, and counts it in
    ``ablate_launches``, not in ``launches``; no flag with
    ``ablate_build=True`` calls the same entry point with mask 0."""
    sb = _batch(64, "bf16x3", torch.float32)
    ops = _on_card(sb.ops)
    pack, cpar, tiles = sb.block(0)
    f = torch.zeros((pack.shape[1], pack.shape[2], ops.mp))
    call = ((lambda **kw: ms.passA(pack, f, f.clone(), ops, **kw)) if name == "passA"
            else (lambda **kw: ms.passB(pack, f, f.clone(), cpar, ops, **kw)))
    call(ab={flag})
    call(ablate_build=True)
    entry = f"sos_{name}_ablate"
    assert [c[0] for c in fake_card.calls] == [entry, entry]
    assert [c[1][:3] for c in fake_card.calls] == [(PASS_FLAG_BITS[flag], 0, 1), (0, 0, 1)]
    assert {cur for _, _, cur in fake_card.calls} == {(CPU,)}
    wrapper = getattr(ms, name)
    assert wrapper.ablate_launches == 2 and wrapper.launches == 0
    assert ms.passA.tc_launches == 0


def test_pass_flags_refuse_what_is_not_built(fake_card):
    """Two flags at once, or another pass's flag, raise before any launch;
    a failing ablated build raises and counts nothing."""
    sb = _batch(64, "bf16x3", torch.float32)
    ops = _on_card(sb.ops)
    pack, cpar, tiles = sb.block(0)
    f = torch.zeros((pack.shape[1], pack.shape[2], ops.mp))
    with pytest.raises(ValueError, match="one flag at a time"):
        ms.passA(pack, f, f, ops, ab={"nosrc", "noloops"})
    with pytest.raises(ValueError, match="passB takes"):
        ms.passB(pack, f, f, cpar, ops, ab={"nosrc"})
    fake_card.fail.add("sos_passB_ablate")
    with pytest.raises(cuda_build.KernelLaunchError, match="sos_passB_ablate"):
        ms.passB(pack, f, f, cpar, ops, ab={"nofin"})
    assert [c[0] for c in fake_card.calls] == ["sos_passB_ablate"]
    assert ms.passB.ablate_launches == ms.passB.launches == 0
