"""Streamed whole-solve engine: the three kernels and the order loop.

Counterpart of ``sos_rt_tpu/ops/megastream.py``.  Per block of C columns
the two half-fields live in device memory as (L, C, Mp) tensors (angles
last; Mp = pad_angles(M)), and each scattering order runs two passes:

- :func:`passA` — the Jₙ source product W·[I↓; I↑] with the stacked
  (4Mp, 2Mp) operator, mixed per (layer, column) by coef_atm/coef_aer,
  then the downward recurrence r_t = e^{2·hdt_dn_t/µ}·r_{t−1} + cdn_t·jₙ↓_t.
  Returns sdn = r − hdt_up·jₙ↓ and jₙ↑.
- :func:`passB` — the surface BC from the deepest band-fixed I↓, then in
  reverse over layers: I↓ = −sdn/µ with the µ→0⁻ band fix, the upward
  recurrence with the µ=0⁺ row pinned to jₙ, the q1/q2 join corrections
  and the µ→0⁺ smoothing walk.  Returns the new half-fields.

:func:`passI` evaluates the closed-form first order that starts the loop.
The order loop (:func:`solve_block`) gathers a block's still-running
columns into narrower planes as columns converge, so both passes run only
on the columns whose orders are still needed.
With ``ab`` flags (:data:`PASS_A_FLAGS`, :data:`PASS_B_FLAGS`) passA and
passB cut stages out for timing attribution (``tools/ablate_stream.py``;
results are wrong): on a card they launch the ablated builds of
``csrc/megastream_ablate.cu`` and count them in ``ablate_launches``.

Each pass is a wrapper: on a CUDA tensor it launches the hand-written
kernels of ``csrc/megastream.cu`` (or raises) and adds one to its
``launches`` count; on a CPU tensor it runs the plain PyTorch version
beside it (``passI_plain``, ``passA_plain``, ``passB_plain``), which is
also what the kernels are held against on the card.  In float32 'bf16x3'
and 'bf16x5' the products of passI and passA run on the tensor cores
(``csrc/quad_mma.cuh``), from bf16 copies of the split operators that
:meth:`StreamOps.build` makes on the card; those launches also count in
``tc_launches``.  passB runs as three kernels split by what depends on the
layer below (``csrc/pass_b_split.cuh``).  The three passes' bodies, as
device functions (passB's as one layer walk), make up the resident
whole-loop kernel (``ops/megakernel.py::mega_call``), which runs the order
loop on the device instead of in :func:`solve_block`, with its own
tensor-core product (``csrc/mega_mma.cuh``) from the same copies.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sos_rt_tpu_torch.ops import cuda_build, fused_source, fused_sweeps, micro
from sos_rt_tpu_torch.ops.megakernel import (
    ABLATE_FLAGS, CP_CONST, CP_GRD, PK_ASTAR, PK_CDN, PK_CHOICE, PK_COEF_AER, PK_COEF_ATM,
    PK_CUP, PK_GS, PK_HDT_DN, PK_HDT_UP, PK_R1, PK_R2, RC_EMU_DN, RC_EMU_UP,
    RC_IVDN, RC_IVUP, RC_MUUP, RC_PKA, RC_PKR, ST_CONV, ST_N, ST_RATIO,
    TC_K_TILE, _dot3, _smooth_up, add_terms, angle_rows, band_fix_tile,
    band_validity, bc_matrix, make_i1_block, mega_call, ratio_rows_tile,
    split_parts, stencil_taps, tc_operator)
from sos_rt_tpu_torch.ops.precision import split_bf16
from sos_rt_tpu_torch.spans import FIRST_ORDER, LOOP_COND, ORDER, ORDER_COMPACT, span

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_MM_CODE = {"highest": 0, "bf16x3": 1, "bf16x5": 2}


def takes_tensor_cores(dtype, mm: str) -> bool:
    """Whether passI / passA run their product on the tensor cores: float32
    with a bf16 split ('bf16x3', 'bf16x5').  float64 and 'highest' have no
    bf16 split and stay on the SIMT product."""
    return dtype == torch.float32 and mm != "highest"


@dataclasses.dataclass(frozen=True)
class StreamOps:
    """Per-solve constants of the three passes, as contiguous ``dtype``
    tensors: the stacked operators as (hi, lo) pairs (hi is the operator
    itself and lo a (1, 1) zero in mode 'highest'), the band stencil as
    its ≤ 6 taps per row, and the BC matrix transposed.  On the card, in
    the modes that take the tensor cores, also the operators' bf16 copies
    (:func:`tc_operator`); None elsewhere (the plain versions never read
    them)."""

    mm: str
    nb_angles: int             # real angle count (rows ≥ it are pads)
    lamb: bool
    colc: torch.Tensor         # (7, Mp) per-angle rows, RC_* order
    ws: tuple                  # stacked source operator (4Mp, 2Mp)
    astk: tuple                # stacked surface operator (4Mp, Mp)
    taps: tuple                # (cols int32, hi, lo), each (4·SLOT, 6)
    pvt: torch.Tensor          # (4, Mp) placed-row validity per band choice
    bct: tuple                 # BC matrix transposed, (hi, lo) each (Mp, Mp)
    ws_tc: torch.Tensor | None = None     # tc_operator(*ws), (2, 4Mp, Kp)
    astk_tc: torch.Tensor | None = None   # tc_operator(*astk) (Lambertian)

    @property
    def mp(self) -> int:
        return self.colc.shape[1]

    @property
    def slot(self) -> int:
        return self.taps[0].shape[0] // 4

    @property
    def dtype(self) -> torch.dtype:
        return self.colc.dtype

    @classmethod
    def build(cls, grid, stencils, surface: str, w_mu, ws, astk, colc_pk, *,
              mm: str, dtype, device):
        """From the grid, its stencils, the surface, the (2M,) quadrature
        weights, the stacked source operator, the surface operator (None
        for a specular surface) and the (2, Mp) excised-singularity rows."""
        m = grid.nb_angles
        mu = np.asarray(grid.mu(), np.float64)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        colc = torch.cat([as_t(angle_rows(mu, m)), colc_pk.to(dtype)])
        zero = torch.zeros((1, 1), dtype=dtype, device=device)
        pair = lambda p: tuple(x.to(dtype).contiguous() for x in p)
        bct = np.ascontiguousarray(bc_matrix(surface, w_mu, mu, m).T)
        if mm == "highest":
            bc_hi = as_t(bct)
            bc_lo = torch.zeros_like(bc_hi)
        else:
            bc_hi, bc_lo = (p.to(dtype=dtype, device=device) for p in split_bf16(bct))
        ws = pair(ws)
        astk = pair(astk) if astk is not None else None
        tc = takes_tensor_cores(dtype, mm) and colc.is_cuda
        return cls(mm=mm, nb_angles=m, lamb=surface == "lambertian", colc=colc,
                   ws=ws, astk=astk if astk is not None else (zero, zero),
                   taps=stencil_taps(stencils, mm, dtype, device),
                   pvt=as_t(band_validity(stencils, m)), bct=(bc_hi, bc_lo),
                   ws_tc=tc_operator(*ws) if tc else None,
                   astk_tc=tc_operator(*astk) if tc and astk is not None else None)

    def dot3(self, hi, lo, x):
        return _dot3(hi, lo, x, mm=self.mm, dtype=self.dtype)


# The streamed execution's ablation flags (the TPU engine's ``ablate``,
# sos_rt_tpu/ops/megastream.py:313, 403-435; tools/ablate_stream.py): each
# cuts a stage out for timing attribution, and results are wrong with any
# flag set.  passA takes PASS_A_FLAGS and passB PASS_B_FLAGS (their ablated
# builds: each flag alone); the order loop takes the others: 'sccond' stops
# on column 0's order count alone, 'noconv' counts every order of every
# column and stops at max_orders, 'nopassA' / 'nopassB' pass the pass's
# inputs through, 'notiles' accumulates no boundary rows and 'noratio'
# updates no ratio.
STREAM_ABLATE_FLAGS = ("sccond", "noconv", "nosrc", "noloops", "nopassA", "nopoly",
                       "nopassB", "nofin", "nosmooth", "notiles", "noratio")
PASS_A_FLAGS = ("nosrc", "noloops")
PASS_B_FLAGS = ("nopoly", "noloops", "nofin", "nosmooth")


def stream_ablate_flags(ablate: str) -> frozenset:
    """The set of flags of a comma-separated ``ablate`` string of the
    streamed execution; raises ValueError for a flag it does not take."""
    ab = frozenset(f for f in ablate.split(",") if f) if ablate else frozenset()
    unknown = sorted(ab - set(STREAM_ABLATE_FLAGS))
    if unknown:
        raise ValueError(f"unknown ablate flags {unknown} for the streamed execution; "
                         f"known: {STREAM_ABLATE_FLAGS}")
    return ab


def _pass_flags(ab, flags, name: str) -> frozenset:
    ab = frozenset(ab)
    unknown = sorted(ab - set(flags))
    if unknown:
        raise ValueError(f"{name} takes the ablate flags {flags}; got {unknown}")
    return ab


def _pass_mask(ab: frozenset, name: str) -> int:
    """The AB bits (csrc/sos_tiles.cuh) of a pass's flags: its ablated build
    has each flag alone and none."""
    if len(ab) > 1:
        raise ValueError(f"{name}'s ablated build takes one flag at a time; "
                         f"got {sorted(ab)}")
    return sum(1 << ABLATE_FLAGS.index(f) for f in ab)


# --------------------------------------------------------------------------
# Plain versions (angles last: fields (L, C, Mp), pack (PK_W, L, C))
# --------------------------------------------------------------------------

def passI_plain(pack, tiles, cpar, ops: StreamOps):
    """Closed-form I₁ → (fdn, fup), each (L, C, Mp)."""
    Mp, mr = ops.mp, ops.nb_angles
    rowf = torch.arange(Mp, device=pack.device)
    row0, lastrow = rowf < 0.5, rowf > mr - 1.5
    ivup = ops.colc[RC_IVUP]
    i1_block = make_i1_block(
        lambda i: tiles[i][None], ops.colc[RC_EMU_DN], ivup, row0, lastrow,
        cpar[CP_CONST][:, None], ops.colc[RC_PKA], ops.colc[RC_PKR], ops.lamb)
    s = lambda row: pack[row][..., None]
    et = torch.where(row0, 0.0, torch.exp(s(PK_ASTAR) * ivup))
    eout = None
    if ops.lamb:
        out = ops.dot3(*ops.astk, et)                     # (L, C, 4Mp)
        eout = [out[..., k * Mp:(k + 1) * Mp] for k in range(4)]
    return i1_block(s, eout, et)


def passA_plain(pack, fdn, fup, ops: StreamOps, ab=frozenset()):
    """Jₙ source product + downward recurrence → (sdn, jnup).  ``ab``
    (ablation flags, as ``megakernel.mega_plain`` takes them): 'nosrc'
    takes jₙ = I + 1 instead of the product, 'noloops' drops the carry."""
    Mp = ops.mp
    if "nosrc" in ab:
        jnd, jnu = fdn + 1.0, fup + 1.0
    else:
        out = ops.dot3(*ops.ws, torch.cat([fdn, fup], dim=-1))   # (L, C, 4Mp)
        ca = pack[PK_COEF_ATM][..., None]
        cr = pack[PK_COEF_AER][..., None]
        jnd = ca * out[..., :Mp] + cr * out[..., 2 * Mp:3 * Mp]
        jnu = ca * out[..., Mp:2 * Mp] + cr * out[..., 3 * Mp:]
    att = torch.exp(2.0 * pack[PK_HDT_DN][..., None] * ops.colc[RC_EMU_DN])
    src = pack[PK_CDN][..., None] * jnd
    hup = pack[PK_HDT_UP][..., None]
    sdn = torch.empty_like(jnd)
    r = torch.zeros_like(jnd[0])
    for t in range(jnd.shape[0]):
        r = src[t] if "noloops" in ab else att[t] * r + src[t]
        sdn[t] = r - hup[t] * jnd[t]
    return sdn, jnu


def passB_plain(pack, sdn, jnup, cpar, ops: StreamOps, ab=frozenset()):
    """Surface BC, band fix, upward recurrence, join corrections and
    smoothing → (fdn, fup).  ``ab`` (ablation flags, as
    ``megakernel.mega_plain`` takes them): 'nopoly' (no band fix), 'nobc' (the carry
    starts from jₙ↑ of the deepest layer), 'noloops' (no carry), 'nofin'
    (no corrections, no smoothing), 'nosmooth' (no smoothing)."""
    L, C, Mp = sdn.shape
    mr = ops.nb_angles
    rowf = torch.arange(Mp, device=sdn.device)
    row0 = rowf < 0.5
    corr = (rowf >= 0.5).to(sdn.dtype)
    lastrow = rowf > mr - 1.5
    colc = ops.colc
    if "nopoly" in ab:
        fv = torch.where(lastrow, 0.0, -sdn * colc[RC_IVDN])
    else:
        fv = band_fix_tile(-sdn * colc[RC_IVDN], pack[PK_CHOICE], lastrow,
                           taps=ops.taps, pvt=ops.pvt, mm=ops.mm, nb_angles=mr)
    if "nobc" in ab:
        r = jnup[L - 1]
    else:
        # surface BC from the deepest layer's band-fixed I↓, summed over
        # the angles in the order the kernel sums them
        parts = split_parts(fv[L - 1], ops.mm)
        bc = torch.zeros_like(fv[L - 1])
        for k in range(Mp):
            bc = add_terms(bc, ops.bct[0][k], ops.bct[1][k],
                           [p[:, k:k + 1] for p in parts], ops.mm)
        r = torch.where(row0, jnup[L - 1], cpar[CP_GRD][:, None] * bc)
    aup = torch.exp(2.0 * pack[PK_HDT_UP][..., None] * colc[RC_EMU_UP])
    attu = torch.where(row0, 0.0, aup)
    jiv = colc[RC_IVUP] * jnup
    src = torch.where(row0, jnup, pack[PK_CUP][..., None] * jiv)
    gsv = pack[PK_GS][..., None] * jiv
    r1row = pack[PK_R1][..., None] > 0.5
    r2row = pack[PK_R2][..., None] > 0.5
    q1 = q2 = torch.zeros_like(r)
    fup = torch.empty_like(sdn)
    for t in range(L - 1, -1, -1):
        r = src[t] if "noloops" in ab else attu[t] * r + src[t]
        f = r - gsv[t]
        sm = f
        if "nofin" not in ab:
            q1 = q1 * attu[t]
            q2 = q2 * attu[t]
            f = f + corr * (q1 + q2)
            sm = f if "nosmooth" in ab else _smooth_up(f, mr, colc[RC_MUUP])
            d = sm - f
            q1 = torch.where(r1row[t], d, q1)
            q2 = torch.where(r2row[t], d, q2)
        fup[t] = sm
    return fv, fup


# --------------------------------------------------------------------------
# Wrappers: the CUDA kernel on a card, the plain version on the CPU
# --------------------------------------------------------------------------

def _kernel_codes(ops: StreamOps, *tensors):
    """Check what the kernels take; return (dtype code, mode code, stream)."""
    dtype, dev = ops.dtype, ops.colc.device
    for t in tensors:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"kernel operand must be a contiguous {dtype} tensor on {dev}; "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if dtype not in _DTYPE_CODE or (dtype == torch.float64 and ops.mm != "highest"):
        raise ValueError(f"the kernels take float32 (any mm) or float64 "
                         f"(mm='highest'); got {dtype}, mm={ops.mm!r}")
    return (_DTYPE_CODE[dtype], _MM_CODE[ops.mm],
            torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _tc_args(ops: StreamOps, w):
    """(takes the tensor cores, pointer, row length) of the bf16 operator
    copy ``w`` (None where there is none: a specular passI, whose product is
    empty, or a mode on the SIMT product)."""
    tc = takes_tensor_cores(ops.dtype, ops.mm)
    return tc, (w.data_ptr() if w is not None else None), (w.shape[-1] if w is not None else 0)


def passI(pack, tiles, cpar, ops: StreamOps):
    """First order I₁ → (fdn, fup) (L, C, Mp).  Replaces
    sos_rt_tpu/ops/megastream.py::_passI_kernel.  Bound by the operations
    of the (4Mp, Mp) surface product; the kernel is a tiled product (on the
    tensor cores in float32 'bf16x3' / 'bf16x5', FMAs otherwise) whose
    epilogue evaluates the closed form (csrc/megastream.cu)."""
    if not pack.is_cuda:
        return passI_plain(pack, tiles, cpar, ops)
    dt, mm, stream = _kernel_codes(ops, pack, tiles, cpar)
    _, L, C = pack.shape
    fdn = torch.empty((L, C, ops.mp), dtype=ops.dtype, device=pack.device)
    fup = torch.empty_like(fdn)
    tc, w_tc, kp = _tc_args(ops, ops.astk_tc)
    lib = cuda_build.library("megastream")
    # the launch (and the tensor-core kernel's shared-memory attribute) acts
    # on the current device
    with torch.cuda.device(pack.device):
        cuda_build.check(lib.sos_passI(
            dt, mm, int(ops.lamb), _ptr(pack), _ptr(tiles), _ptr(cpar),
            _ptr(ops.colc), _ptr(ops.astk[0]), _ptr(ops.astk[1]), w_tc, kp,
            _ptr(fdn), _ptr(fup), L, C, ops.mp, ops.nb_angles, stream), "sos_passI")
    passI.launches += 1
    passI.tc_launches += tc
    return fdn, fup


def passA(pack, fdn, fup, ops: StreamOps, ab=frozenset(), ablate_build: bool = False):
    """Jₙ source product + downward recurrence → (sdn, jnup).  Replaces
    sos_rt_tpu/ops/megastream.py::_passA_kernel.  Bound by the operations
    of the (4Mp, 2Mp) source product; a tiled product (on the tensor cores
    in float32 'bf16x3' / 'bf16x5', FMAs otherwise) mixes the species in its
    epilogue, then one thread per (column, angle) walks the layers.

    ``ab`` (PASS_A_FLAGS, the kernel's ``ab``: 'nosrc', 'noloops'; results
    are wrong) launches the ablated build ``sos_passA_ablate``
    (csrc/megastream_ablate.cu, one flag at a time), counted in
    ``passA.ablate_launches`` and not in ``launches``; ``ablate_build=True``
    takes that build with no flag too (it must equal sos_passA to the bit)."""
    ab = _pass_flags(ab, PASS_A_FLAGS, "passA")
    if not fdn.is_cuda:
        return passA_plain(pack, fdn, fup, ops, ab)
    dt, mm, stream = _kernel_codes(ops, pack, fdn, fup)
    L, C, Mp = fdn.shape
    sdn = torch.empty_like(fdn)
    jnup = torch.empty_like(fdn)
    tc, w_tc, kp = _tc_args(ops, ops.ws_tc)
    ablated = bool(ab) or ablate_build
    if ablated:
        mask = _pass_mask(ab, "passA")
        launch = cuda_build.library("megastream_ablate").sos_passA_ablate
        args, name = (mask,), "sos_passA_ablate"
    else:
        launch, args, name = cuda_build.library("megastream").sos_passA, (), "sos_passA"
    with torch.cuda.device(pack.device):
        cuda_build.check(launch(
            *args, dt, mm, _ptr(pack), _ptr(fdn), _ptr(fup), _ptr(ops.colc),
            _ptr(ops.ws[0]), _ptr(ops.ws[1]), w_tc, kp, _ptr(sdn), _ptr(jnup),
            L, C, Mp, stream), name)
    if ablated:
        passA.ablate_launches += 1
    else:
        passA.launches += 1
        passA.tc_launches += tc
    return sdn, jnup


def passB(pack, sdn, jnup, cpar, ops: StreamOps, ab=frozenset(),
          ablate_build: bool = False):
    """BC, band fix, upward recurrence, corrections, smoothing → (fdn,
    fup).  Replaces sos_rt_tpu/ops/megastream.py::_passB_kernel.  Bound by
    bytes (four field planes).  Three kernels split it by what depends on
    the layer below (csrc/pass_b_split.cuh): the band fix of every (layer,
    column) row (``sos_passB_band``), the upward walk, one block per column
    with threads over angles, which smooths only the join rows
    (``sos_passB_walk``), and the smoothing of every row of fup in place
    (``sos_passB_smooth``).  One launch of passB counts one.

    ``ab`` (PASS_B_FLAGS, the kernel's ``ab``: 'nopoly', 'noloops', 'nofin',
    'nosmooth'; results are wrong) launches the ablated build
    ``sos_passB_ablate`` (csrc/megastream_ablate.cu, one flag at a time: the
    same stages with the flag's work cut out, no smoothing stage under
    'nofin' and 'nosmooth'), counted in ``passB.ablate_launches`` and not in
    ``launches``; ``ablate_build=True`` takes that build with no flag too
    (it must equal the three stages to the bit)."""
    ab = _pass_flags(ab, PASS_B_FLAGS, "passB")
    if not sdn.is_cuda:
        return passB_plain(pack, sdn, jnup, cpar, ops, ab)
    dt, mm, stream = _kernel_codes(ops, pack, sdn, jnup, cpar)
    L, C, Mp = sdn.shape
    mr = ops.nb_angles
    fdn = torch.empty_like(sdn)
    fup = torch.empty_like(sdn)
    cols, t_hi, t_lo = ops.taps
    if ab or ablate_build:
        mask = _pass_mask(ab, "passB")
        lib = cuda_build.library("megastream_ablate")
        with torch.cuda.device(pack.device):
            cuda_build.check(lib.sos_passB_ablate(
                mask, dt, mm, _ptr(pack), _ptr(sdn), _ptr(jnup), _ptr(cpar),
                _ptr(ops.colc), _ptr(cols), _ptr(t_hi), _ptr(t_lo), _ptr(ops.pvt),
                _ptr(ops.bct[0]), _ptr(ops.bct[1]), _ptr(fdn), _ptr(fup), L, C, Mp, mr,
                ops.slot, stream), "sos_passB_ablate")
        passB.ablate_launches += 1
        return fdn, fup
    lib = cuda_build.library("megastream")
    with torch.cuda.device(pack.device):
        cuda_build.check(lib.sos_passB_band(
            dt, mm, _ptr(pack), _ptr(sdn), _ptr(ops.colc), _ptr(cols), _ptr(t_hi),
            _ptr(t_lo), _ptr(ops.pvt), _ptr(fdn), L, C, Mp, mr, ops.slot, stream),
            "sos_passB_band")
        cuda_build.check(lib.sos_passB_walk(
            dt, mm, _ptr(pack), _ptr(jnup), _ptr(cpar), _ptr(ops.colc),
            _ptr(ops.bct[0]), _ptr(ops.bct[1]), _ptr(fdn), _ptr(fup), L, C, Mp, mr,
            stream), "sos_passB_walk")
        cuda_build.check(lib.sos_passB_smooth(dt, _ptr(fup), _ptr(ops.colc), L, C, Mp, mr,
                                              stream), "sos_passB_smooth")
    passB.launches += 1
    return fdn, fup


passI.launches = passA.launches = passB.launches = 0
# launches whose product ran on the tensor cores (csrc/quad_mma.cuh)
passI.tc_launches = passA.tc_launches = 0
# launches of the ablated builds (csrc/megastream_ablate.cu)
passA.ablate_launches = passB.ablate_launches = 0
KERNELS = (passI, passA, passB)              # the streamed loop's kernels
TC_KERNELS = (passI, passA)                  # those with a tensor-core mainloop
ABLATE_KERNELS = (passA, passB)              # those with an ablated build
# every wrapper of a TPU kernel's port
ALL_KERNELS = KERNELS + (mega_call,) + fused_sweeps.KERNELS + micro.KERNELS
# and of the port's own kernel, which ports no TPU kernel (the split-mode
# source, ops/fused_source.py): every wrapper that counts its launches
COUNTED_KERNELS = ALL_KERNELS + fused_source.KERNELS


def reset_launches() -> None:
    for k in COUNTED_KERNELS:
        k.launches = 0
    for k in TC_KERNELS + (mega_call,):
        k.tc_launches = 0
    for k in ABLATE_KERNELS:
        k.ablate_launches = 0
    mega_call.i1in_launches = 0
    solve_block.compactions = solve_block.column_orders = 0


# --------------------------------------------------------------------------
# The order loop
# --------------------------------------------------------------------------

# The streamed loop gathers the block's running columns into narrower planes
# once at least 1/COMPACT_SHARE of the planes' width has stopped running
# since the last gather (at least one column): a few gathers a block.
COMPACT_SHARE = 8


def _loop_on(ratio, n, tol: float, max_orders: int, ab: frozenset):
    """The order loop's condition and the block's running columns, read
    with one host sync: any column's ratio ≥ tol and no column at
    max_orders; under 'noconv' the second alone, under 'sccond' column 0's
    count alone.  'sccond' without 'noconv' raises once column 0 has
    converged short of max_orders: its count stops there, so that loop
    would never end (the TPU engine's does not).  Returns (go, running):
    running lists, per block column, whether its ratio is still ≥ tol;
    None under 'noconv', where every column counts every order.  Each read
    runs in the span ``sos.loop_cond``."""
    with span(LOOP_COND):
        if "sccond" in ab:
            head = [n[0] < max_orders, ratio[0] < tol]
        elif "noconv" in ab:
            head = [n.max() < max_orders]
        else:
            head = [(ratio >= tol).any() & (n.max() < max_orders)]
        parts = [torch.stack(head)] + ([] if "noconv" in ab else [ratio >= tol])
        flags = torch.cat(parts).tolist()
        go = flags[0]
        if "sccond" in ab and go and flags[1] and "noconv" not in ab:
            raise RuntimeError("ablate 'sccond': column 0 converged before max_orders, "
                               "so the loop would never end; add 'noconv'")
        return go, (None if "noconv" in ab else flags[len(head):])


def _index(ix: list, device: torch.device) -> torch.Tensor:
    """Host indices as an int64 tensor on ``device``; to a card through
    pinned memory, so the copy adds no host sync."""
    t = torch.tensor(ix, dtype=torch.int64)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def solve_block(pack, cpar, tiles, ops: StreamOps, *, tol: float,
                max_orders: int, full: bool, i1dn=None, i1up=None,
                ab=frozenset()):
    """The streamed order loop for one block of C columns.

    pack (PK_W, L, C), cpar (CP_W, C), tiles (NI, C, Mp).  The fields start
    from passI's first order, or from the host's I₁ planes ``i1dn`` /
    ``i1up`` (L, C, Mp) where they are given (no passI).  The loop runs
    while any column's ratio is ≥ tol and no column has reached
    max_orders; each column accumulates only while it is active, so its
    result does not depend on the other columns of the block.  One host
    sync per order reads the loop condition and which columns still run;
    passI runs in the span ``sos.first_order`` and each order in the span
    ``sos.order``.

    Active-column compaction: once at least 1/COMPACT_SHARE of the planes'
    columns has stopped running (ratio < tol), the order gathers the
    running ones into narrower planes (``fdn``, ``fup``, the ``pack`` rows,
    ``cpar``; span ``sos.order.compact``), so passA and passB run only on
    them.  Per-column state (the four boundary rows, the ``full`` planes,
    ratio, order count) keeps the block's width and is updated through the
    planes' block columns ``idx``; a column leaves the planes only after it
    has stopped accumulating, and every step is per column, so results do
    not depend on the gathers.  ``solve_block.compactions`` counts the
    gathers and ``solve_block.column_orders`` the planes' width summed over
    orders (Σ(n − 1) of the block's columns where each gather is exact).

    Returns (toa_dn, toa_up, srf_dn, srf_up (C, Mp), stats (3, C)), or with
    ``full`` (itot_dn, itot_up (L, C, Mp), stats), in the block's column
    order.  ``ab`` (STREAM_ABLATE_FLAGS) cuts stages out, as the TPU
    engine's loop does; results are wrong.  Under 'noconv' every column
    counts every order, so none leaves the planes."""
    if i1dn is None:
        with span(FIRST_ORDER):
            fdn, fup = passI(pack, tiles, cpar, ops)
    else:
        fdn, fup = i1dn, i1up
    L, C, Mp = fdn.shape
    dtype, dev = fdn.dtype, fdn.device
    real = torch.arange(Mp, device=dev) < ops.nb_angles
    # the boundary rows: TOA down, TOA up, surface down, surface up (4, C, Mp)
    edge = torch.stack([fdn[0], fup[0], fdn[L - 1], fup[L - 1]])
    acc = (fdn.clone(), fup.clone()) if full else None
    ratio = torch.full((C,), 2.0 * tol, dtype=dtype, device=dev)
    n = torch.ones((C,), dtype=dtype, device=dev)
    cols = list(range(C))                # the planes' block columns, on the host
    idx = torch.arange(C, device=dev)    # and on the device
    ab = frozenset(ab)
    ab_a, ab_b = ab & set(PASS_A_FLAGS), ab & set(PASS_B_FLAGS)
    while True:
        go, running = _loop_on(ratio, n, tol, max_orders, ab)
        if not go:
            break
        with span(ORDER):
            if running is not None:
                keep = [j for j, c in enumerate(cols) if running[c]]
                if len(cols) - len(keep) >= max(1, len(cols) // COMPACT_SHARE):
                    with span(ORDER_COMPACT):
                        sel = _index(keep, dev)
                        fdn, fup = fdn.index_select(1, sel), fup.index_select(1, sel)
                        pack, cpar = pack.index_select(2, sel), cpar.index_select(1, sel)
                        idx = idx.index_select(0, sel)
                        cols = [cols[j] for j in keep]
                    solve_block.compactions += 1
            solve_block.column_orders += len(cols)
            ratio_c = ratio.index_select(0, idx)
            active = (ratio_c >= tol).to(dtype)
            if "nopassA" in ab:
                sdn, jnup = fdn, fup
            else:
                sdn, jnup = passA(pack, fdn, fup, ops, ab_a)
            if "nopassB" in ab:
                fdn, fup = sdn, jnup
            else:
                fdn, fup = passB(pack, sdn, jnup, cpar, ops, ab_b)
            del sdn, jnup       # free two planes before the next passA allocates
            a2 = active[:, None]
            edge_c = edge.index_select(1, idx)
            if "notiles" not in ab:
                edge_c = edge_c + a2 * torch.stack([fdn[0], fup[0], fdn[L - 1], fup[L - 1]])
                edge.index_copy_(1, idx, edge_c)
            if full:
                for a, f in zip(acc, (fdn, fup)):
                    a.index_copy_(1, idx, a.index_select(1, idx).add_(a2 * f))
            if "noratio" not in ab:
                rnew = ratio_rows_tile(fup[0], edge_c[1], fdn[L - 1], edge_c[2], real)
                ratio.index_copy_(0, idx, torch.where(active > 0.5, rnew, ratio_c))
            if "noconv" in ab:
                n = n + 1.0
            else:
                n.index_add_(0, idx, active)
    stats = torch.empty((3, C), dtype=dtype, device=dev)
    stats[ST_N], stats[ST_CONV], stats[ST_RATIO] = n, (ratio < tol).to(dtype), ratio
    if full:
        return acc[0], acc[1], stats
    return edge[0], edge[1], edge[2], edge[3], stats


solve_block.compactions = 0      # gathers of the running columns
solve_block.column_orders = 0    # Σ over orders of the planes' width


def block_of(pack, cpar, tiles, i: int, cols_per_block: int):
    """(pack, cpar, tiles) of column block ``i``, contiguous."""
    sl = slice(i * cols_per_block, (i + 1) * cols_per_block)
    return (pack[:, :, sl].contiguous(), cpar[:, sl].contiguous(),
            tiles[:, sl].contiguous())


def i1_block_of(i1dn, i1up, i: int, cols_per_block: int) -> dict:
    """{'i1dn', 'i1up'}: the host I₁ planes (L, Bp, Mp) of column block
    ``i``, contiguous; {} without planes."""
    if i1dn is None:
        return {}
    sl = slice(i * cols_per_block, (i + 1) * cols_per_block)
    return dict(i1dn=i1dn[:, sl].contiguous(), i1up=i1up[:, sl].contiguous())


def stream_order_loop(pack, cpar, tiles, ops: StreamOps, *, tol: float,
                      max_orders: int, cols_per_block: int,
                      outputs: str = "summary", i1dn=None, i1up=None,
                      ablate: str = ""):
    """Run the streamed order loop over the batch, one block of
    ``cols_per_block`` columns after another.  ``ablate``
    (STREAM_ABLATE_FLAGS, comma-separated) cuts stages out of every block's
    loop (:func:`solve_block`); results are wrong.

    pack (PK_W, L, Bp), cpar (CP_W, Bp), tiles (NI, Bp, Mp) with Bp a
    multiple of the block size; ``i1dn`` / ``i1up`` (L, Bp, Mp), where
    given, are the host's first order that each block starts from in place
    of passI (:func:`solve_block`).  Returns summary → (toa_dn, toa_up,
    srf_dn, srf_up (Bp, Mp), stats (3, Bp)); full → (itot_dn, itot_up
    (Bp, L, Mp), stats)."""
    C = cols_per_block
    Bp = cpar.shape[1]
    if Bp % C:
        raise ValueError(f"batch {Bp} is not a multiple of the block size {C}")
    full = outputs == "full"
    ab = stream_ablate_flags(ablate)
    outs = []
    for i in range(Bp // C):
        res = solve_block(*block_of(pack, cpar, tiles, i, C), ops, tol=tol,
                          max_orders=max_orders, full=full, ab=ab,
                          **i1_block_of(i1dn, i1up, i, C))
        if full:
            res = (res[0].transpose(0, 1), res[1].transpose(0, 1), res[2])
        outs.append(res)
    batch_axis = lambda k: 1 if k == len(outs[0]) - 1 else 0
    return tuple(torch.cat([o[k] for o in outs], dim=batch_axis(k))
                 for k in range(len(outs[0])))
