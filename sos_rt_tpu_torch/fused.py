"""Batched whole-solve entry points: the mega engine and the fused engine.

Counterpart of ``sos_rt_tpu/fused.py``: :class:`SweepSummary`,
:func:`solve_batch_mega` (the streamed execution and the resident one,
each with I₁ evaluated in its kernels or given from the host),
:func:`predict_order_count` and :func:`solve_batch_fused`.

The mega engine's host preparation (τ profiles, mixing weights, pack rows,
the in-kernel I₁ inputs, the static and stacked operators) follows the TPU
package step for step.  Its order loop then runs either streamed
(``ops/megastream.py``: two kernel launches per order and block, the loop
on the host) or resident (``ops/megakernel.py::mega_call``: one launch for
the whole batch, the loop on the device); :func:`resolve_stream` picks.

The fused engine keeps the radiance field as (down, up) halves of
(B, L, M), runs the wide per-order work in the two sweep kernels of
``ops/fused_sweeps.py`` and the narrow small-µ and polyfit-band fixes (a
handful of columns) in plain torch between them.  Its Jₙ source is, in
float32 'bf16x3' / 'bf16x5', one tensor-core kernel an order
(``ops/fused_source.py``), otherwise four plain matrix products.  It takes
every grid, and it is where :func:`solve_batch_mega` sends a whole batch
whose grid fails ``mega_supported`` (small-µ columns that a column's
polyfit band does not cover), as the TPU package does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sos_rt_tpu_torch.config import (SCENE_FIELDS, GridSpec, Scene, SolverOptions,
                                     full_precision_matmul, resolve_device,
                                     torch_dtype)
from sos_rt_tpu_torch.grids import layer_indices, neighbour_index, tau_profile
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.ops.first_order import first_order, first_order_mega_inputs
from sos_rt_tpu_torch.ops.fused_source import (SPLIT_MODES, fused_source, mix_source,
                                               source_columns, source_copy)
from sos_rt_tpu_torch.ops.fused_sweeps import build_pack, down_sweep, up_sweep_smooth
from sos_rt_tpu_torch.ops.source import source_operator
from sos_rt_tpu_torch.ops.sweeps import (DownFix, device_stencils, region_band_choices,
                                         stencils_for)
from sos_rt_tpu_torch.solver import PhaseTables, Solution
from sos_rt_tpu_torch.spans import (DOWN_SWEEP, LOOP_COND, MEGA_PREDICT, MEGA_PREPARE,
                                    MEGA_SOLVE, MEGA_SORT, ORDER, SOURCE_JN, UP_SWEEP_BC,
                                    span)


@dataclasses.dataclass(frozen=True)
class SweepSummary:
    """Reduced sweep solution: only the rows every sweep reduction reads
    (TOA up-flux, surface down-flux, forcing, critical albedo)."""

    i_toa: Any          # (B, 2M) total radiance row at τ=0
    i_surface: Any      # (B, 2M) total radiance row at τ*
    n_orders: Any       # (B,)
    converged: Any      # (B,) bool
    tau: Any            # (B, L)
    idx_up: Any
    idx_down: Any


def to_summary(sol: Solution) -> SweepSummary:
    """Reduce a full Solution to the summary rows."""
    return SweepSummary(i_toa=sol.i_total[:, 0, :], i_surface=sol.i_total[:, -1, :],
                        n_orders=sol.n_orders, converged=sol.converged,
                        tau=sol.tau, idx_up=sol.idx_up, idx_down=sol.idx_down)


PREDICT_MIN_BATCH = 4096      # below this the predictor solve isn't worth it
PREDICT_ANGLES = 8            # coarse predictor grid (µ nodes per half)
PREDICT_LAYERS = 16
PLANE_BUDGET = 256 * 2 ** 20  # bytes of one half-field plane per block
MAX_COLS_PER_BLOCK = 1024
# stream=None runs the resident kernel when one column's four working
# planes (fdn, fup, sdn, jn_up) take at most this many bytes: the 64×128
# sweep grid (128 KiB in float32, 256 KiB in float64) does, the 501×800
# grid (6.4 MB) stays streamed
RESIDENT_COLUMN_BUDGET = 256 * 2 ** 10
SCORE_GAP = 1024.0            # predict-sort key = count · gap + min(score, cap)
SCORE_CAP = SCORE_GAP - 1.0


def scene_on(scenes: Scene, device) -> Scene:
    """Scene fields as float64 tensors of one batch shape on ``device``."""
    t = scenes.map(lambda x: torch.as_tensor(x, dtype=torch.float64, device=device))
    shape = torch.broadcast_shapes(*(getattr(t, f).shape for f in SCENE_FIELDS))
    if len(shape) != 1:
        raise ValueError(f"scene fields must share one batch axis; got {shape}")
    return t.map(lambda x: x.expand(shape).contiguous())


def tables_on(tables: PhaseTables, device) -> PhaseTables:
    return PhaseTables(*(torch.as_tensor(getattr(tables, f.name), device=device)
                         for f in dataclasses.fields(PhaseTables)))


def take_columns(x, idx):
    """Columns ``idx`` of a SweepSummary / Solution / Scene."""
    if isinstance(x, Scene):
        return x.map(lambda v: v[idx])
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name)[idx] for f in dataclasses.fields(x)
        if getattr(x, f.name) is not None})


def default_cols_per_block(nb_layers: int, mp: int, dtype: torch.dtype) -> int:
    """Largest power of two of columns whose (L, C, Mp) plane fits
    PLANE_BUDGET, capped at MAX_COLS_PER_BLOCK (128 at the 501×800 grid
    in float32, 1024 at 64×128)."""
    per_col = nb_layers * mp * torch.finfo(dtype).bits // 8
    fit = max(1, min(MAX_COLS_PER_BLOCK, PLANE_BUDGET // per_col))
    return 1 << (fit.bit_length() - 1)


def predict_order_count(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                        opts: SolverOptions, min_batch: int | None = None,
                        device=None):
    """Per-column scattering-order prediction by a coarse-grid solve.

    Solves the same physics on the 8×16 grid whose tables are subsampled
    from the caller's (uniform grids; nearest nodes when (M-1) is not a
    multiple of 7), with the same kernels.  Returns the (B,) coarse order
    counts, or None when prediction does not apply: batches below
    ``min_batch`` (default 4096), non-uniform grids, M ≤ 8, and float64
    on a card (a verification dtype, not worth a predictor)."""
    device = resolve_device(device)
    B = torch.as_tensor(scenes.mu0).reshape(-1).shape[0]
    if min_batch is None:
        min_batch = PREDICT_MIN_BATCH
    if (B < min_batch or grid.spacing != "uniform" or grid.nb_angles <= PREDICT_ANGLES
            or (opts.dtype == "float64" and device.type == "cuda")):
        return None
    with span(MEGA_PREDICT):
        cg, ct = coarse_problem(tables, grid, device)
        # stream=None: the 8×16 grid takes the resident kernel (one launch
        # instead of two per order and block; measured 5× faster, PERF.md §6)
        sol = solve_batch_mega(scenes, ct, cg, opts, outputs="summary", sort=False,
                               device=device)
        return sol.n_orders


def resolve_stream(stream: bool | None, grid: GridSpec, dtype: torch.dtype) -> bool:
    """Whether the order loop runs streamed.  ``None`` resolves to the
    resident kernel exactly when one column's four working planes fit
    RESIDENT_COLUMN_BUDGET and the kernel's thread shapes cover the grid;
    the caller's ``True``/``False`` stands."""
    if stream is not None:
        return bool(stream)
    mp = mk.pad_angles(grid.nb_angles)
    column = 4 * grid.nb_layers * mp * torch.finfo(dtype).bits // 8
    return column > RESIDENT_COLUMN_BUDGET or mp > mk.MAX_RESIDENT_MP


def layer_reaches_ground(scenes: Scene, grid: GridSpec) -> bool:
    """True when some column's aerosol layer ends in the bottom layer
    (idx_down = L − 1).  The reference engine then joins the layers at
    the bottom layer itself (its idx_down + 1 clamps to L − 1) and smooths
    that row twice, once at the join and once with every row; the mega
    kernels' up walk smooths each row once, so such a batch goes to the
    fused engine, whose up sweep smooths as the reference does."""
    _, idx_down = layer_indices(scenes.z0, scenes.z_up, scenes.z_down, grid.nb_layers)
    return bool((idx_down == grid.nb_layers - 1).any())


def goes_to_fused(scenes: Scene, grid: GridSpec, allow_small: bool) -> bool:
    """The whole-batch handover of :func:`solve_batch_mega` to the fused
    engine: the grid needs the small-µ machinery (``mega_supported`` false
    without the ``allow_small`` grant), or some column's aerosol layer
    reaches the bottom layer (:func:`layer_reaches_ground`)."""
    return (not mk.mega_supported(grid, stencils_for(grid), allow_small=allow_small)
            or layer_reaches_ground(scenes, grid))


def coarse_problem(tables: PhaseTables, grid: GridSpec, device):
    """The predictor's 8×16 grid and the caller's tables subsampled to it
    (every (M-1)/7-th node, or the nearest nodes when 7 does not divide
    M-1)."""
    m, mc = grid.nb_angles, PREDICT_ANGLES
    if (m - 1) % (mc - 1) == 0:
        idx = np.arange(0, m, (m - 1) // (mc - 1))
    else:
        idx = np.round(np.linspace(0, m - 1, mc)).astype(np.int64)
    full_idx = torch.as_tensor(np.concatenate([idx, m + idx]), device=device)
    tables = tables_on(tables, device)
    sub = lambda p: p[full_idx][:, full_idx]
    ct = PhaseTables(p0_atm=tables.p0_atm[..., full_idx], p_atm=sub(tables.p_atm),
                     p0_aer=tables.p0_aer[..., full_idx], p_aer=sub(tables.p_aer))
    return GridSpec(nb_angles=mc, nb_layers=PREDICT_LAYERS), ct


@dataclasses.dataclass(frozen=True)
class MegaBatch:
    """A prepared batch for the order loop, streamed or resident (the
    port's layout): pack (PK_W, L, Bp), cpar (CP_W, Bp), tiles (NI, Bp,
    Mp), the per-solve operators, and the τ profile; Bp pads the batch to
    a multiple of the block size by repeating the last column.  With the
    first order from the host (``i1='host'``), ``i1`` is its (Bp, L, 2M)
    field and ``i1dn`` / ``i1up`` its halves as (L, Bp, Mp) planes, the
    tiles are empty (NI = 0) and the pack's and cpar's I₁ rows are 0."""

    pack: Any
    cpar: Any
    tiles: Any
    ops: ms.StreamOps
    cols_per_block: int
    batch: int
    tau: Any
    idx_up: Any
    idx_down: Any
    i1: Any = None
    i1dn: Any = None
    i1up: Any = None

    def block(self, i: int):
        """(pack, cpar, tiles) of block ``i``, contiguous."""
        return ms.block_of(self.pack, self.cpar, self.tiles, i, self.cols_per_block)

    def i1_planes(self):
        """{'i1dn', 'i1up'}: the host I₁ planes, as the order loops take
        them; {} without them."""
        return {} if self.i1dn is None else dict(i1dn=self.i1dn, i1up=self.i1up)


def host_i1_planes(i1, nb_angles: int, mp: int):
    """The halves of I₁ (B, L, 2M) as the order loop's (L, B, Mp) planes,
    angle-padded with zeros."""
    pad = lambda h: torch.nn.functional.pad(h, (0, mp - nb_angles))
    return tuple(pad(h).transpose(0, 1).contiguous()
                 for h in (i1[..., :nb_angles], i1[..., nb_angles:]))


@span(MEGA_PREPARE)
def prepare_batch(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                  opts: SolverOptions, mm: str | None = None,
                  cols_per_block: int | None = None, device=None,
                  i1: str = "kernel") -> MegaBatch:
    """Host preparation of the mega solve (fused.py:230-450 of the TPU
    package): dtype and mm resolution, batch padding, τ profiles, mixing
    weights, pack rows, the in-kernel I₁ inputs (``i1='kernel'``) or the
    host's I₁ field (``i1='host'``, :func:`~sos_rt_tpu_torch.ops.
    first_order.first_order`) and the operators.  ``cols_per_block``
    defaults to the streamed loop's block size.  ``scenes``/``tables``
    must already be on ``device``."""
    if i1 not in ("kernel", "host"):
        raise ValueError(f"unknown i1 mode {i1!r}; 'kernel' or 'host'")
    full_precision_matmul()
    stencils = stencils_for(grid)
    dtype = torch_dtype(opts.dtype)
    if mm is None:                      # explicit arg wins over opts.mm
        mm = opts.mm if dtype == torch.float32 else None
    if mm is None:
        mm = "bf16x3" if dtype == torch.float32 else "highest"
    if dtype == torch.float64 and mm != "highest":
        raise ValueError("float64 runs mm='highest' only")
    L, M = grid.nb_layers, grid.nb_angles
    MP = mk.pad_angles(M)
    mu = torch.as_tensor(grid.mu(), dtype=dtype, device=device)
    w_mu_np = np.asarray(grid.trapz_weights(), np.float64)
    w_mu = torch.as_tensor(w_mu_np, dtype=dtype, device=device)
    B = scenes.mu0.shape[0]
    C = cols_per_block or default_cols_per_block(L, MP, dtype)
    C = min(C, B)
    pad = (-B) % C
    if pad:   # repeat the last column; its results are trimmed below
        last = torch.full((pad,), B - 1, device=device)
        idx = torch.cat([torch.arange(B, device=device), last])
        scenes = take_columns(scenes, idx)
        tables = tables.take(idx)
    Bp = B + pad

    cast = lambda x: x.to(dtype)
    tau, idx_up, idx_down = tau_profile(
        cast(scenes.tau_star_atm), cast(scenes.tau_star_aer), cast(scenes.z0),
        cast(scenes.z_up), cast(scenes.z_down), L)
    tau = tau.to(dtype)
    dtau_aer = scenes.tau_star_aer / (idx_down + 1 - idx_up)
    dtau_atm = scenes.tau_star_atm / L
    w_atm = (dtau_atm / (dtau_atm + dtau_aer)).to(dtype)
    w_aer = (dtau_aer / (dtau_atm + dtau_aer)).to(dtype)

    host_i1 = i1dn = i1up = None
    if i1 == "kernel":
        i1_pack, i1_tiles, colc_pk, i1_const, astack = first_order_mega_inputs(
            opts.surface, tau, mu, M, scenes.mu0, scenes.grd_alb,
            scenes.alb_atm, scenes.alb_aer, tables.p0_atm, tables.p_atm,
            tables.p0_aer, tables.p_aer, idx_up, idx_down, w_atm, w_aer,
            w_mu, dtype)
    else:
        host_i1 = first_order(
            opts.surface, tau, mu, M, cast(scenes.mu0), cast(scenes.grd_alb),
            cast(scenes.alb_atm), cast(scenes.alb_aer), tables.p0_atm, tables.p_atm,
            tables.p0_aer, tables.p_aer, idx_up, idx_down, w_atm, w_aer,
            w_mu).to(dtype)
        i1dn, i1up = host_i1_planes(host_i1, M, MP)
        zl = torch.zeros((L, Bp), dtype=dtype, device=device)
        i1_pack = {k: zl for k in mk.I1_PACK_KEYS}
        i1_tiles = torch.zeros((0, MP, Bp), dtype=dtype, device=device)
        colc_pk = torch.zeros((2, MP), dtype=dtype, device=device)
        i1_const = torch.zeros((Bp,), dtype=dtype, device=device)
        astack = None

    # ---- pack rows (PK_W, L, Bp) ----
    t_idx = torch.arange(L, device=device)[:, None]
    iu = idx_up[None, :]
    idn = idx_down[None, :]
    tau_t = tau.T                                           # (L, Bp)
    drop = ((t_idx == idn) | (t_idx == iu - 1) | (t_idx == L - 1)).to(dtype)
    ch2 = (t_idx < iu).to(dtype)
    r1 = (t_idx == neighbour_index(idn + 1, L)).to(dtype)     # as build_pack's
    r2 = (t_idx == iu).to(dtype)
    dt = tau_t[1:] - tau_t[:-1]
    zrow = torch.zeros((1, Bp), dtype=dtype, device=device)
    hdt_dn = torch.cat([zrow, 0.5 * dt])
    hdt_up = torch.cat([0.5 * dt, zrow])
    in_layer = (t_idx >= iu) & (t_idx <= idn)
    alb_atm = cast(scenes.alb_atm)[None, :]
    alb_aer = cast(scenes.alb_aer)[None, :]
    coef_atm = torch.where(in_layer, w_atm[None, :] * alb_atm / 4.0, alb_atm / 4.0)
    coef_aer = torch.where(in_layer, w_aer[None, :] * alb_aer / 4.0, 0.0)
    choice_a, choice_bc = (c.to(dtype) for c in region_band_choices(tau, idx_up, idx_down))
    # localized affine-scan sources: down c_t = (hdt_dn+hdt_up)_t·jₙ_t;
    # up c_t = (d_t·hdt_up_t + gs_t)·ivup·jₙ_t, gs_t = d_{t-1}·hdt_up_{t-1}
    cdn = hdt_dn + hdt_up
    dw = (1.0 - drop) * hdt_up
    gs = torch.cat([zrow, dw[:-1]])
    cup = dw + gs
    # polyfit-band choice per (layer, column): variant A above the
    # aerosol layer, variant B/C below
    choice_res = torch.where(ch2 > 0.5, choice_a[None, :], choice_bc[None, :])
    rows = [tau_t, hdt_dn, hdt_up, coef_atm, coef_aer, cdn, cup, gs, r1, r2,
            choice_res] + [i1_pack[k] for k in mk.I1_PACK_KEYS]
    rows += [torch.zeros((L, Bp), dtype=dtype, device=device)] * (mk.PK_W - len(rows))
    pack = torch.stack(rows)

    zb = torch.zeros((Bp,), dtype=dtype, device=device)
    cpar = torch.stack([cast(scenes.grd_alb), i1_const.to(dtype)]
                       + [zb] * (mk.CP_W - 2))

    a_atm = source_operator(tables.p_atm.to(dtype), w_mu)
    a_aer = source_operator(tables.p_aer.to(dtype), w_mu)
    ws = mk.stack_source_operator(a_atm, a_aer, M, mm, dtype)
    if MP != M and i1 == "kernel":      # angle-pad the in-kernel I₁ inputs
        i1_tiles = torch.nn.functional.pad(i1_tiles, (0, 0, 0, MP - M))
        colc_pk = torch.nn.functional.pad(colc_pk, (0, MP - M))
        if astack is not None:
            astack = mk._pad_blocks(astack, M, MP, 4, 1)
    astk = None
    if astack is not None:
        astk = mk._split_op(astack, mm, dtype, device)
    sops = ms.StreamOps.build(grid, stencils, opts.surface, w_mu_np, ws, astk,
                              colc_pk, mm=mm, dtype=dtype, device=device)
    return MegaBatch(pack=pack, cpar=cpar,
                     tiles=i1_tiles.transpose(1, 2).contiguous(), ops=sops,
                     cols_per_block=C, batch=B, tau=tau, idx_up=idx_up,
                     idx_down=idx_down, i1=host_i1, i1dn=i1dn, i1up=i1up)


def sort_key(scenes: Scene, tables: PhaseTables, grid: GridSpec,
              opts: SolverOptions, sort, device):
    """The key columns are sorted by before blocking: for
    ``sort='predict'`` the coarse-grid order count first and the
    closed-form score second (the 1024 gap keeps the score term above
    float32 ulp at count-scale magnitudes, and the score is clamped below
    the gap so it never outranks a count); otherwise, or when prediction
    does not apply, the score alone."""
    from sos_rt_tpu_torch.parallel.mesh import order_count_score

    key = None
    if sort == "predict":
        key = predict_order_count(scenes, tables, grid, opts, device=device)
    if key is None:
        return order_count_score(scenes)
    score = torch.clamp(order_count_score(scenes), max=SCORE_CAP)
    return key.to(torch.float32) * SCORE_GAP + score


def solve_batch_mega(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                     opts: SolverOptions, cols_per_block: int | None = None,
                     sort=True, mm: str | None = None, outputs: str = "full",
                     i1: str = "kernel", allow_small: bool = False,
                     stream: bool | None = None, device=None, ablate: str = ""):
    """Whole-solve mega engine over (B,)-batched ``scenes``.

    ``stream`` selects the execution of the same arithmetic: ``True`` the
    streamed loop (ops/megastream.py: field planes in device memory, two
    launches per order and block, the loop on the host), ``False`` the
    resident kernel (ops/megakernel.py::mega_call: one launch, the loop on
    the device, a thread block per tile of columns), ``None`` (default)
    the resident kernel where :func:`resolve_stream` finds the grid small
    enough.  A grid that needs the small-µ machinery (``mega_supported``
    false: small-µ columns without the ``allow_small`` grant), or a batch
    with an aerosol layer in the bottom layer (:func:`layer_reaches_ground`),
    hands the whole batch to :func:`solve_batch_fused`, reduced to the
    summary rows where those were asked for.  Each block of ``cols_per_block`` columns (streamed; default by
    :func:`default_cols_per_block`) or tile (resident; default by
    megakernel.default_cols_per_tile) runs its own order loop; per-column
    results do not depend on the block size, the order of the columns or
    the execution.  ``sort`` pre-sorts columns by an order-count key so each
    block's columns converge together (``True``: the closed-form score;
    ``'predict'``: the coarse-grid pre-solve of
    :func:`predict_order_count`, the score when that does not apply);
    results come back in the caller's order.

    ``i1``: where the first order comes from.  'kernel' (default): the
    kernels evaluate it from compact per-column inputs
    (``first_order_mega_inputs``); with ``outputs='full'`` the Solution's
    ``i1`` is None.  'host': :func:`~sos_rt_tpu_torch.ops.first_order.
    first_order` builds the (B, L, 2M) field, which starts both executions
    in place of passI or of sos_mega's own first order (``sos_mega_i1in``),
    and ``outputs='full'`` returns it as ``Solution.i1``.  The fused engine,
    where a batch goes there, returns its own ``i1`` either way.

    ``mm``: 'bf16x3' (the float32 default), 'bf16x5' or 'highest'
    (float64 always runs 'highest').  ``allow_small`` asserts that every
    column's µ→0⁻ band covers the grid's small-µ columns
    (parallel.mesh.mega_small_ok).  ``outputs``: 'full' → Solution,
    'summary' → SweepSummary.  ``device`` defaults to CUDA.

    ``ablate`` (comma-separated flags; results are wrong) cuts stages out
    for timing attribution: on the resident execution those of
    megakernel.ABLATE_FLAGS (tools/ablate_kernel.py), on the streamed one
    those of megastream.STREAM_ABLATE_FLAGS (tools/ablate_stream.py); a flag
    the execution does not take raises ``ValueError`` (so do the resident
    kernel's 'noi1' and 'nobc' streamed).  A batch that goes to the fused
    engine raises ``ValueError`` with flags: that engine takes none (the
    JAX package drops them there without a word).
    """
    if outputs not in ("full", "summary"):
        raise ValueError(f"unknown outputs mode {outputs!r}")
    if i1 not in ("kernel", "host"):
        raise ValueError(f"unknown i1 mode {i1!r}; 'kernel' or 'host'")
    device = resolve_device(device)
    if resolve_stream(stream, grid, torch_dtype(opts.dtype)):
        ms.stream_ablate_flags(ablate)
    else:
        mk.ablate_flags(ablate)
    to_fused = goes_to_fused(scenes, grid, allow_small)
    if ablate and to_fused:
        raise ValueError("ablate flags act on the mega kernels; this batch goes to "
                         "the fused engine, which takes none")
    if to_fused:
        sol = solve_batch_fused(scenes, tables, grid, opts, device=device)
        return to_summary(sol) if outputs == "summary" else sol
    scenes = scene_on(scenes, device)
    tables = tables_on(tables, device)

    if sort:
        with span(MEGA_SORT):
            key = sort_key(scenes, tables, grid, opts, sort, device)
            perm = torch.argsort(key, stable=True)
            inv = torch.argsort(perm, stable=True)
        sol = solve_batch_mega(take_columns(scenes, perm), tables.take(perm),
                               grid, opts, cols_per_block=cols_per_block,
                               sort=False, mm=mm, outputs=outputs, i1=i1,
                               allow_small=allow_small, stream=stream,
                               device=device, ablate=ablate)
        return take_columns(sol, inv)

    stream = resolve_stream(stream, grid, torch_dtype(opts.dtype))
    if not stream and cols_per_block is None:
        cols_per_block = mk.default_cols_per_tile(mk.pad_angles(grid.nb_angles))
    sb = prepare_batch(scenes, tables, grid, opts, mm=mm,
                       cols_per_block=cols_per_block, device=device, i1=i1)
    i1_out = sb.i1[:sb.batch] if outputs == "full" and sb.i1 is not None else None
    planes = sb.i1_planes()
    # only the planes are read below: let a summary solve free the field
    sb = dataclasses.replace(sb, i1=None, i1dn=None, i1up=None)
    with span(MEGA_SOLVE):
        loop = dict(tol=float(opts.tol), max_orders=int(opts.max_orders))
        if stream:
            res = ms.stream_order_loop(sb.pack, sb.cpar, sb.tiles, sb.ops, **loop,
                                       cols_per_block=sb.cols_per_block,
                                       outputs=outputs, ablate=ablate, **planes)
        else:
            res = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, **loop,
                               full=outputs == "full",
                               cols_per_tile=sb.cols_per_block, ablate=ablate, **planes)
            if outputs == "full":       # (L, Bp, Mp) → (Bp, L, Mp)
                res = (res[0].transpose(0, 1), res[1].transpose(0, 1), res[2])

        stats = res[-1]
        B, M = sb.batch, grid.nb_angles
        common = dict(n_orders=stats[mk.ST_N].to(torch.int32)[:B],
                      converged=(stats[mk.ST_CONV] > 0.5)[:B], tau=sb.tau[:B],
                      idx_up=sb.idx_up[:B], idx_down=sb.idx_down[:B])
        if outputs == "summary":
            toa = torch.cat([res[0][:, :M], res[1][:, :M]], dim=1)[:B]
            srf = torch.cat([res[2][:, :M], res[3][:, :M]], dim=1)[:B]
            return SweepSummary(i_toa=toa, i_surface=srf, **common)
        i_total = torch.cat([res[0][..., :M], res[1][..., :M]], dim=2)[:B]
        return Solution(i_total=i_total, i1=i1_out, **common)


class FusedBatch:
    """The loop invariants of one fused solve and its order step.

    Built from (B,)-batched ``scenes`` and ``tables`` already on
    ``device``: τ profiles and mixing weights, the first order ``i1``
    (B, L, 2M), the four source operators, the kernels' ``pack`` /
    ``cparams`` / µ rows and the µ→0⁻ down-fix (``ops.sweeps.DownFix``).
    """

    def __init__(self, scenes: Scene, tables: PhaseTables, grid: GridSpec,
                 opts: SolverOptions, device):
        full_precision_matmul()
        dtype = torch_dtype(opts.dtype)
        L, M = grid.nb_layers, grid.nb_angles
        mu_np = np.asarray(grid.mu(), np.float64)
        on_dev = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
        cast = lambda x: x.to(dtype)
        mu = on_dev(mu_np)
        w_mu = on_dev(grid.trapz_weights())
        self.surface, self.dtype, self.device = opts.surface, dtype, device
        self.L, self.M, self.B = L, M, scenes.mu0.shape[0]

        # ---- per-column geometry ----
        tau, idx_up, idx_down = tau_profile(
            cast(scenes.tau_star_atm), cast(scenes.tau_star_aer), cast(scenes.z0),
            cast(scenes.z_up), cast(scenes.z_down), L)
        tau = tau.to(dtype).contiguous()
        dtau_aer = scenes.tau_star_aer / (idx_down + 1 - idx_up)
        dtau_atm = scenes.tau_star_atm / L
        w_atm = (dtau_atm / (dtau_atm + dtau_aer)).to(dtype)
        w_aer = (dtau_aer / (dtau_atm + dtau_aer)).to(dtype)
        self.tau, self.idx_up, self.idx_down = tau, idx_up, idx_down

        # P0 may be per column (one row per column's µ0); the P matrices
        # are shared
        self.i1 = first_order(
            opts.surface, tau, mu, M, cast(scenes.mu0), cast(scenes.grd_alb),
            cast(scenes.alb_atm), cast(scenes.alb_aer), tables.p0_atm, tables.p_atm,
            tables.p0_aer, tables.p_aer, idx_up, idx_down, w_atm, w_aer, w_mu)

        a_full_atm = source_operator(tables.p_atm.to(dtype), w_mu)
        a_full_aer = source_operator(tables.p_aer.to(dtype), w_mu)
        # matmul precision mode for the Jₙ products (the dominant operations
        # on canonical-width grids): the split modes read the operators'
        # bf16 copy (the kernel's on the card, the plain version's on the
        # CPU), the others the operators' four blocks
        mm = opts.mm if dtype == torch.float32 else None
        self.mm = mm if mm in SPLIT_MODES else None
        self.cols = source_columns(scenes.alb_atm, scenes.alb_aer, w_atm, w_aer, idx_up,
                                   idx_down, dtype)
        if self.mm is not None:
            self.wcopy = source_copy(a_full_atm, a_full_aer, M, self.mm)
        else:
            self.operators = (a_full_atm[:M], a_full_atm[M:], a_full_aer[:M],
                              a_full_aer[M:])

        # ---- loop invariants ----
        self.mu_down_safe = on_dev(np.where(mu_np[:M] == 0, -1.0, mu_np[:M]))
        self.mu_up_row = torch.cat([torch.zeros((1,), dtype=dtype, device=device),
                                    mu[M + 1:]])
        self.pack, self.cparams = build_pack(tau, idx_up, idx_down, dtype)
        self.down_fix = DownFix.build(device_stencils(grid, tau.device, dtype), tau,
                                      idx_up, idx_down, mu)

        self.mirror_bc = torch.arange(M - 2, -1, -1, device=device)   # cols M-2..0
        self.grd = cast(scenes.grd_alb)
        self.lamb_w = (w_mu[:M] * mu[:M])[None, :]

    def source(self, dn, up):
        """Jₙ (B, L, 2M) from the previous order's halves: in the split modes
        ``ops/fused_source.py::fused_source`` (one kernel launch on the card),
        otherwise four full-precision products and the mixing."""
        if self.mm is not None:
            return fused_source(dn, up, self.wcopy, self.cols, self.mm)
        a = self.operators
        return mix_source(dn @ a[0] + up @ a[1], dn @ a[2] + up @ a[3], self.cols)

    def narrow_down_fixes(self, raw, jn):
        """The small-µ columns (windowed value or Taylor limit), the zeroed
        µ=0⁻ column and the polyfit band, written into ``raw`` in place."""
        return self.down_fix.apply(raw, jn)

    def surface_bc(self, dn):
        """The upward sweep's boundary row (B, M) from the new I↓ at the
        surface (lane 0, the µ=0⁺ column, is unused)."""
        surf = dn[:, self.L - 1, :]
        if self.surface == "lambertian":
            f_down = -torch.sum(self.lamb_w * surf, dim=1)
            return (2.0 * self.grd * f_down)[:, None].expand(self.B, self.M).contiguous()
        bc = self.grd[:, None] * surf[:, self.mirror_bc]
        return torch.cat([torch.zeros((self.B, 1), dtype=self.dtype,
                                      device=self.device), bc], dim=1)

    def order_step(self, dn_prev, up_prev):
        """One scattering order: (I↓, I↑) of order n from those of n−1.
        The halves of Jₙ go to the kernels as views, with their strides.
        The stages run in the JAX engine's named scopes (spans
        ``sos.source_jn``, ``sos.down_sweep``, ``sos.up_sweep_bc``)."""
        M = self.M
        with span(SOURCE_JN):
            jn = self.source(dn_prev, up_prev)
        with span(DOWN_SWEEP):
            raw = down_sweep(jn[:, :, :M], self.pack, self.mu_down_safe)
            dn = self.narrow_down_fixes(raw, jn)
        with span(UP_SWEEP_BC):
            up = up_sweep_smooth(jn[:, :, M:], self.pack, self.cparams, self.mu_up_row,
                                 self.surface_bc(dn))
        return dn, up


def solve_batch_fused(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                      opts: SolverOptions, block_b: int = 32, device=None):
    """Batched SOS solve over (B,)-batched ``scenes`` with the fused engine.

    Per order (:meth:`FusedBatch.order_step`): the Jₙ source products
    (``opts.mm`` None or 'highest': full precision; 'bf16x3' / 'bf16x5' in
    float32: the source kernel of ops/fused_source.py), the downward sweep
    kernel, the narrow small-µ and polyfit-band fixes, the surface BC, and
    the upward sweep kernel with its smoothing.  The order loop runs on the
    host with one sync per order; a column accumulates only while its own
    ratio is above ``tol``.  Returns a :class:`Solution` with ``i1``.
    ``block_b`` is the TPU kernels' batch block and has no effect here: the
    kernels take any B and any L.  ``device`` defaults to CUDA.
    """
    device = resolve_device(device)
    fb = FusedBatch(scene_on(scenes, device), tables_on(tables, device), grid, opts,
                    device)
    L, M, dtype = fb.L, fb.M, fb.dtype
    tol = torch.tensor(opts.tol, dtype=dtype, device=device)

    def ratio_fn(dn_new, up_new, dn_tot, up_tot):
        # 0/0 → 0 (treated converged): degenerate scenes with zero radiance
        # at a TOA/surface angle must not poison the criterion
        div = lambda a, b: torch.where(b != 0, a / torch.where(b != 0, b, 1.0), 0.0)
        r_toa = div(up_new[:, 0, :], up_tot[:, 0, :]).amax(dim=1)
        r_srf = div(dn_new[:, L - 1, :], dn_tot[:, L - 1, :]).amax(dim=1)
        return torch.maximum(r_toa, r_srf)

    dn_prev, up_prev = fb.i1[:, :, :M], fb.i1[:, :, M:]
    dn_tot, up_tot = dn_prev.clone(), up_prev.clone()
    # explicit above-tol seed (the loop must take ≥ 1 step); max(1/I1) would
    # be inf/NaN for any zero I1 entry in degenerate scenes
    ratio = torch.full((fb.B,), 2.0 * float(opts.tol), dtype=dtype, device=device)
    n = torch.ones((fb.B,), dtype=torch.int32, device=device)

    def loop_on():
        with span(LOOP_COND):
            return bool(((ratio >= tol).any() & (n.max() < opts.max_orders)).item())

    while loop_on():
        with span(ORDER):
            dn_prev, up_prev = fb.order_step(dn_prev, up_prev)
            active = ratio >= tol
            a3 = active[:, None, None]
            dn_tot = torch.where(a3, dn_tot + dn_prev, dn_tot)
            up_tot = torch.where(a3, up_tot + up_prev, up_tot)
            ratio = torch.where(active, ratio_fn(dn_prev, up_prev, dn_tot, up_tot), ratio)
            n = n + active.to(torch.int32)

    return Solution(i_total=torch.cat([dn_tot, up_tot], dim=-1), i1=fb.i1, n_orders=n,
                    converged=ratio < tol, tau=fb.tau, idx_up=fb.idx_up,
                    idx_down=fb.idx_down)
