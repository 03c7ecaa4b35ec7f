"""The reference engine: the SOS column solver in plain PyTorch.

Counterpart of ``sos_rt_tpu/solver.py``: :class:`PhaseTables`,
:class:`Solution`, and ``solve_column`` — one column — with its batched
form :func:`solve_batch_reference` (the TPU package maps ``solve_column``
over columns; here every step carries a leading (B,) column axis).

Per order (the reference's while-loop body, main_lambertian.py:311-460):
  1. Jₙ — two (L,2M)@(2M,2M) products, blended in the aerosol layer;
  2. downward sweep — one forward affine scan + the windowed small-µ
     prefix difference + the µ→0⁻ polyfit band;
  3. upward sweep — surface BC (Lambertian dot / specular mirror gather),
     one reverse affine scan, smoothing-delta chaining at the two region
     joins, and the µ→0⁺ smoothing walk on every row;
  4. convergence ratio at TOA-up and surface-down (100 ppm criterion),
     per-column masked accumulation, so each column stops at exactly the
     order the reference would.

Everything that does not depend on Jₙ is computed once before the order
loop (:func:`_setup_column`).  The stages run inside the JAX package's
named scopes, as the spans of ``spans.py`` (``torch.profiler.
record_function`` ranges): ``sos.first_order``, and per order
``sos.source_jn``, ``sos.down_sweep`` and ``sos.up_sweep_bc``
(``tools/profile.py`` reads them).  The loop runs on the host with one
sync per order.  The products are matrix products, but in float32 'bf16x3' /
'bf16x5' on the card, where the source is one launch of the fused engine's
source kernel an order (``ops/fused_source.py``); on the CPU, and with
``shard_tables`` (each rank holds only some of the operators' columns), the
split products of ops/precision.py.  The rest is elementwise work and
scans.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from sos_rt_tpu_torch.config import (GridSpec, Scene, SolverOptions,
                                     full_precision_matmul, resolve_device,
                                     torch_dtype)
from sos_rt_tpu_torch.grids import neighbour_index, tau_profile
from sos_rt_tpu_torch.ops.first_order import first_order
from sos_rt_tpu_torch.ops.fused_source import (SPLIT_MODES, fused_source, mix_source,
                                               source_columns, source_copy)
from sos_rt_tpu_torch.ops.precision import make_split_dot
from sos_rt_tpu_torch.ops.source import source_operator
from sos_rt_tpu_torch.ops.sweeps import (
    DownFix,
    SweepStencils,
    _affine_scan,
    device_stencils,
    smooth_up_rows,
    stencils_on,
)
from sos_rt_tpu_torch.spans import DOWN_SWEEP, FIRST_ORDER, SOURCE_JN, UP_SWEEP_BC, span


@dataclasses.dataclass(frozen=True)
class PhaseTables:
    """Phase-function tables as tensors: P0 (2M,) or (B, 2M) per species,
    P (2M, 2M) per species."""

    p0_atm: Any
    p_atm: Any
    p0_aer: Any
    p_aer: Any

    @classmethod
    def from_models(cls, grid: GridSpec, mu0: float, atm=("rayleigh", {}),
                    aer=("rayleigh", {}), dtype=torch.float64, device=None,
                    cache: bool = True):
        from sos_rt_tpu_torch.models import build_phase_tables

        device = resolve_device(device)
        mu = grid.mu()
        p0a, pa = build_phase_tables(atm[0], mu, mu0, cache=cache, **atm[1])
        p0r, pr = build_phase_tables(aer[0], mu, mu0, cache=cache, **aer[1])
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in (p0a, pa, p0r, pr)))

    @classmethod
    def from_models_batched_mu0(cls, grid: GridSpec, mu0_values,
                                atm=("rayleigh", {}), aer=("rayleigh", {}),
                                dtype=torch.float64, device=None,
                                cache: bool = True):
        """Tables for a µ0 sweep: P0 gets a leading (B,) axis (one row per
        column's µ0), the P matrices are built once and shared."""
        from sos_rt_tpu_torch.models import build_phase_tables

        device = resolve_device(device)
        mu = grid.mu()
        mu0_values = np.asarray(mu0_values, dtype=np.float64)
        build = lambda spec, m0: build_phase_tables(spec[0], mu, float(m0),
                                                    cache=cache, **spec[1])
        pa = build(atm, mu0_values[0])[1]
        pr = build(aer, mu0_values[0])[1]
        p0a = np.stack([build(atm, m0)[0] for m0 in mu0_values])
        p0r = np.stack([build(aer, m0)[0] for m0 in mu0_values])
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in (p0a, pa, p0r, pr)))

    def take(self, idx) -> "PhaseTables":
        """Columns ``idx`` of per-column (B, 2M) P0 tables; shared tables
        are returned unchanged."""
        if self.p0_atm.dim() != 2:
            return self
        return dataclasses.replace(self, p0_atm=self.p0_atm[idx],
                                   p0_aer=self.p0_aer[idx])


@dataclasses.dataclass(frozen=True)
class Solution:
    """Radiance solution for a batch of columns (:func:`solve_column`: one
    column, every field without the leading batch axis)."""

    i_total: Any       # (B, L, 2M) total radiance field
    i1: Any            # (B, L, 2M) first order, or None
    n_orders: Any      # (B,) int32
    converged: Any     # (B,) bool
    tau: Any           # (B, L)
    idx_up: Any
    idx_down: Any


def _ratio(in_cur, i_tot, nb_angles):
    """Convergence criterion (main_lambertian.py:311) per column of
    (..., L, 2M) fields; 0/0 → 0, so a degenerate scene's zero-radiance
    angles count as converged instead of poisoning the max with NaN."""
    m = nb_angles
    div = lambda a, b: torch.where(b != 0, a / torch.where(b != 0, b, 1.0), 0.0)
    r_toa = div(in_cur[..., 0, m:], i_tot[..., 0, m:]).amax(dim=-1)
    r_srf = div(in_cur[..., -1, :m], i_tot[..., -1, :m]).amax(dim=-1)
    return torch.maximum(r_toa, r_srf)


def _model_columns(op, group, place: int, size: int):
    """This rank's share of ``op``'s columns among the ``size`` ranks of
    ``group`` — the columns [place·w, (place+1)·w), w = ⌈n/size⌉, zero-padded
    to w — and the function that all-gathers every rank's (..., w) product
    slices into the (..., n) product."""
    n = op.shape[1]
    w = -(-n // size)
    lo, hi = min(place * w, n), min((place + 1) * w, n)
    part = op.new_zeros((op.shape[0], w))
    part[:, :hi - lo] = op[:, lo:hi]

    def gather(y):
        out = y.new_empty((size * y.shape[0],) + tuple(y.shape[1:]))
        dist.all_gather_into_tensor(out, y.contiguous(), group=group)
        out = torch.movedim(out.reshape((size,) + tuple(y.shape)), 0, -2)
        return out.reshape(tuple(y.shape[:-1]) + (size * w,))[..., :n]
    return part, gather


def _setup_column(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                  opts: SolverOptions, stencils: SweepStencils = None, model=None):
    """Shared setup of (B,)-batched ``scenes`` (fields as tensors on one
    device; P0 tables (2M,) shared or (B, 2M) per column): returns (i1
    (B, L, 2M), order_step, tau (B, L), idx_up (B,), idx_down (B,)), where
    ``order_step`` maps Iₙ₋₁ (B, L, 2M) to Iₙ.  The scene is taken in the
    compute dtype ``opts.dtype`` from the start.  ``model`` = (process group,
    this rank's place, size): the group's ranks each compute their share of
    the source operators' columns and all-gather Jₙ every order
    (``solve_batch(mesh=, shard_tables=True)``)."""
    full_precision_matmul()
    dtype = torch_dtype(opts.dtype)
    device = scenes.mu0.device
    L, M = grid.nb_layers, grid.nb_angles
    sc = scenes.map(lambda x: x.to(dtype))
    B = sc.mu0.shape[0]
    mu = torch.as_tensor(grid.mu(), dtype=dtype, device=device)
    w_mu = torch.as_tensor(grid.trapz_weights(), dtype=dtype, device=device)

    tau, idx_up, idx_down = tau_profile(sc.tau_star_atm, sc.tau_star_aer, sc.z0,
                                        sc.z_up, sc.z_down, L)
    # mixing weights — the reference defines dtau_atm = τ*_atm/nb_layers
    # (main_lambertian.py:53), NOT the grid spacing τ*_atm/(L-1)
    dtau_aer = sc.tau_star_aer / (idx_down + 1 - idx_up)
    dtau_atm = sc.tau_star_atm / L
    w_atm = dtau_atm / (dtau_atm + dtau_aer)
    w_aer = dtau_aer / (dtau_atm + dtau_aer)

    with span(FIRST_ORDER):
        i1 = first_order(opts.surface, tau, mu, M, sc.mu0, sc.grd_alb, sc.alb_atm,
                         sc.alb_aer, tables.p0_atm, tables.p_atm, tables.p0_aer,
                         tables.p_aer, idx_up, idx_down, w_atm, w_aer, w_mu)
    a_atm = source_operator(tables.p_atm.to(dtype), w_mu)
    a_aer = source_operator(tables.p_aer.to(dtype), w_mu)

    # ---------------- loop-invariant precomputation ----------------
    t_idx = torch.arange(L, device=device)
    iu, idn = idx_up[:, None], idx_down[:, None]
    dtau_g = torch.diff(tau, dim=1)[:, :, None]                  # (B, L-1, 1)
    mu_d = mu[:M]
    safe_mu_d = torch.where(mu_d == 0, -1.0, mu_d)
    att_d = torch.exp(dtau_g / safe_mu_d)                        # (B, L-1, M)
    mu_u = mu[M + 1:]
    att_u = torch.exp(-dtau_g / mu_u)                            # (B, L-1, M-1)
    join = ((t_idx[:-1] == idn) | (t_idx[:-1] == iu - 1))[:, :, None]
    c_up = torch.where(join, 0.0, 0.5 * dtau_g / mu_u)
    zeros_d = torch.zeros((B, 1, M), dtype=dtype, device=device)
    a_down_full = torch.cat([torch.ones_like(zeros_d), att_d], dim=1)
    a_up_full = torch.cat([att_u, torch.ones((B, 1, M - 1), dtype=dtype,
                                             device=device)], dim=1)

    # the µ→0⁻ small-µ and polyfit-band fixes (loop-invariant masks)
    st = (device_stencils(grid, device, dtype) if stencils is None
          else stencils_on(stencils, device, dtype))
    down_fix = DownFix.build(st, tau, idx_up, idx_down, mu)

    # upward BC machinery
    at = lambda idx: torch.gather(tau, 1, idx[:, None])          # (B, 1)
    # the neighbour layer below the aerosol layer (L − 1 at an edge)
    id1 = neighbour_index(idx_down + 1, L)
    mirror_up = 2 * M - 1 - torch.arange(M + 1, 2 * M, device=device)
    lamb_w = w_mu[:M] * mu[:M]
    # smoothing-join chain attenuations (region joins r1=idx_down+1, r2=idx_up)
    att_join1 = torch.exp(-torch.clamp(at(id1) - tau, min=0.0)[:, :, None]
                          / mu_u)
    att_join2 = torch.exp(-torch.clamp(at(idx_up) - tau, min=0.0)[:, :, None] / mu_u)
    mask_join1 = (t_idx <= idn)[:, :, None]
    mask_join2 = (t_idx < iu)[:, :, None]
    cols = torch.arange(B, device=device)

    # split-product precision mode (ops/precision.py); None keeps full
    # precision products.  On the card the split modes take the source
    # kernel (ops/fused_source.py); the CPU and shard_tables, whose ranks
    # hold only some of the operators' columns, keep the split products
    mm = opts.mm if dtype == torch.float32 else None
    split = mm in SPLIT_MODES
    src_cols = source_columns(sc.alb_atm, sc.alb_aer, w_atm, w_aer, idx_up, idx_down,
                              dtype)

    def make_dot(op):
        if model is not None:
            op, gather = _model_columns(op, *model)
        dot = make_split_dot(op, mm, dtype) if split else lambda x: x @ op
        return dot if model is None else lambda x: gather(dot(x))

    if split and model is None and a_atm.is_cuda:
        wcopy = source_copy(a_atm, a_aer, M, mm)
        source = lambda x: fused_source(x[:, :, :M], x[:, :, M:], wcopy, src_cols, mm)
    else:
        dot_atm, dot_aer = make_dot(a_atm), make_dot(a_aer)
        source = lambda x: mix_source(dot_atm(x), dot_aer(x), src_cols)
    grd = sc.grd_alb[:, None]

    def source_fn(in_prev):
        with span(SOURCE_JN):
            return source(in_prev)

    def compute_down(jn):
        jn_d = jn[:, :, :M]
        b = torch.cat([zeros_d, 0.5 * dtau_g * (jn_d[:, :-1] * att_d + jn_d[:, 1:])],
                      dim=1)
        s = _affine_scan(a_down_full, b, method=opts.scan_impl)
        return down_fix.apply(-s / safe_mu_d, jn_d)

    def compute_up(jn, down_final):
        surf = down_final[:, L - 1]
        if opts.surface == "lambertian":
            f_down = -torch.sum(lamb_w * surf, dim=1, keepdim=True)
            bc = (2.0 * grd * f_down).expand(B, M - 1)
        else:
            bc = grd * surf[:, mirror_up]
        jn_u = jn[:, :, M + 1:]
        c = c_up * (jn_u[:, :-1] + jn_u[:, 1:] * att_u)
        b = torch.cat([c, bc[:, None, :]], dim=1)
        raw = _affine_scan(a_up_full, b, reverse=True, method=opts.scan_impl)
        field = torch.cat([torch.zeros_like(jn[:, :, :M]), jn[:, :, M:M + 1], raw],
                          dim=2)

        # region-join chaining of SMOOTHED boundary rows, each column's own
        # row gathered
        def delta_at(field_now, row):
            r = field_now[cols, row]                               # (B, 2M)
            return (smooth_up_rows(r, mu, M) - r)[:, None, M + 1:]

        d1 = delta_at(field, id1)
        field[:, :, M + 1:] += torch.where(mask_join1, d1 * att_join1, 0.0)
        d2 = delta_at(field, idx_up)
        field[:, :, M + 1:] += torch.where(mask_join2, d2 * att_join2, 0.0)
        return smooth_up_rows(field, mu, M)

    def order_step(in_prev):
        jn = source_fn(in_prev)
        with span(DOWN_SWEEP):
            down = compute_down(jn)
        with span(UP_SWEEP_BC):
            up = compute_up(jn, down)
        return torch.cat([down, up[:, :, M:]], dim=2)

    return i1, order_step, tau, idx_up, idx_down


def _columns(scenes: Scene, tables: PhaseTables, device):
    """(B,)-batched scene fields and tables on ``device``; a single
    column's () or (1,) fields become (1,)."""
    from sos_rt_tpu_torch.fused import scene_on, tables_on

    scenes = scenes.map(lambda x: torch.atleast_1d(torch.as_tensor(x, dtype=torch.float64)))
    return scene_on(scenes, device), tables_on(tables, device)


def _order_loop(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                opts: SolverOptions, stencils, save_rows, keep_orders: bool,
                model=None):
    """The order loop over a batch: a column accumulates only while its
    ratio is ≥ tol, up to ``max_orders`` orders; the loop ends when no
    column is active.  With ``keep_orders``, Iₙ (or its rows ``save_rows``)
    goes to slot n-1 of a (B, max_orders, ...) buffer while its column is
    active, zeros otherwise, with the slot's validity.  ``model``: see
    :func:`_setup_column`; the group's ranks hold equal fields after each
    gather, so they take the same number of orders."""
    dtype = torch_dtype(opts.dtype)
    M, K = grid.nb_angles, int(opts.max_orders)
    i1, order_step, tau, idx_up, idx_down = _setup_column(scenes, tables, grid,
                                                          opts, stencils, model)
    B, device = i1.shape[0], i1.device
    tol = torch.tensor(opts.tol, dtype=dtype, device=device)
    if save_rows is None:
        sel = lambda f: f
    else:
        ridx = torch.as_tensor([r % grid.nb_layers for r in save_rows], device=device)
        sel = lambda f: f[:, ridx]
    buf = valid = None
    if keep_orders:
        first = sel(i1)
        buf = torch.zeros((B, K) + tuple(first.shape[1:]), dtype=i1.dtype,
                          device=device)
        buf[:, 0] = first
        valid = torch.zeros((B, K), dtype=torch.bool, device=device)
        valid[:, 0] = True
    # explicit above-tol seed (the loop must take at least one step);
    # _ratio(ones, i1) would be inf for any zero I1 entry
    ratio = torch.full((B,), 2.0 * float(opts.tol), dtype=i1.dtype, device=device)
    n = torch.ones((B,), dtype=torch.int32, device=device)
    in_prev, i_tot = i1, i1
    for k in range(1, K):
        active = ratio >= tol
        if not bool(active.any()):
            break
        # inactive columns keep iterating on in_new but never accumulate:
        # i_tot, ratio and n are frozen, so results equal the per-column stop
        in_new = order_step(in_prev)
        a3 = active[:, None, None]
        i_tot = torch.where(a3, i_tot + in_new, i_tot)
        if keep_orders:
            buf[:, k] = torch.where(a3, sel(in_new), 0.0)
            valid[:, k] = active
        ratio = torch.where(active, _ratio(in_new, i_tot, M), ratio)
        n = n + active.to(torch.int32)
        in_prev = in_new
    sol = Solution(i_total=i_tot, i1=i1, n_orders=n, converged=ratio < tol, tau=tau,
                   idx_up=idx_up, idx_down=idx_down)
    return sol, buf, valid


def _unbatched(x):
    """The single column of a batch of one (Solution or tensor)."""
    if isinstance(x, torch.Tensor):
        return x[0]
    return dataclasses.replace(x, **{f.name: getattr(x, f.name)[0]
                                     for f in dataclasses.fields(x)})


def solve_batch_reference(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                          opts: SolverOptions, stencils: SweepStencils = None,
                          device=None) -> Solution:
    """The reference engine over (B,)-batched ``scenes``: every column as
    :func:`solve_column` solves it, in one batch.  Returns a
    :class:`Solution` with (B, ...) fields and ``i1``.  ``device`` defaults
    to CUDA."""
    scenes, tables = _columns(scenes, tables, resolve_device(device))
    return _order_loop(scenes, tables, grid, opts, stencils, None, False)[0]


def solve_column(scene: Scene, tables: PhaseTables, grid: GridSpec,
                 opts: SolverOptions, stencils: SweepStencils = None, device=None):
    """Solve one column: Scene fields of shape () or (1,), P0 tables (2M,).
    Returns a :class:`Solution` of unbatched fields (i_total (L, 2M),
    n_orders (), ...).  ``device`` defaults to CUDA."""
    return _unbatched(solve_batch_reference(scene, tables, grid, opts, stencils,
                                            device))


def solve_column_orders(scene: Scene, tables: PhaseTables, grid: GridSpec,
                        opts: SolverOptions, stencils: SweepStencils = None,
                        save_rows=None, device=None):
    """Solve one column keeping the per-order fields Iₙ (the reference's
    ``I_saved`` list, main_lambertian.py:306-460).

    Returns (Solution, i_orders, order_valid (max_orders,)): slot k holds
    order k+1 where valid, zeros elsewhere.  ``save_rows``: None keeps the
    full (max_orders, L, 2M) fields; a tuple of layer indices (negatives
    allowed) keeps only those rows per order, (max_orders, len(save_rows),
    2M).  ``device`` defaults to CUDA."""
    scene, tables = _columns(scene, tables, resolve_device(device))
    sol, buf, valid = _order_loop(scene, tables, grid, opts, stencils, save_rows,
                                  True)
    return _unbatched(sol), buf[0], valid[0]


def solve_batch_orders(scenes: Scene, tables: PhaseTables, grid: GridSpec,
                       opts: SolverOptions, rows=(0, -1),
                       stencils: SweepStencils = None, device=None):
    """Batched per-order read-set: :func:`solve_column_orders` of every
    column with ``save_rows=rows`` (default TOA + surface, from which
    per-order TOA fluxes and diffusivity derive); ``rows=None`` keeps full
    per-order fields (B·K·L·2M — small batches only).  Returns (Solution
    with (B, ...) fields, orders (B, max_orders, len(rows), 2M), valid
    (B, max_orders)).  ``device`` defaults to CUDA."""
    scenes, tables = _columns(scenes, tables, resolve_device(device))
    return _order_loop(scenes, tables, grid, opts, stencils, rows, True)
