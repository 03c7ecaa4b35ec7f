"""Layer-sharded whole-column SOS solve (the long-column solver mode).

Counterpart of ``sos_rt_tpu/parallel/layer_sharded.py``:
:func:`solve_column_layer_sharded` runs the full order loop of one column
with its layer axis sharded contiguously over a mesh axis, one rank a
shard.  Per order:

1. Jₙ — layer-parallel products (operators replicated);
2. the sweeps' trapezoid sources — each layer reads its neighbour's Jₙ
   row: one halo a direction, the shards' edge rows all-gathered (the axis
   is small; gloo and NCCL both take the collective);
3. both affine sweeps — :func:`~sos_rt_tpu_torch.parallel.layer_scan.
   local_affine_scan`, one all-gather of the per-shard compositions;
4. the surface row (the BC), the two join rows and the four convergence
   rows are single rows of a sharded field: the shard that owns a row sends
   it and the others zeros, summed by ``all_reduce`` (adding zeros is
   exact), so every rank holds the same ratio and the loop stops together;
5. the µ→0⁻ polyfit band and the µ→0⁺ smoothing walk are layer-local.

Plain PyTorch, no kernel.  The products ignore ``opts.mm`` and run at full
precision, as the TPU package's do.  Scope: grids without small-µ columns
(the windowed integral gathers arbitrary upstream layers), the mega
kernel's eligibility rule.  It equals ``solver.solve_column`` up to the
scans' reassociation.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from sos_rt_tpu_torch.config import (GridSpec, Scene, SolverOptions, full_precision_matmul,
                                     torch_dtype)
from sos_rt_tpu_torch.grids import neighbour_index, tau_profile
from sos_rt_tpu_torch.ops.first_order import first_order
from sos_rt_tpu_torch.ops.source import source_operator
from sos_rt_tpu_torch.ops.sweeps import (DownFix, device_stencils, smooth_up_rows,
                                         stencils_for)
from sos_rt_tpu_torch.parallel.layer_scan import local_affine_scan
from sos_rt_tpu_torch.parallel.mesh import all_gather_rows, mesh_axis, mesh_device
from sos_rt_tpu_torch.solver import PhaseTables, Solution, _columns, _ratio, _unbatched


def layer_sharded_supported(grid: GridSpec, stencils=None) -> bool:
    """The mega kernel's small-µ eligibility: the windowed integral's
    arbitrary-layer reads are the one stage that crosses shards, so grids
    without small-µ columns are exact here."""
    if stencils is None:
        stencils = stencils_for(grid)
    return stencils.small_cols.size == 0


def solve_column_layer_sharded(scene: Scene, tables: PhaseTables, grid: GridSpec,
                               opts: SolverOptions, mesh, axis: str = "data"):
    """One-column SOS solve with the layers sharded over ``mesh[axis]``.

    Every rank passes the same column (Scene fields () or (1,), P0 tables
    (2M,)) and computes on its own device.  Returns, on every rank, a
    :class:`Solution` of unbatched fields as ``solver.solve_column`` does:
    ``i_total`` gathered to the full (L, 2M).  Raises ``ValueError`` for a
    grid with small-µ columns (:func:`layer_sharded_supported`) and for L
    not divisible by the axis size."""
    if not layer_sharded_supported(grid):
        raise ValueError("layer-sharded solve requires a grid without live small-µ "
                         "columns (same eligibility as the mega kernel)")
    ax = mesh_axis(mesh, axis)
    group, place, d = ax
    L, M = grid.nb_layers, grid.nb_angles
    if L % d:
        raise ValueError(f"nb_layers {L} not divisible by mesh axis {d}")
    rows = L // d
    own = slice(place * rows, (place + 1) * rows)
    full_precision_matmul()
    dtype = torch_dtype(opts.dtype)
    device = mesh_device(mesh)
    scene, tables = _columns(scene, tables, device)
    sc = scene.map(lambda x: x.to(dtype))
    mu = torch.as_tensor(grid.mu(), dtype=dtype, device=device)
    w_mu = torch.as_tensor(grid.trapz_weights(), dtype=dtype, device=device)

    # ---- loop-invariant per-layer arrays (1, L, ...), as solver._setup_column
    # builds them, then this rank's rows --------------------------------------
    tau, idx_up, idx_down = tau_profile(sc.tau_star_atm, sc.tau_star_aer, sc.z0,
                                        sc.z_up, sc.z_down, L)
    dtau_aer = sc.tau_star_aer / (idx_down + 1 - idx_up)
    dtau_atm = sc.tau_star_atm / L
    w_atm = dtau_atm / (dtau_atm + dtau_aer)
    w_aer = dtau_aer / (dtau_atm + dtau_aer)
    i1 = first_order(opts.surface, tau, mu, M, sc.mu0, sc.grd_alb, sc.alb_atm,
                     sc.alb_aer, tables.p0_atm, tables.p_atm, tables.p0_aer,
                     tables.p_aer, idx_up, idx_down, w_atm, w_aer, w_mu)
    a_atm = source_operator(tables.p_atm.to(dtype), w_mu)
    a_aer = source_operator(tables.p_aer.to(dtype), w_mu)

    iu, idn = int(idx_up[0]), int(idx_down[0])
    id1 = int(neighbour_index(idx_down + 1, L)[0])
    t_idx = torch.arange(L, device=device)[:, None]                   # (L, 1)
    mu_d, mu_u = mu[:M], mu[M + 1:]
    safe_mu_d = torch.where(mu_d == 0, -1.0, mu_d)
    zero = torch.zeros((1, 1), dtype=dtype, device=device)
    dtau = torch.diff(tau, dim=1)
    dtau_prev = torch.cat([zero, dtau], dim=1)[:, :, None]            # (1, L, 1)
    dtau_next = torch.cat([dtau, zero], dim=1)[:, :, None]
    # down: S_t = a_t S_{t-1} + ½Δτ_{t-1,t}(jn_{t-1}·a_t + jn_t), a_0 = 1
    a_down = torch.exp(dtau_prev / safe_mu_d)
    # up: S_t = a_t S_{t+1} + c_t(jn_t + jn_{t+1}·a_t), a_{L-1} = 1, c = 0 at
    # the joins and at the surface row, which carries the BC
    a_up = torch.where(t_idx == L - 1, 1.0, torch.exp(-dtau_next / mu_u))
    join = (t_idx == idn) | (t_idx == iu - 1) | (t_idx == L - 1)
    c_up = torch.where(join, 0.0, 0.5 * dtau_next / mu_u)
    in_layer = (t_idx >= iu) & (t_idx <= idn)
    down_fix = DownFix.build(device_stencils(grid, tau.device, dtype), tau, idx_up,
                             idx_down, mu).rows(own)
    tau_at = lambda i: tau[:, i:i + 1]                                 # (1, 1)
    mirror_up = 2 * M - 1 - torch.arange(M + 1, 2 * M, device=device)
    lamb_w = w_mu[:M] * mu[:M]
    att_join1 = torch.exp(-torch.clamp(tau_at(id1) - tau, min=0.0)[:, :, None] / mu_u)
    att_join2 = torch.exp(-torch.clamp(tau_at(iu) - tau, min=0.0)[:, :, None] / mu_u)
    mask_join1, mask_join2 = t_idx <= idn, t_idx < iu
    loc = lambda x: x[:, own] if x.dim() == 3 else x[own]
    (a_down, a_up, c_up, in_layer, dtau_prev, att_join1, att_join2, mask_join1,
     mask_join2) = map(loc, (a_down, a_up, c_up, in_layer, dtau_prev, att_join1,
                             att_join2, mask_join1, mask_join2))
    alb_atm, alb_aer = sc.alb_atm[:, None, None], sc.alb_aer[:, None, None]
    wa, wr, grd = w_atm[:, None, None], w_aer[:, None, None], sc.grd_alb[:, None]
    first, last = place == 0, place == d - 1

    def row_at(field, row):
        """Global row ``row`` of a (1, rows, 2M) sharded field, (1, 2M) on
        every rank: its owner's values plus the others' zeros."""
        r = torch.zeros_like(field[:, 0])
        if row // rows == place:
            r = r + field[:, row % rows]
        dist.all_reduce(r, group=group)
        return r

    def halo(edge, src):
        """Shard ``src``'s (1, K) ``edge`` row, (1, 1, K): every shard's edge
        row is gathered (every rank takes part), zeros where ``src`` is
        outside the layer axis."""
        rows_all = all_gather_rows(edge, group, d)[:, None, None]
        return rows_all[src] if 0 <= src < d else torch.zeros_like(rows_all[0])

    def source_fn(in_prev):
        jn_atm = (alb_atm / 4.0) * (in_prev @ a_atm)
        jn_aer = (alb_aer / 4.0) * (in_prev @ a_aer)
        return torch.where(in_layer, wa * jn_atm + wr * jn_aer, jn_atm)

    def compute_down(jn):
        jn_d = jn[:, :, :M]
        jn_prev = torch.cat([halo(jn_d[:, -1], place - 1), jn_d[:, :-1]], dim=1)
        b = 0.5 * dtau_prev * (jn_prev * a_down + jn_d)
        return down_fix.apply(-local_affine_scan(a_down, b, ax) / safe_mu_d, jn_d)

    def compute_up(jn, down):
        surf = row_at(down, L - 1)                                     # (1, M)
        if opts.surface == "lambertian":
            f_down = -torch.sum(lamb_w * surf, dim=1, keepdim=True)
            bc = (2.0 * grd * f_down).expand(1, M - 1)
        else:
            bc = grd * surf[:, mirror_up]
        jn_u = jn[:, :, M + 1:]
        jn_next = torch.cat([jn_u[:, 1:], halo(jn_u[:, 0], place + 1)], dim=1)
        b = c_up * (jn_u + jn_next * a_up)
        if last:
            b[:, -1] = bc
        raw = local_affine_scan(a_up, b, ax, reverse=True)
        field = torch.cat([torch.zeros_like(jn[:, :, :M]), jn[:, :, M:M + 1], raw],
                          dim=2)

        def delta_at(field_now, row):
            r = row_at(field_now, row)
            return (smooth_up_rows(r, mu, M) - r)[:, None, M + 1:]

        d1 = delta_at(field, id1)
        field[:, :, M + 1:] += torch.where(mask_join1, d1 * att_join1, 0.0)
        d2 = delta_at(field, iu)
        field[:, :, M + 1:] += torch.where(mask_join2, d2 * att_join2, 0.0)
        return smooth_up_rows(field, mu, M)

    def order_step(in_prev):
        jn = source_fn(in_prev)
        down = compute_down(jn)
        up = compute_up(jn, down)
        return torch.cat([down, up[:, :, M:]], dim=2)

    def edge_rows(in_cur, i_tot):
        """Rows 0 and L − 1 of both fields, (1, 2, 2M) each, one all_reduce."""
        r = torch.zeros((2, 2, 2 * M), dtype=dtype, device=device)
        if first:
            r[:, 0] = torch.stack([in_cur[0, 0], i_tot[0, 0]])
        if last:
            r[:, 1] = torch.stack([in_cur[0, -1], i_tot[0, -1]])
        dist.all_reduce(r, group=group)
        return r[0:1], r[1:2]

    tol = torch.tensor(opts.tol, dtype=dtype, device=device)
    ratio = torch.full((1,), 2.0 * float(opts.tol), dtype=dtype, device=device)
    n = torch.ones((1,), dtype=torch.int32, device=device)
    in_prev = i_tot = loc(i1)
    for _ in range(1, int(opts.max_orders)):
        if not bool(ratio >= tol):
            break
        in_new = order_step(in_prev)
        i_tot = i_tot + in_new
        ratio = _ratio(*edge_rows(in_new, i_tot), M)
        n = n + 1
        in_prev = in_new
    i_total = all_gather_rows(i_tot[0], group, d)[None]
    return _unbatched(Solution(i_total=i_total, i1=i1, n_orders=n, converged=ratio < tol,
                               tau=tau, idx_up=idx_up, idx_down=idx_down))
