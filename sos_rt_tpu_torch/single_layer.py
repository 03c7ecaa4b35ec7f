"""Single-layer SOS solve (Duan–Min recursion, absorbing surface).

Counterpart of ``sos_rt_tpu/single_layer.py``, in plain PyTorch: one
homogeneous slab, one phase function, the direct solar beam at TOA, an
absorbing surface (ρ = 0), every field in van de Hulst's normalization
I·π/µ0 (F0 = 1).  This is the configuration van de Hulst's published
tables describe, and the one ``sos_rt_tpu_torch/validation/vdh.py``'s
anchors (the H-function law, doubling) check.

Each order is the reference engine's order on one column: the source
product with the slab's operator, the downward scan sweep (with the
small-µ values and the µ→0⁻ polyfit band), the upward scan sweep from a
zero boundary with no region joins, and the µ→0⁺ smoothing, on the scans
of ``ops/sweeps.py`` (``scan_impl`` 'associative' or 'sequential').  The
order loop stops at the 100 ppm ratio on Iₙ/I at TOA (µ>0) and at the
surface (µ<0), as the multi-layer engines do; per-order fields are kept
for the per-order comparison with the tables.  No kernel: the solve is a
validation path, not a production one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from sos_rt_tpu_torch.config import (GridSpec, MU0_RESONANCE_TOL, SolverOptions,
                                     full_precision_matmul, resolve_device,
                                     torch_dtype)
from sos_rt_tpu_torch.ops.source import source_operator
from sos_rt_tpu_torch.ops.sweeps import (DownFix, band_choice, device_stencils,
                                         down_sweep_scan, smooth_up_rows, stencils_on,
                                         up_sweep_scan)


@dataclasses.dataclass(frozen=True)
class SingleLayerSolution:
    """Van de Hulst-normalized radiance fields of one homogeneous slab."""

    i_total: Any       # (L, 2M) total field, I·π/µ0
    i_orders: Any      # (K, L, 2M) per-order fields (slot k = order k+1)
    order_valid: Any   # (K,) bool — slot accumulated before convergence
    n_orders: Any      # scalar int32
    converged: Any     # scalar bool


def first_order_single(tau, mu, nb_angles, mu0, alb, p0):
    """Closed-form I₁ (L, 2M) of one slab over an absorbing surface, F0 = 1
    (the caller applies the π/µ0 normalization).  ``tau`` (L,), ``mu``
    (2M,), ``p0`` (2M,); ``mu0`` and ``alb`` scalars."""
    m = nb_angles
    tau_star = tau[-1]
    k = alb / (4.0 * math.pi)
    e0 = torch.exp(-tau / mu0)[:, None]                       # (L, 1)
    pref = k * (mu0 / (mu0 + mu))[None, :] * p0[None, :]

    mu_d = mu[:m]
    safe_d = torch.where(mu_d == 0, -1.0, mu_d)
    down = pref[:, :m] * (e0 - torch.exp(tau[:, None] / safe_d[None, :]))
    # µ=0⁻ (grid index M-1): I₁ = (ω/4π)·P0·e^{-τ/µ0}
    down[:, m - 1] = k * p0[m - 1] * e0[:, 0]
    # |µ| = µ0 resonance → the linear-in-τ limit
    res = torch.abs(mu_d + mu0) < MU0_RESONANCE_TOL
    down = torch.where(res[None, :], k * p0[None, :m] * e0 * tau[:, None] / mu0, down)

    mu_u = mu[m:]
    safe_u = torch.where(mu_u == 0, 1.0, mu_u)
    e_star = torch.exp(-tau_star / mu0)
    up = pref[:, m:] * (e0 - e_star * torch.exp(-(tau_star - tau)[:, None]
                                                / safe_u[None, :]))
    # µ=0⁺ (grid index M): the same closed form as µ=0⁻
    up[:, 0] = k * p0[m] * e0[:, 0]
    return torch.cat([down, up], dim=1)


def solve_single_layer(mu0, tau_star, tables, grid: GridSpec, opts: SolverOptions,
                       alb=1.0, stencils=None, device=None) -> SingleLayerSolution:
    """SOS solve of one slab: per-order fields and the total, each I·π/µ0.

    ``tables``: (P0 (2M,), P (2M, 2M)) of the slab's phase function;
    ``alb``: the single-scattering albedo ω.  The loop runs at most
    ``opts.max_orders`` orders (I₁ is the first) and stops once the ratio
    falls below ``opts.tol``; the slots after it stay 0 and invalid.
    ``device`` defaults to CUDA."""
    full_precision_matmul()
    device = resolve_device(device)
    dtype = torch_dtype(opts.dtype)
    L, M = grid.nb_layers, grid.nb_angles
    on_dev = lambda x, dt=dtype: torch.as_tensor(x, dtype=dt, device=device)
    mu = on_dev(grid.mu())
    w_mu = on_dev(grid.trapz_weights())
    mu0, alb, tau_star = on_dev(mu0), on_dev(alb), on_dev(tau_star)
    p0, p = (on_dev(t) for t in tables)

    tau = on_dev(np.linspace(0.0, 1.0, L)) * tau_star
    i1 = first_order_single(tau, mu, M, mu0, alb, p0) * (math.pi / mu0)

    a_op = source_operator(p, w_mu)
    mu_d, mu_u = mu[:M], mu[M + 1:]
    st = (device_stencils(grid, mu.device, dtype) if stencils is None
          else stencils_on(stencils, mu.device, dtype))
    # no regions: the region starts lie beyond the slab, and one band choice,
    # band_choice(τ*), holds on every row
    beyond = torch.tensor([L + 1], device=device)
    down_fix = DownFix.build(st, tau[None], beyond, beyond + 1, mu,
                             choice=band_choice(tau_star).reshape(1))
    # no region joins, no surface reflection: join indices out of range
    no_join = torch.tensor(-5, device=device)
    bc_zero = torch.zeros((M - 1,), dtype=dtype, device=device)

    def order_step(in_prev):
        jn = (alb / 4.0) * (in_prev @ a_op)
        raw = down_sweep_scan(jn[:, :M], tau, mu_d, method=opts.scan_impl)
        down_fix.apply(raw[None], jn[None])
        up_raw = up_sweep_scan(jn[:, M + 1:], tau, mu_u, bc_zero, no_join, no_join,
                               method=opts.scan_impl)
        field = torch.cat([raw, jn[:, M:M + 1], up_raw], dim=1)
        return smooth_up_rows(field, mu, M)

    def ratio_of(in_new, i_tot):
        # 0/0 → 0 (converged): a degenerate scene's zero-radiance angles
        # must not poison the criterion
        div = lambda a, b: torch.where(b != 0, a / torch.where(b != 0, b, 1.0), 0.0)
        return torch.maximum(div(in_new[0, M:], i_tot[0, M:]).amax(),
                             div(in_new[-1, :M], i_tot[-1, :M]).amax())

    K = opts.max_orders
    buf = torch.zeros((K, L, 2 * M), dtype=dtype, device=device)
    buf[0] = i1
    valid = torch.zeros((K,), dtype=torch.bool, device=device)
    valid[0] = True
    i_tot, in_prev = i1.clone(), i1
    # an explicit above-tol seed: the loop takes at least one step
    ratio = torch.tensor(2.0 * opts.tol, dtype=dtype, device=device)
    tol = torch.tensor(opts.tol, dtype=dtype, device=device)
    n = 1
    for k in range(1, K):
        if not bool(ratio >= tol):
            break
        in_prev = order_step(in_prev)
        i_tot = i_tot + in_prev
        buf[k] = in_prev
        valid[k] = True
        ratio = ratio_of(in_prev, i_tot)
        n += 1
    return SingleLayerSolution(i_total=i_tot, i_orders=buf, order_valid=valid,
                               n_orders=torch.tensor(n, dtype=torch.int32),
                               converged=ratio < tol)


def vdh_extract(i_field, grid: GridSpec,
                mu_values=(0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0)):
    """Up and down radiances at van de Hulst's viewing angles: (I_up(µ),
    I_down(−µ)) at ``mu_values``, interpolated on the grid from row 0 (TOA,
    up) and row L-1 (surface, down) of ``i_field`` (L, 2M)."""
    m = grid.nb_angles
    field = np.asarray(torch.as_tensor(i_field).detach().cpu(), np.float64)
    mu = np.asarray(grid.mu(), np.float64)
    mv = np.asarray(mu_values, np.float64)
    up = np.interp(mv, mu[m:], field[0, m:])
    down = np.interp(-mv[::-1], mu[:m], field[-1, :m])[::-1]
    return up, down
