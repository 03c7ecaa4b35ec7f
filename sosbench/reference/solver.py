"""The reference SOS solve of a batch of columns, in plain PyTorch.

Per order (the reference's while-loop body, main_lambertian.py:311-460):
  1. Jₙ — two (L,2M)@(2M,2M) products, blended in the aerosol layer;
  2. downward sweep — one forward affine scan, the windowed small-µ values
     and the µ→0⁻ polyfit band;
  3. upward sweep — surface BC (Lambertian or specular), one reverse
     affine scan, the smoothing chain at the two region joins, and the
     µ→0⁺ smoothing walk on every row;
  4. the 100 ppm ratio at TOA-up and surface-down, each column stopping at
     its own order (its sum, ratio and count freeze).

:func:`solve` runs it in blocks of columns and returns the summary the
program's sweep writes: the TOA and surface rows of the total field, the
order counts and the convergence flags.
"""
from __future__ import annotations

import numpy as np
import torch

from sosbench.reference.first_order import first_order
from sosbench.reference.grid import mu_grid, neighbour_index, tau_profile, trapz_weights
from sosbench.reference.precision import mm
from sosbench.reference.sweeps import (_affine_scan, band_choice, build_stencils,
                                       polyfit_band_variants, select_band_choice,
                                       small_mu_values, small_mu_window, smooth_up_rows)

SCENE_KEYS = ("mu0", "grd_alb", "alb_atm", "alb_aer", "tau_star_atm", "tau_star_aer",
              "z0", "z_up", "z_down")


def _ratio(in_cur, i_tot, m):
    div = lambda a, b: torch.where(b != 0, a / torch.where(b != 0, b, 1.0), 0.0)
    r_toa = div(in_cur[..., 0, m:], i_tot[..., 0, m:]).amax(dim=-1)
    r_srf = div(in_cur[..., -1, :m], i_tot[..., -1, :m]).amax(dim=-1)
    return torch.maximum(r_toa, r_srf)


def _block(sc, p0_atm, p_atm, p0_aer, p_aer, M, L, surface, dtype, tol, max_orders):
    device = sc["mu0"].device
    sc = {k: v.to(dtype) for k, v in sc.items()}
    B = sc["mu0"].shape[0]
    mu_np = mu_grid(M)
    stencils = build_stencils(mu_np, M)
    mu = torch.as_tensor(mu_np, dtype=dtype, device=device)
    w_mu = torch.as_tensor(trapz_weights(mu_np), dtype=dtype, device=device)
    tau, idx_up, idx_down = tau_profile(sc["tau_star_atm"], sc["tau_star_aer"], sc["z0"],
                                        sc["z_up"], sc["z_down"], L)
    # dtau_atm = τ*_atm / nb_layers (main_lambertian.py:53), not the spacing
    dtau_aer = sc["tau_star_aer"] / (idx_down + 1 - idx_up)
    dtau_atm = sc["tau_star_atm"] / L
    w_atm = dtau_atm / (dtau_atm + dtau_aer)
    w_aer = dtau_aer / (dtau_atm + dtau_aer)
    i1 = first_order(surface, tau, mu, M, sc["mu0"], sc["grd_alb"], sc["alb_atm"],
                     sc["alb_aer"], p0_atm, p_atm, p0_aer, p_aer, idx_up, idx_down,
                     w_atm, w_aer, w_mu)
    a_atm = w_mu[:, None] * torch.flip(p_atm, dims=(1,)).T
    a_aer = w_mu[:, None] * torch.flip(p_aer, dims=(1,)).T

    t_idx = torch.arange(L, device=device)
    iu, idn = idx_up[:, None], idx_down[:, None]
    dtau_g = torch.diff(tau, dim=1)[:, :, None]
    mu_d = mu[:M]
    safe_mu_d = torch.where(mu_d == 0, -1.0, mu_d)
    att_d = torch.exp(dtau_g / safe_mu_d)
    mu_u = mu[M + 1:]
    att_u = torch.exp(-dtau_g / mu_u)
    join = ((t_idx[:-1] == idn) | (t_idx[:-1] == iu - 1))[:, :, None]
    c_up = torch.where(join, 0.0, 0.5 * dtau_g / mu_u)
    zeros_d = torch.zeros((B, 1, M), dtype=dtype, device=device)
    a_down_full = torch.cat([torch.ones_like(zeros_d), att_d], dim=1)
    a_up_full = torch.cat([att_u, torch.ones((B, 1, M - 1), dtype=dtype, device=device)],
                          dim=1)
    small_cols = torch.as_tensor(stencils.small_cols, device=device)
    has_small = stencils.small_cols.size > 0
    if has_small:
        mu_s = mu[small_cols]
        taylor_mask = torch.as_tensor(stencils.taylor_mask, device=device)
        window = small_mu_window(tau, idx_up, idx_down, mu_s)
    at = lambda idx: torch.gather(tau, 1, idx[:, None])
    iu1, id1 = neighbour_index(idx_up - 1, L), neighbour_index(idx_down + 1, L)
    choice_a = band_choice(at(iu1))[:, :, None]
    choice_bc = band_choice(at(idx_down))[:, :, None]
    poly_mask = torch.as_tensor(stencils.poly_mask, device=device)
    valid_a = select_band_choice(poly_mask, choice_a[:, 0])
    valid_bc = select_band_choice(poly_mask, choice_bc[:, 0])
    in_a_col = (t_idx < iu)[:, :, None]
    band_valid = torch.where(in_a_col, valid_a[:, None, :], valid_bc[:, None, :])
    band_cols = M - 1 - torch.arange(stencils.band_max, device=device)
    mirror_up = 2 * M - 1 - torch.arange(M + 1, 2 * M, device=device)
    lamb_w = w_mu[:M] * mu[:M]
    att_join1 = torch.exp(-torch.clamp(at(id1) - tau, min=0.0)[:, :, None] / mu_u)
    att_join2 = torch.exp(-torch.clamp(at(idx_up) - tau, min=0.0)[:, :, None] / mu_u)
    mask_join1 = (t_idx <= idn)[:, :, None]
    mask_join2 = (t_idx < iu)[:, :, None]
    cols = torch.arange(B, device=device)
    grd = sc["grd_alb"][:, None]
    c = lambda v: v[:, None, None]
    in_layer = ((t_idx >= iu) & (t_idx <= idn))[:, :, None]

    def source(x):
        jn_atm = c(sc["alb_atm"] / 4.0) * mm(x, a_atm)
        jn_aer = c(sc["alb_aer"] / 4.0) * mm(x, a_aer)
        return torch.where(in_layer, c(w_atm) * jn_atm + c(w_aer) * jn_aer, jn_atm)

    def compute_down(jn):
        jn_d = jn[:, :, :M]
        b = torch.cat([zeros_d, 0.5 * dtau_g * (jn_d[:, :-1] * att_d + jn_d[:, 1:])], dim=1)
        raw = -_affine_scan(a_down_full, b) / safe_mu_d
        if has_small:
            raw[:, :, small_cols] = small_mu_values(jn_d[:, :, small_cols],
                                                    raw[:, :, small_cols], mu_s,
                                                    taylor_mask, window)
        raw[:, :, M - 1] = 0.0
        polys, _ = polyfit_band_variants(raw, stencils)
        poly = torch.where(in_a_col, select_band_choice(polys, choice_a),
                           select_band_choice(polys, choice_bc))
        raw[:, :, band_cols] = torch.where(band_valid, poly, raw[:, :, band_cols])
        return raw

    def compute_up(jn, down_final):
        surf = down_final[:, L - 1]
        if surface == "lambertian":
            f_down = -torch.sum(lamb_w * surf, dim=1, keepdim=True)
            bc = (2.0 * grd * f_down).expand(B, M - 1)
        else:
            bc = grd * surf[:, mirror_up]
        jn_u = jn[:, :, M + 1:]
        b = torch.cat([c_up * (jn_u[:, :-1] + jn_u[:, 1:] * att_u), bc[:, None, :]], dim=1)
        raw = _affine_scan(a_up_full, b, reverse=True)
        field = torch.cat([torch.zeros_like(jn[:, :, :M]), jn[:, :, M:M + 1], raw], dim=2)

        def delta_at(field_now, row):
            r = field_now[cols, row]
            return (smooth_up_rows(r, mu, M) - r)[:, None, M + 1:]

        d1 = delta_at(field, id1)
        field[:, :, M + 1:] += torch.where(mask_join1, d1 * att_join1, 0.0)
        d2 = delta_at(field, idx_up)
        field[:, :, M + 1:] += torch.where(mask_join2, d2 * att_join2, 0.0)
        return smooth_up_rows(field, mu, M)

    def order_step(in_prev):
        jn = source(in_prev)
        down = compute_down(jn)
        up = compute_up(jn, down)
        return torch.cat([down, up[:, :, M:]], dim=2)

    tol_t = torch.tensor(tol, dtype=dtype, device=device)
    ratio = torch.full((B,), 2.0 * float(tol), dtype=dtype, device=device)
    n = torch.ones((B,), dtype=torch.int32, device=device)
    in_prev, i_tot = i1, i1
    for _ in range(1, int(max_orders)):
        active = ratio >= tol_t
        if not bool(active.any()):
            break
        in_new = order_step(in_prev)
        i_tot = torch.where(active[:, None, None], i_tot + in_new, i_tot)
        ratio = torch.where(active, _ratio(in_new, i_tot, M), ratio)
        n = n + active.to(torch.int32)
        in_prev = in_new
    return {"i_toa": i_tot[:, 0], "i_surface": i_tot[:, -1], "n_orders": n,
            "converged": ratio < tol_t}


def solve(scenes: dict, p0_atm, p_atm, p0_aer, p_aer, nb_angles: int, nb_layers: int,
          surface: str = "lambertian", dtype=torch.float64, tol: float = 1e-4,
          max_orders: int = 100, block: int = 64, device=None) -> dict:
    """The summary of every column of ``scenes`` ({key: (B,) array} of
    :data:`SCENE_KEYS`), solved ``block`` columns at a time on ``device``
    in ``dtype``.  ``p0_*``: (B, 2M) per column; ``p_*``: (2M, 2M).
    Returns {i_toa, i_surface: (B, 2M), n_orders, converged: (B,)} as
    NumPy arrays."""
    device = torch.device(device or "cpu")
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    pa, pr = as_t(p_atm), as_t(p_aer)
    B = len(np.asarray(scenes["mu0"]))
    outs = []
    for lo in range(0, B, block):
        sl = slice(lo, min(lo + block, B))
        sc = {k: torch.as_tensor(np.asarray(scenes[k], dtype=np.float64)[sl],
                                 device=device) for k in SCENE_KEYS}
        out = _block(sc, as_t(np.asarray(p0_atm)[sl]), pa, as_t(np.asarray(p0_aer)[sl]), pr,
                     nb_angles, nb_layers, surface, dtype, tol, max_orders)
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
        del out
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
