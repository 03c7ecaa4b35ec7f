"""Inputs of the in-kernel first scattering order I₁.

Counterpart of ``sos_rt_tpu/ops/first_order.py::first_order_mega_inputs``
(and its ``T_*`` tile indices).  The closed-form I₁ (the oracle's
3-region construction; reference SOS_Aer_main_specular.py:104-292) is
regrouped so that everything (L, B)- or (M, B)-sized is built here, and
only the (L, B, M)-sized work — the outer-product exponentials and one
stacked (4M, M) product — runs in the I₁ kernel (ops/megastream.py).

The Lambertian surface integrals over µ' are separable:
    surf[t,m] = Σ_k A[m,k]·e_t[t,k] − lam_att[t,m]·Σ_k A[m,k]·c_k
with the removable singularity at µ'=µ excised from A and added back as
its analytic limit.  The per-column closed form ``first_order`` (the
``i1='host'`` mode) is a later slice.
"""
from __future__ import annotations

import math

import torch

from sos_rt_tpu_torch.config import MU0_RESONANCE_TOL

# i1c tile rows (NI, M, B); unused rows (other surface) stay zero
(T_DDA, T_DDR, T_DBA, T_DBR, T_UDA, T_UDR, T_RESDN,
 T_ROWA, T_ROWB, T_BC, T_ROWC, T_ROWBU,
 T_SCKDNA, T_SCKDNB, T_SCKDNC, T_SCKUPA, T_SCKUPB, T_SCKUPC,
 T_DMA, T_DMR, T_UMA, T_UMR, T_UBA, T_UBR, T_RESUP) = range(25)
NI_TILES = 32


def _clamp_exp(x):
    return torch.exp(torch.clamp(x, max=0.0))


def first_order_mega_inputs(surface, tau, mu, nb_angles, mu0, grd_alb,
                            alb_atm, alb_aer, p0_atm, p_atm, p0_aer, p_aer,
                            idx_up, idx_down, w_atm, w_aer, w_mu, dtype):
    """Batched I₁ inputs for the in-kernel first order.

    tau: (B, L); mu0/grd_alb/alb_*/w_*: (B,); idx_*: (B,) int;
    p0_*: (2M,) or (B, 2M).  Returns (pack_rows dict of (L, B),
    tiles (NI, M, B), colc_pk (2, M), const (B,), astack (4M, M) or None).
    """
    B, L = tau.shape
    M = nb_angles
    dev = tau.device
    cast = lambda x: torch.as_tensor(x).to(device=dev, dtype=dtype)
    mu = cast(mu)
    w_mu = cast(w_mu)
    mu0 = cast(mu0)[:, None]                                  # (B, 1)
    rho = cast(grd_alb)[:, None]
    alb_atm = cast(alb_atm)[:, None]
    alb_aer = cast(alb_aer)[:, None]
    w_atm = cast(w_atm)[:, None]
    w_aer = cast(w_aer)[:, None]
    p0_atm = cast(p0_atm)
    p0_aer = cast(p0_aer)
    if p0_atm.dim() == 1:
        p0_atm = p0_atm[None, :].expand(B, 2 * M)
        p0_aer = p0_aer[None, :].expand(B, 2 * M)
    idx_up = torch.as_tensor(idx_up, device=dev).long()
    idx_down = torch.as_tensor(idx_down, device=dev).long()
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    ones = lambda *s: torch.ones(s, dtype=dtype, device=dev)

    f0 = math.pi / mu0                                        # (B, 1)
    tau_star = tau[:, -1:]
    gather = lambda idx: torch.gather(tau, 1, idx[:, None])
    tau_iu1 = gather(idx_up - 1)
    tau_iu = gather(idx_up)
    tau_id = gather(idx_down)
    tau_id1 = gather(idx_down + 1)
    e0_of = lambda t: torch.exp(-t / mu0)
    es = e0_of(tau_star)

    t_idx = torch.arange(L, device=dev)[None, :]
    in_a = t_idx < idx_up[:, None]
    in_b = (t_idx >= idx_up[:, None]) & (t_idx <= idx_down[:, None])
    region = torch.where(in_a, 0.0, torch.where(in_b, 1.0, 2.0)).to(dtype)

    sel3 = lambda va, vb, vc: torch.where(in_a, va, torch.where(in_b, vb, vc))
    tr_b_dn = sel3(torch.zeros_like(tau_iu1), tau_iu1, tau_id)
    tr_s_dn = sel3(torch.zeros_like(tau_iu), tau_iu, tau_id1)
    tr_b_up = sel3(tau_iu, tau_id1, tau_star)
    tr_s_up = sel3(tau_iu1, tau_id, tau_star)

    pack_rows = {
        "abdn": tau - tr_b_dn,
        "asdn": tau - tr_s_dn,
        "abup": tau - tr_b_up,
        "asup": tau - tr_s_up,
        "astar": tau - tau_star,
        "e0t": e0_of(tau),
        "es0t": torch.exp(-(tau_star - tau) / mu0),
        "e0rdn": sel3(torch.ones_like(tau_iu1), e0_of(tau_iu1), e0_of(tau_id)),
        "esrdn": torch.exp(-(tau_star - tr_s_dn) / mu0),
        "e0rup": sel3(e0_of(tau_iu), e0_of(tau_id1), es),
        "esrup": torch.exp(-(tau_star - tr_s_up) / mu0),
        "region": region,
    }
    pack_rows = {k: v.expand(B, L).T for k, v in pack_rows.items()}   # (L, B)

    # ---- per-(angle, column) coefficient tiles (M, B) ----
    md = torch.arange(M - 1, device=dev)
    mu_m = mu[md]
    mue = torch.arange(M + 1, 2 * M, device=dev)
    mu_u = mu[mue]
    mirror_up = 2 * M - 1 - mue
    c4pi = f0 / (4 * math.pi)                                 # (B, 1)

    # down direct: rows 0..M-2 ratio µ0/(µ0+µ), row M-1 (µ=0) ratio 1;
    # resonance-safe denominator (the limit replaces the value)
    res_m = torch.abs(mu_m[None, :] + mu0) < MU0_RESONANCE_TOL
    ratio_dn = torch.cat(
        [mu0 / torch.where(res_m, 1.0, mu0 + mu_m[None, :]), ones(B, 1)], dim=1)
    dd = lambda p0: (ratio_dn * p0[:, :M] * c4pi).T          # (M, B)
    db = lambda p0: (p0[:, :M] * c4pi / mu0).T
    res_dn = torch.cat([res_m, torch.zeros((B, 1), dtype=torch.bool, device=dev)],
                       dim=1).to(dtype).T

    # up direct: row 0 (µ=0⁺, grid index M) ratio µ0/(µ0+0)=1
    ratio_up = torch.cat([ones(B, 1), mu0 / (mu0 + mu_u[None, :])], dim=1)
    ud = lambda p0: (ratio_up * p0[:, M:] * c4pi).T

    tiles = zeros(NI_TILES, M, B)
    tiles[T_DDA] = dd(p0_atm)
    tiles[T_DDR] = dd(p0_aer)
    tiles[T_DBA] = db(p0_atm)
    tiles[T_DBR] = db(p0_aer)
    tiles[T_UDA] = ud(p0_atm)
    tiles[T_UDR] = ud(p0_aer)
    tiles[T_RESDN] = res_dn

    ca_b, cr_b = alb_atm * w_atm, alb_aer * w_aer             # (B, 1)
    zero_b = torch.zeros_like(ca_b)
    lamb = surface == "lambertian"

    if lamb:
        mu_p = mu[M:]
        wp = w_mu[M:]
        const = (rho * es / 4.0)[:, 0]
        mirror_cols = 2 * M - 1 - torch.arange(M, 2 * M, device=dev)
        guard = (mu_p > 0).to(dtype)
        wg = wp * guard
        safe_p = torch.where(mu_p > 0, mu_p, 1.0)
        pm_atm = cast(p_atm)[:, mirror_cols]
        pm_aer = cast(p_aer)[:, mirror_cols]
        rdn = mu_p[None, :] / (mu_p[None, :] - mu_m[:, None])
        # full-M down operator: rows 0..M-2 the µ′-integral, row M-1 the
        # µ=0⁻ special row (pm[M-1]·wg)
        a_dn = lambda pm: torch.cat(
            [rdn * pm[md] * wg[None, :], (pm[M - 1] * wg)[None, :]], dim=0)
        denom_u = mu_p[None, :] - mu_u[:, None]
        rup = mu_p[None, :] / torch.where(denom_u == 0, 1.0, denom_u)
        sing_k = mue - M
        sing_mask = torch.arange(M, device=dev)[None, :] == sing_k[:, None]
        # full-M up operator: row 0 the µ=0⁺ special row (pm[M]·wg)
        a_up = lambda pm: torch.cat(
            [(pm[M] * wg)[None, :],
             torch.where(sing_mask, 0.0, rup * pm[mue] * wg[None, :])], dim=0)
        a_dn_atm, a_dn_aer = a_dn(pm_atm), a_dn(pm_aer)
        a_up_atm, a_up_aer = a_up(pm_atm), a_up(pm_aer)
        astack = torch.cat([a_dn_atm, a_dn_aer, a_up_atm, a_up_aer])
        # excised-singularity rows (per angle): row 0 → 0
        pk_row = lambda pm: torch.cat(
            [zeros(1), torch.gather(pm[mue], 1, sing_k[:, None])[:, 0] * wg[sing_k]])
        colc_pk = torch.stack([pk_row(pm_atm), pk_row(pm_aer)])

        def ck_of(tref):                                      # (B, M)
            return torch.where(mu_p[None, :] > 0,
                               torch.exp(-(tau_star - tref) / safe_p[None, :]),
                               0.0)

        def sck(a_atm, a_aer, ca, cr, tref):
            # region surface constants Σ_k A[m,k]·e^{-(τ*-tref)/µ'_k}
            ck = ck_of(tref)
            return ca.T * (a_atm @ ck.T) + cr.T * (a_aer @ ck.T)

        z = torch.zeros_like(tau_star)
        tiles[T_SCKDNA] = sck(a_dn_atm, a_dn_aer, alb_atm, zero_b, z)
        tiles[T_SCKDNB] = sck(a_dn_atm, a_dn_aer, ca_b, cr_b, tau_iu)
        tiles[T_SCKDNC] = sck(a_dn_atm, a_dn_aer, alb_atm, zero_b, tau_id1)
        tiles[T_SCKUPA] = sck(a_up_atm, a_up_aer, alb_atm, zero_b, tau_iu1)
        tiles[T_SCKUPB] = sck(a_up_atm, a_up_aer, ca_b, cr_b, tau_id)
        tiles[T_SCKUPC] = sck(a_up_atm, a_up_aer, alb_atm, zero_b, tau_star)
    else:
        const = zeros(B)
        astack = None
        colc_pk = zeros(2, M)
        # specular mirror-surface coefficient tiles
        frs = f0 * rho * es / (4 * math.pi)                   # (B, 1)
        rm_dn = torch.cat([mu0 / (mu0 - mu_m[None, :]), ones(B, 1)], dim=1)
        p0m_dn = lambda p0: torch.cat([p0[:, 2 * M - 1 - md], p0[:, M:M + 1]], dim=1)
        res_u = torch.abs(mu_u[None, :] - mu0) < MU0_RESONANCE_TOL
        rm_up = torch.cat(
            [ones(B, 1), mu0 / torch.where(res_u, 1.0, mu0 - mu_u[None, :])], dim=1)
        p0m_up = lambda p0: torch.cat([p0[:, M - 1:M], p0[:, mirror_up]], dim=1)
        tiles[T_DMA] = (rm_dn * p0m_dn(p0_atm) * frs).T
        tiles[T_DMR] = (rm_dn * p0m_dn(p0_aer) * frs).T
        tiles[T_UMA] = (rm_up * p0m_up(p0_atm) * frs).T
        tiles[T_UMR] = (rm_up * p0m_up(p0_aer) * frs).T
        tiles[T_UBA] = (p0m_up(p0_atm) * frs / mu0).T
        tiles[T_UBR] = (p0m_up(p0_aer) * frs / mu0).T
        tiles[T_RESUP] = torch.cat(
            [torch.zeros((B, 1), dtype=torch.bool, device=dev), res_u],
            dim=1).to(dtype).T

    # ---- boundary "before" rows, evaluated at per-column scalar layers ----
    def dn_at(tau_r, tr_b, e0r, tr_s, ca, cr):
        """(B, M-1) downward row at per-column scalar layer tau_r."""
        att_b = _clamp_exp((tau_r - tr_b) / mu_m[None, :])
        att_s = _clamp_exp((tau_r - tr_s) / mu_m[None, :])
        e0_r = e0_of(tau_r)
        p0d = ca * p0_atm[:, :M - 1] + cr * p0_aer[:, :M - 1]
        res = torch.abs(mu_m[None, :] + mu0) < MU0_RESONANCE_TOL
        direct = (mu0 / torch.where(res, 1.0, mu0 + mu_m[None, :])) \
            * p0d * c4pi * (e0_r - e0r * att_b)
        d_res = p0d * c4pi * e0_r * (tau_r - tr_b) / mu0
        direct = torch.where(res, d_res, direct)
        if lamb:
            et_r = ck_of(tau_r)
            row = ca * (et_r @ a_dn_atm[:M - 1].T) + cr * (et_r @ a_dn_aer[:M - 1].T)
            ck_s = ck_of(tr_s)
            sck_r = ca * (ck_s @ a_dn_atm[:M - 1].T) + cr * (ck_s @ a_dn_aer[:M - 1].T)
            surf = const[:, None] * (row - att_s * sck_r)
        else:
            p0m = ca * p0_atm[:, 2 * M - 1 - md] + cr * p0_aer[:, 2 * M - 1 - md]
            esr = torch.exp(-(tau_star - tr_s) / mu0)
            surf = ((mu0 / (mu0 - mu_m[None, :])) * p0m * frs
                    * (torch.exp(-(tau_star - tau_r) / mu0) - esr * att_s))
        return direct + surf

    def up_at(tau_r, tr_b, e0r, tr_s, ca, cr):
        att_b = _clamp_exp(-(tr_b - tau_r) / mu_u[None, :])
        att_s = _clamp_exp(-(tr_s - tau_r) / mu_u[None, :])
        e0_r = e0_of(tau_r)
        es0_r = torch.exp(-(tau_star - tau_r) / mu0)
        p0d = ca * p0_atm[:, mue] + cr * p0_aer[:, mue]
        direct = (mu0 / (mu0 + mu_u[None, :])) * p0d * c4pi * (e0_r - e0r * att_b)
        if lamb:
            et_r = ck_of(tau_r)
            row = ca * (et_r @ a_up_atm[1:].T) + cr * (et_r @ a_up_aer[1:].T)
            ck_s = ck_of(tr_s)
            sck_r = ca * (ck_s @ a_up_atm[1:].T) + cr * (ck_s @ a_up_aer[1:].T)
            pk = ca * colc_pk[0][1:][None, :] + cr * colc_pk[1][1:][None, :]
            lim = ((1.0 / mu_u)[None, :]
                   * _clamp_exp(-(tau_star - tau_r) / mu_u[None, :])
                   * (tr_s - tau_r) * pk * const[:, None])
            surf = const[:, None] * (row - att_s * sck_r) + lim
        else:
            p0m = ca * p0_atm[:, mirror_up] + cr * p0_aer[:, mirror_up]
            esr = torch.exp(-(tau_star - tr_s) / mu0)
            res = torch.abs(mu_u[None, :] - mu0) < MU0_RESONANCE_TOL
            surf = ((mu0 / torch.where(res, 1.0, mu0 - mu_u[None, :]))
                    * p0m * frs * (es0_r - esr * att_s))
            s_res = p0m * frs * es0_r * (tr_s - tau_r) / mu0
            surf = torch.where(res, s_res, surf)
        return direct + surf

    one_b = torch.ones_like(tau_star)
    pad_last = lambda r: torch.cat([r, zeros(B, 1)], dim=1).T    # (M, B)
    pad_first = lambda r: torch.cat([zeros(B, 1), r], dim=1).T

    row_a = dn_at(tau_iu1, torch.zeros_like(tau_iu1), one_b,
                  torch.zeros_like(tau_iu1), alb_atm, zero_b)
    row_b = (dn_at(tau_id, tau_iu1, e0_of(tau_iu1), tau_iu, ca_b, cr_b)
             + row_a * _clamp_exp((tau_id - tau_iu1) / mu_m[None, :]))
    tiles[T_ROWA] = pad_last(row_a)
    tiles[T_ROWB] = pad_last(row_b)

    # surface BC from the full downward row at τ* (general + µ=0 column);
    # the pure-atm coefficients hold under idx_down <= L-2 (grids.py)
    dn_surf = dn_at(tau_star, tau_id, e0_of(tau_id), tau_id1,
                    alb_atm, zero_b) + row_b * _clamp_exp(
        (tau_star - tau_id) / mu_m[None, :])
    p0dz = alb_atm * p0_atm[:, M - 1:M] + zero_b * p0_aer[:, M - 1:M]
    dz_surf = (p0dz * c4pi * es)[:, 0]
    if lamb:
        ez = ck_of(tau_star) @ (pm_atm[M - 1] * wg)
        dz_surf = dz_surf + const * alb_atm[:, 0] * ez
        i1_surf = torch.cat([dn_surf, dz_surf[:, None]], dim=1)
        f1_down = -torch.sum(w_mu[:M][None, :] * i1_surf * mu[:M][None, :], dim=1)
        bc = (2.0 * rho[:, 0] * f1_down)[:, None].expand(B, M - 1)
    else:
        p0mz = alb_atm * p0_atm[:, M:M + 1]
        dz_surf = dz_surf + (p0mz * frs)[:, 0]
        i1_surf = torch.cat([dn_surf, dz_surf[:, None]], dim=1)
        bc = rho * i1_surf[:, mirror_up]
    tiles[T_BC] = pad_first(bc)

    row_c = (up_at(tau_id1, tau_star, es, tau_star, alb_atm, zero_b)
             + bc * _clamp_exp(-(tau_star - tau_id1) / mu_u[None, :]))
    row_bu = (up_at(tau_iu, tau_id1, e0_of(tau_id1), tau_id, ca_b, cr_b)
              + row_c * _clamp_exp(-(tau_id1 - tau_iu) / mu_u[None, :]))
    tiles[T_ROWC] = pad_first(row_c)
    tiles[T_ROWBU] = pad_first(row_bu)

    return pack_rows, tiles, colc_pk, const, astack
