"""The closed-form first scattering order I₁ (B, L, 2M) of a batch of columns.

The reference's 3-region construction (SOS_Aer_main_specular.py:104-292),
written over a leading batch axis: every region's closed form differs
only in a handful of per-layer reference scalars (the region's boundary
optical depth and the attenuations anchored there); those are selected per
layer first and each exponential is then evaluated once over (B, L, M).
The Lambertian surface integrals over µ' are separable:
    surf[t,m] = Σ_k A[m,k]·e_t[t,k] − lam_att[t,m]·Σ_k A[m,k]·c_k
with the removable singularity at µ'=µ excised from A and added back as
its analytic limit.  Its products go through :func:`precision.mm`.
"""
from __future__ import annotations

import math

import torch

from sosbench.reference.grid import MU0_RESONANCE_TOL, neighbour_index
from sosbench.reference.precision import mm


def _clamp_exp(x):
    return torch.exp(torch.clamp(x, max=0.0))


# bytes one (columns, L, M) temporary of :func:`first_order` may take; a
# larger batch is evaluated in chunks of columns (about 40 such
# temporaries are alive at the peak)
FIRST_ORDER_PLANE_BYTES = 256 * 2 ** 20


def first_order(surface, tau, mu, nb_angles, mu0, grd_alb, alb_atm, alb_aer,
                p0_atm, p_atm, p0_aer, p_aer, idx_up, idx_down,
                w_atm, w_aer, w_mu):
    """I₁ (B, L, 2M) for a batch of columns.

    tau: (B, L); mu0/grd_alb/alb_*/w_*: (B,); idx_*: (B,) int; p0_*: (2M,)
    shared or (B, 2M) per column; p_*: (2M, 2M); ``w_mu``: trapz weights
    of the full µ grid.  Columns are evaluated ``FIRST_ORDER_PLANE_BYTES``
    worth of (L, M) planes at a time."""
    B, L = tau.shape
    per_col = L * nb_angles * tau.element_size()
    step = max(1, FIRST_ORDER_PLANE_BYTES // per_col)
    if B <= step:
        return _first_order_block(surface, tau, mu, nb_angles, mu0, grd_alb,
                                  alb_atm, alb_aer, p0_atm, p_atm, p0_aer, p_aer,
                                  idx_up, idx_down, w_atm, w_aer, w_mu)
    per_column = [tau, mu0, grd_alb, alb_atm, alb_aer, idx_up, idx_down, w_atm, w_aer]
    p0 = [p0_atm, p0_aer]
    out = []
    for lo in range(0, B, step):
        sl = slice(lo, lo + step)
        tv, m0, ra, aa, ar, iu, idn, wa, wr = (torch.as_tensor(x)[sl] for x in per_column)
        pa, pr = (x if torch.as_tensor(x).dim() == 1 else x[sl] for x in p0)
        out.append(_first_order_block(surface, tv, mu, nb_angles, m0, ra, aa, ar,
                                      pa, p_atm, pr, p_aer, iu, idn, wa, wr, w_mu))
    return torch.cat(out)


def _first_order_block(surface, tau, mu, nb_angles, mu0, grd_alb, alb_atm,
                       alb_aer, p0_atm, p_atm, p0_aer, p_aer, idx_up, idx_down,
                       w_atm, w_aer, w_mu):
    """:func:`first_order` on one chunk of columns.  Per-column scalars are
    (B, 1) here, per-layer ones (B, L), per-angle ones (B, M-1); ``lay``
    and ``ang`` lift them to (B, L, 1) and (B, 1, M-1)."""
    B, L = tau.shape
    M = nb_angles
    dtype, dev = tau.dtype, tau.device
    cast = lambda x: torch.as_tensor(x).to(device=dev, dtype=dtype)
    col = lambda x: cast(x).reshape(-1, 1).expand(B, 1)
    lay = lambda x: x[:, :, None]
    ang = lambda x: x[:, None, :]
    mu, w_mu, p_atm, p_aer = cast(mu), cast(w_mu), cast(p_atm), cast(p_aer)
    mu0, rho = col(mu0), col(grd_alb)
    alb_atm, alb_aer, w_atm, w_aer = col(alb_atm), col(alb_aer), col(w_atm), col(w_aer)
    p0_atm, p0_aer = cast(p0_atm), cast(p0_aer)
    if p0_atm.dim() == 1:
        p0_atm = p0_atm[None, :].expand(B, 2 * M)
        p0_aer = p0_aer[None, :].expand(B, 2 * M)
    idx_up = torch.as_tensor(idx_up, device=dev).long().reshape(B)
    idx_down = torch.as_tensor(idx_down, device=dev).long().reshape(B)
    lamb = surface == "lambertian"
    four_pi = 4 * math.pi

    f0 = math.pi / mu0                                         # (B, 1)
    tau_star = tau[:, L - 1:]
    e0 = torch.exp(-tau / mu0)                                 # (B, L)
    es = torch.exp(-tau_star / mu0)
    e_s0 = torch.exp(-(tau_star - tau) / mu0)
    t_idx = torch.arange(L, device=dev)[None, :]
    in_a = t_idx < idx_up[:, None]                             # (B, L) region masks
    in_b = (t_idx >= idx_up[:, None]) & (t_idx <= idx_down[:, None])
    sel2 = lambda va, vb, vc: torch.where(in_a, va, torch.where(in_b, vb, vc))
    sel3 = lambda va, vb, vc: torch.where(lay(in_a), va, torch.where(lay(in_b), vb, vc))

    # species coefficients per layer: pure-atm (regions A, C) vs the
    # dτ-weighted aerosol-layer mix (region B, main_lambertian.py:149-151)
    zero = torch.zeros((B, 1), dtype=dtype, device=dev)
    one = torch.ones((B, 1), dtype=dtype, device=dev)
    ca_col = torch.where(in_b, alb_atm * w_atm, alb_atm)       # (B, L)
    cr_col = torch.where(in_b, alb_aer * w_aer, zero)
    ca_b, cr_b = alb_atm * w_atm, alb_aer * w_aer              # region-B pair

    at = lambda src, idx: torch.gather(src, 1, idx[:, None])   # (B, 1)
    # the neighbour layers of the aerosol layer (L − 1 at an edge)
    iu1, id1 = neighbour_index(idx_up - 1, L), neighbour_index(idx_down + 1, L)
    tau_iu1, tau_iu = at(tau, iu1), at(tau, idx_up)
    tau_id, tau_id1 = at(tau, idx_down), at(tau, id1)

    md = torch.arange(M - 1, device=dev)
    mu_m = mu[md]
    res_dn = torch.abs(mu_m[None, :] + mu0) < MU0_RESONANCE_TOL     # (B, M-1)
    mue = torch.arange(M + 1, 2 * M, device=dev)
    mu_u = mu[mue]
    res_up = torch.abs(mu_u[None, :] - mu0) < MU0_RESONANCE_TOL
    mirror_dn = 2 * M - 1 - md
    mirror_up = 2 * M - 1 - mue

    mix = lambda ca, cr, cols: ca * p0_atm[:, cols] + cr * p0_aer[:, cols]
    mix_l = lambda cols: (lay(ca_col) * ang(p0_atm[:, cols])
                          + lay(cr_col) * ang(p0_aer[:, cols]))     # (B, L, M-1)
    p0d_dn, p0m_dn = mix_l(md), mix_l(mirror_dn)
    p0d_up, p0m_up = mix_l(mue), mix_l(mirror_up)

    # ---- Lambertian surface-integral operators (shared by both sweeps) ----
    if lamb:
        mu_p = mu[M:]                                  # µ' ∈ [0, 1]
        const = rho * es / 4.0                         # (B, 1)
        mirror_cols = 2 * M - 1 - torch.arange(M, 2 * M, device=dev)
        wg = w_mu[M:] * (mu_p > 0).to(dtype)           # drop the µ'=0 endpoint
        safe_p = torch.where(mu_p > 0, mu_p, 1.0)

        def ck_of(tref):
            # reference-level constant e^{-(τ*-tref)/µ'}: (B, 1) → (B, M)
            return torch.where(mu_p > 0, torch.exp(-(tau_star - tref) / safe_p), 0.0)

        # e^{-(τ*-τ_t)/µ'}: one (B, L, M) table reused by every region
        et = torch.where(mu_p > 0, torch.exp(-lay(tau_star - tau) / safe_p), 0.0)
        pm_atm = p_atm[:, mirror_cols]                 # raw P(µ, -µ')
        pm_aer = p_aer[:, mirror_cols]
        ratio_dn = mu_p[None, :] / (mu_p[None, :] - mu_m[:, None])
        a_dn_atm = ratio_dn * pm_atm[md] * wg[None, :]             # (M-1, M)
        a_dn_aer = ratio_dn * pm_aer[md] * wg[None, :]
        e_dn_atm = mm(et, a_dn_atm.T)                                 # (B, L, M-1)
        e_dn_aer = mm(et, a_dn_aer.T)

        denom_u = mu_p[None, :] - mu_u[:, None]
        ratio_up = mu_p[None, :] / torch.where(denom_u == 0, 1.0, denom_u)
        sing_k = mue - M                     # local index of µ' == µ in mu_p
        sing_mask = torch.arange(M, device=dev)[None, :] == sing_k[:, None]
        a_up_atm = torch.where(sing_mask, 0.0, ratio_up * pm_atm[mue] * wg[None, :])
        a_up_aer = torch.where(sing_mask, 0.0, ratio_up * pm_aer[mue] * wg[None, :])
        e_up_atm = mm(et, a_up_atm.T)
        e_up_aer = mm(et, a_up_aer.T)
        pk_atm = torch.gather(pm_atm[mue], 1, sing_k[:, None])[:, 0]
        pk_aer = torch.gather(pm_aer[mue], 1, sing_k[:, None])[:, 0]
        wk = wg[sing_k]
        # µ=0 rows (down col M-1 uses P row M-1; up col M uses row M)
        e_dz_atm = mm(et, pm_atm[M - 1] * wg)                       # (B, L)
        e_dz_aer = mm(et, pm_aer[M - 1] * wg)
        e_uz_atm = mm(et, pm_atm[M] * wg)
        e_uz_aer = mm(et, pm_aer[M] * wg)

        def sck(a_atm, a_aer, ca, cr, tref):
            # the region surface constant Σ_k A[m,k]·ck(region): (B, M-1)
            ck = ck_of(tref)
            return ca * mm(ck, a_atm.T) + cr * mm(ck, a_aer.T)

        def pick_rows(row_a, row_b, row_c):
            return sel3(ang(row_a), ang(row_b), ang(row_c))

        rows_of = lambda e, t_row: e[torch.arange(B, device=dev), t_row]   # (B, M-1)
    else:
        frs = f0 * rho * es                                        # (B, 1)

    # =================== downward field, parameterized =====================
    tr_b_dn = sel2(zero, tau_iu1, tau_id)                          # att ref
    e0r_dn = sel2(one, at(e0, iu1), at(e0, idx_down))
    tr_s_dn = sel2(zero, tau_iu, tau_id1)                          # surf ref
    esr_dn = torch.exp(-(tau_star - tr_s_dn) / mu0)

    att_b_dn = _clamp_exp(lay(tau - tr_b_dn) / mu_m)               # (B, L, M-1)
    att_s_dn = _clamp_exp(lay(tau - tr_s_dn) / mu_m)

    # resonance-safe denominator: at |µ+µ0| < tol the direct term is
    # replaced by its linear-in-τ limit below
    den_dn = torch.where(res_dn, 1.0, mu0 + mu_m[None, :])         # (B, M-1)
    col3 = lambda x: x[:, :, None]                                 # (B, 1) → (B, 1, 1)

    def down_vals(att_b, att_s, tau_col, tr_b, e0r, esr, e0_col, es0_col,
                  p0d, p0m, sck_sel=None, row_sel=None):
        direct = (ang(mu0 / den_dn) * p0d / four_pi * col3(f0)
                  * (e0_col - e0r * att_b))
        d_res = p0d / four_pi * col3(f0) * e0_col * (tau_col - tr_b) / col3(mu0)
        direct = torch.where(ang(res_dn), d_res, direct)
        if lamb:
            surf = col3(const) * (row_sel - att_s * sck_sel)
        else:
            surf = (ang(mu0 / (mu0 - mu_m[None, :])) * p0m / four_pi
                    * col3(frs) * (es0_col - esr * att_s))
        return direct + surf

    if lamb:
        sck_dn = pick_rows(sck(a_dn_atm, a_dn_aer, alb_atm, zero, zero),
                           sck(a_dn_atm, a_dn_aer, ca_b, cr_b, tau_iu),
                           sck(a_dn_atm, a_dn_aer, alb_atm, zero, tau_id1))
        set_dn = lay(ca_col) * e_dn_atm + lay(cr_col) * e_dn_aer   # Σ A·et
        lam_kw = dict(sck_sel=sck_dn, row_sel=set_dn)
    else:
        lam_kw = dict()

    base_dn = down_vals(att_b_dn, att_s_dn, lay(tau), lay(tr_b_dn), lay(e0r_dn),
                        lay(esr_dn), lay(e0), lay(e_s0), p0d_dn, p0m_dn, **lam_kw)

    # boundary rows: the same parameterized formula at the boundary layer
    # (one τ per column), chained with the in-region attenuations
    def down_row(t_row, tr_b, e0r, tr_s, region):
        tau_r = at(tau, t_row)
        att_b = _clamp_exp((tau_r - tr_b) / mu_m[None, :])
        att_s = _clamp_exp((tau_r - tr_s) / mu_m[None, :])
        ca, cr = (ca_b, cr_b) if region == "B" else (alb_atm, zero)
        if lamb:
            kw = dict(sck_sel=ang(sck(a_dn_atm, a_dn_aer, ca, cr, tr_s)),
                      row_sel=ang(ca * rows_of(e_dn_atm, t_row)
                                  + cr * rows_of(e_dn_aer, t_row)))
        else:
            kw = dict()
        esr = torch.exp(-(tau_star - tr_s) / mu0)
        return down_vals(ang(att_b), ang(att_s), col3(tau_r), col3(tr_b), col3(e0r),
                         col3(esr), col3(at(e0, t_row)), col3(at(e_s0, t_row)),
                         ang(mix(ca, cr, md)), ang(mix(ca, cr, mirror_dn)), **kw)[:, 0]

    row_a = down_row(iu1, zero, one, zero, "A")
    row_b = (down_row(idx_down, tau_iu1, at(e0, iu1), tau_iu, "B")
             + row_a * _clamp_exp((tau_id - tau_iu1) / mu_m[None, :]))

    before_dn = sel3(torch.zeros((B, 1, M - 1), dtype=dtype, device=dev),
                     ang(row_a), ang(row_b))
    down_general = base_dn + before_dn * att_b_dn

    # µ = 0⁻ column (index M-1): before=0, drop e^{τ/µ} terms
    p0dz = ca_col * p0_atm[:, M - 1:M] + cr_col * p0_aer[:, M - 1:M]   # (B, L)
    p0mz = ca_col * p0_atm[:, M:M + 1] + cr_col * p0_aer[:, M:M + 1]
    dz = p0dz / four_pi * f0 * e0
    if lamb:
        dz = dz + const * (ca_col * e_dz_atm + cr_col * e_dz_aer)
    else:
        dz = dz + p0mz / four_pi * frs * e_s0
    down_zero_col = dz

    # ==================== upward field, parameterized ======================
    down_surf_row = torch.cat([down_general[:, L - 1], down_zero_col[:, L - 1:L]], dim=1)
    if lamb:
        f1_down = -torch.sum(w_mu[:M] * down_surf_row * mu[:M], dim=1, keepdim=True)
        bc = (2.0 * rho * f1_down).expand(B, M - 1)
    else:
        bc = rho * down_surf_row[:, mirror_up]

    e0_last = e0[:, L - 1:]
    tr_b_up = sel2(tau_iu, tau_id1, tau_star)
    e0r_up = sel2(at(e0, idx_up), at(e0, id1), e0_last)
    tr_s_up = sel2(tau_iu1, tau_id, tau_star)
    esr_up = torch.exp(-(tau_star - tr_s_up) / mu0)

    att_b_up = _clamp_exp(-lay(tr_b_up - tau) / mu_u)
    att_s_up = _clamp_exp(-lay(tr_s_up - tau) / mu_u)

    den_up = torch.where(res_up, 1.0, mu0 - mu_u[None, :])   # resonance-safe (µ=µ0)

    def up_vals(att_b, att_s, tau_col, tr_s, e0r, esr, e0_col, es0_col,
                p0d, p0m, ts_exp=None, sck_sel=None, row_sel=None, pk_sel=None):
        direct = (ang(mu0 / (mu0 + mu_u[None, :])) * p0d / four_pi * col3(f0)
                  * (e0_col - e0r * att_b))
        if lamb:
            # excised µ'=µ singularity added back as its analytic limit
            lim = ((1.0 / mu_u) * ts_exp * (tr_s - tau_col)
                   * pk_sel * col3(const) * wk)
            surf = col3(const) * (row_sel - att_s * sck_sel) + lim
        else:
            surf = (ang(mu0 / den_up) * p0m / four_pi
                    * col3(frs) * (es0_col - esr * att_s))
            s_res = (p0m / four_pi * col3(frs) * es0_col
                     * (tr_s - tau_col) / col3(mu0))
            surf = torch.where(ang(res_up), s_res, surf)
        return direct + surf

    if lamb:
        ts_exp = _clamp_exp(-lay(tau_star - tau) / mu_u)
        sck_up = pick_rows(sck(a_up_atm, a_up_aer, alb_atm, zero, tau_iu1),
                           sck(a_up_atm, a_up_aer, ca_b, cr_b, tau_id),
                           sck(a_up_atm, a_up_aer, alb_atm, zero, tau_star))
        set_up = lay(ca_col) * e_up_atm + lay(cr_col) * e_up_aer
        pk_sel = lay(ca_col) * pk_atm + lay(cr_col) * pk_aer
        lam_up = dict(ts_exp=ts_exp, sck_sel=sck_up, row_sel=set_up, pk_sel=pk_sel)
    else:
        lam_up = dict()

    base_up = up_vals(att_b_up, att_s_up, lay(tau), lay(tr_s_up), lay(e0r_up),
                      lay(esr_up), lay(e0), lay(e_s0), p0d_up, p0m_up, **lam_up)

    def up_row(t_row, tr_b, e0r, tr_s, region):
        tau_r = at(tau, t_row)
        att_b = _clamp_exp(-(tr_b - tau_r) / mu_u[None, :])
        att_s = _clamp_exp(-(tr_s - tau_r) / mu_u[None, :])
        ca, cr = (ca_b, cr_b) if region == "B" else (alb_atm, zero)
        if lamb:
            kw = dict(
                ts_exp=ang(_clamp_exp(-(tau_star - tau_r) / mu_u[None, :])),
                sck_sel=ang(sck(a_up_atm, a_up_aer, ca, cr, tr_s)),
                row_sel=ang(ca * rows_of(e_up_atm, t_row) + cr * rows_of(e_up_aer, t_row)),
                pk_sel=ang(ca * pk_atm[None, :] + cr * pk_aer[None, :]))
        else:
            kw = dict()
        esr = torch.exp(-(tau_star - tr_s) / mu0)
        return up_vals(ang(att_b), ang(att_s), col3(tau_r), col3(tr_s), col3(e0r),
                       col3(esr), col3(at(e0, t_row)), col3(at(e_s0, t_row)),
                       ang(mix(ca, cr, mue)), ang(mix(ca, cr, mirror_up)), **kw)[:, 0]

    row_c = (up_row(id1, tau_star, e0_last, tau_star, "C")
             + bc * _clamp_exp(-(tau_star - tau_id1) / mu_u[None, :]))
    row_b_u = (up_row(idx_up, tau_id1, at(e0, id1), tau_id, "B")
               + row_c * _clamp_exp(-(tau_id1 - tau_iu) / mu_u[None, :]))

    before_up = sel3(ang(row_b_u), ang(row_c), ang(bc))
    up_general = base_up + before_up * att_b_up

    # µ = 0⁺ column (index M): before = 0, drop e^{-Δ/µ} terms
    p0dz_u = p0mz                       # P0 at index M, the direct term here
    p0mz_u = p0dz                       # P0 at index M-1, its mirror
    uz = (mu0 / (mu0 + mu[M])) * p0dz_u / four_pi * f0 * e0
    if lamb:
        uz = uz + const * (ca_col * e_uz_atm + cr_col * e_uz_aer)
    else:
        uz = uz + p0mz_u / four_pi * frs * e_s0
    up_zero_col = uz

    # columns are contiguous: [0..M-2 | M-1 | M | M+1..2M-1]
    return torch.cat([down_general, down_zero_col[:, :, None],
                      up_zero_col[:, :, None], up_general], dim=2)
