"""The closed-form first scattering order I₁, and its in-kernel inputs.

Counterpart of ``sos_rt_tpu/ops/first_order.py``: :func:`first_order`
(the oracle's 3-region construction; reference
SOS_Aer_main_specular.py:104-292), written over a leading batch axis, and
``first_order_mega_inputs`` with its ``T_*`` tile indices, the same closed
form regrouped so that everything (L, B)- or (M, B)-sized is built on the
host side and only the (L, B, M)-sized work — the outer-product
exponentials and one stacked (4M, M) product — runs in the I₁ kernel
(ops/megastream.py).

Every region's closed form differs only in a handful of per-layer
reference scalars (the region's boundary optical depth and the
attenuations anchored there); those are selected per layer first and each
exponential is then evaluated once over (B, L, M).  The Lambertian surface
integrals over µ' are separable:
    surf[t,m] = Σ_k A[m,k]·e_t[t,k] − lam_att[t,m]·Σ_k A[m,k]·c_k
with the removable singularity at µ'=µ excised from A and added back as
its analytic limit.
"""
from __future__ import annotations

import math

import torch

from sos_rt_tpu_torch.config import MU0_RESONANCE_TOL, full_precision_matmul
from sos_rt_tpu_torch.grids import neighbour_index

# i1c tile rows (NI, M, B); unused rows (other surface) stay zero
(T_DDA, T_DDR, T_DBA, T_DBR, T_UDA, T_UDR, T_RESDN,
 T_ROWA, T_ROWB, T_BC, T_ROWC, T_ROWBU,
 T_SCKDNA, T_SCKDNB, T_SCKDNC, T_SCKUPA, T_SCKUPB, T_SCKUPC,
 T_DMA, T_DMR, T_UMA, T_UMR, T_UBA, T_UBR, T_RESUP) = range(25)
NI_TILES = 32


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
    full_precision_matmul()
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
        e_dn_atm = et @ a_dn_atm.T                                 # (B, L, M-1)
        e_dn_aer = et @ a_dn_aer.T

        denom_u = mu_p[None, :] - mu_u[:, None]
        ratio_up = mu_p[None, :] / torch.where(denom_u == 0, 1.0, denom_u)
        sing_k = mue - M                     # local index of µ' == µ in mu_p
        sing_mask = torch.arange(M, device=dev)[None, :] == sing_k[:, None]
        a_up_atm = torch.where(sing_mask, 0.0, ratio_up * pm_atm[mue] * wg[None, :])
        a_up_aer = torch.where(sing_mask, 0.0, ratio_up * pm_aer[mue] * wg[None, :])
        e_up_atm = et @ a_up_atm.T
        e_up_aer = et @ a_up_aer.T
        pk_atm = torch.gather(pm_atm[mue], 1, sing_k[:, None])[:, 0]
        pk_aer = torch.gather(pm_aer[mue], 1, sing_k[:, None])[:, 0]
        wk = wg[sing_k]
        # µ=0 rows (down col M-1 uses P row M-1; up col M uses row M)
        e_dz_atm = et @ (pm_atm[M - 1] * wg)                       # (B, L)
        e_dz_aer = et @ (pm_aer[M - 1] * wg)
        e_uz_atm = et @ (pm_atm[M] * wg)
        e_uz_aer = et @ (pm_aer[M] * wg)

        def sck(a_atm, a_aer, ca, cr, tref):
            # the region surface constant Σ_k A[m,k]·ck(region): (B, M-1)
            ck = ck_of(tref)
            return ca * (ck @ a_atm.T) + cr * (ck @ a_aer.T)

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
    tau_iu1 = gather(neighbour_index(idx_up - 1, L))
    tau_iu = gather(idx_up)
    tau_id = gather(idx_down)
    tau_id1 = gather(neighbour_index(idx_down + 1, L))
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
    # the pure-atm coefficients assume idx_down <= L-2; the mega engine
    # hands a batch whose layer reaches the bottom layer to the fused
    # engine (fused.layer_reaches_ground)
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
