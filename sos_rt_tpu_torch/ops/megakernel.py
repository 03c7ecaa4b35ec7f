"""The resident whole-loop kernel, and the host helpers and shared tile
math of the whole-solve mega path.

Counterpart of ``sos_rt_tpu/ops/megakernel.py``: the row-index constants,
``slot_for``, ``pad_angles``, ``mega_supported``, ``band_covers_small``,
``build_static_operators`` (and its parts, with the stencil as taps:
``stencil_taps``), ``_pad_blocks``, ``stack_source_operator``, plain-torch
versions of the tile math the passes share (``_dot3``, ``_smooth_up``,
``band_fix_tile``, ``ratio_rows_tile``, ``make_i1_block``), and
:func:`mega_call`, the whole order loop of a batch in one kernel launch
(``csrc/megakernel.cu``) with its plain version :func:`mega_plain`.

The host helpers return the TPU package's operator shapes (angles padded
to Mp = pad_angles(M), zero rows/columns beyond the real M), so they
compare array-equal with it.  The tile math works on the port's layout,
which keeps ANGLES LAST: a tile is (..., Mp) with any leading (layer,
column) axes, and a product with an (R, Mp) operator contracts the last
axis.
"""
from __future__ import annotations

import numpy as np
import torch

from sos_rt_tpu_torch.ops import cuda_build
from sos_rt_tpu_torch.ops.precision import split_bf16
from sos_rt_tpu_torch.ops.sweeps import SMOOTH_TOL, SweepStencils
from sos_rt_tpu_torch.ops import first_order as fo

SLOT_CAP = 32      # hard cap on polyfit band slots (band_max ≤ 32)


def slot_for(band_max: int) -> int:
    """Padded polyfit band slots: the stencil operators are (4·SLOT, Mp)
    and (Mp, SLOT); SLOT tracks the grid's band need (band_max =
    int(0.06·M), e.g. 3 for M=64, 30 for M=501)."""
    return max(8, -(-band_max // 8) * 8)


# pack row indices (per layer × column scalars); rows 11+ are the
# in-kernel-I₁ per-layer scalars (first_order_mega_inputs pack_rows)
(PK_TAU, PK_HDT_DN, PK_HDT_UP, PK_COEF_ATM, PK_COEF_AER,
 PK_CDN, PK_CUP, PK_GS, PK_R1, PK_R2, PK_CHOICE,
 PK_ABDN, PK_ASDN, PK_ABUP, PK_ASUP, PK_ASTAR, PK_E0T, PK_ES0T,
 PK_E0RDN, PK_ESRDN, PK_E0RUP, PK_ESRUP, PK_REGION) = range(23)
PK_W = 24
I1_PACK_KEYS = ("abdn", "asdn", "abup", "asup", "astar", "e0t", "es0t",
                "e0rdn", "esrdn", "e0rup", "esrup", "region")

# cpar row indices (per column scalars)
CP_GRD = 0
CP_CONST = 1       # I₁ Lambertian surface constant ρ·e^{-τ*/µ0}/4
CP_W = 8

# colc row indices (per-angle constants); RC_MUUP holds the raw up-µ
# values (the smoothing blend weight is µ_k/µ_idx); RC_PKA/RC_PKR are the
# excised-singularity columns pm[µ'=µ]·w of first_order_mega_inputs
(RC_EMU_DN, RC_EMU_UP, RC_IVDN, RC_IVUP, RC_MUUP,
 RC_PKA, RC_PKR) = range(7)
RC_H = 5

# stats row indices (per column outputs)
ST_N, ST_CONV, ST_RATIO = range(3)
ST_H = 8

BIGF = 1e9


def pad_angles(m: int) -> int:
    """Padded angle count (a multiple of 8, as in the TPU package)."""
    return -(-m // 8) * 8


def mega_supported(grid, stencils: SweepStencils,
                   allow_small: bool = False) -> bool:
    """Static eligibility: the polyfit band must fit the slots; grids with
    small-µ columns need ``allow_small=True``, granted by the per-column
    band-coverage check (parallel.mesh.mega_small_ok)."""
    return ((stencils.small_cols.size == 0 or allow_small)
            and stencils.band_max <= SLOT_CAP)


def band_covers_small(stencils: SweepStencils, choice: int) -> bool:
    """True when band variant ``choice`` overwrites every small-µ column
    (SOS_Aer_In_limit.py:113-141), so the windowed/Taylor small-µ values
    are discarded and the mega path may skip them."""
    if stencils.small_cols.size == 0:
        return True
    band = stencils.bands[choice]
    m = stencils.nb_angles
    return (bool(stencils.poly_mask[choice][:band].all()) and band >= 1
            and int(stencils.small_cols.min()) >= m - band)


def _split_op(a, mm: str, dtype, device):
    """An operator as (hi, lo): the exact bf16 split for the split modes,
    (the operator, a (1, 1) zero) for 'highest'."""
    if mm != "highest":
        return tuple(p.to(device) for p in split_bf16(torch.as_tensor(a)))
    return (torch.as_tensor(a, dtype=dtype, device=device),
            torch.zeros((1, 1), dtype=dtype, device=device))


def band_validity(stencils: SweepStencils, m: int) -> np.ndarray:
    """pvt (4, Mp): 1 on the rows band variant c places (row m-1-i for a
    valid target i), else 0."""
    pvt = np.zeros((4, pad_angles(m)))
    n = min(stencils.band_max, m)
    pvt[:, m - n:m] = stencils.poly_mask[:, :n][:, ::-1]
    return pvt


def bc_matrix(surface: str, w_mu: np.ndarray, mu: np.ndarray, m: int) -> np.ndarray:
    """Surface BC (Mp, Mp): bc_up = grd · (bcmat · fv_dn)."""
    mp = pad_angles(m)
    bcmat = np.zeros((mp, mp))
    if surface == "lambertian":
        bcmat[:m, :m] = (-2.0 * w_mu[:m] * mu[:m])[None, :]
    else:  # specular mirror: up row j ← down row m-1-j (j ≥ 1)
        for j in range(1, m):
            bcmat[j, m - 1 - j] = 1.0
    return bcmat


def angle_rows(mu: np.ndarray, m: int) -> np.ndarray:
    """The per-angle rows (RC_H, Mp) in RC_* order; pad angles are 0."""
    mu_dn_safe = np.where(mu[:m] == 0, -1.0, mu[:m])
    mu_up = mu[m:].copy()
    mu_up_safe = np.where(mu_up == 0, 1.0, mu_up)
    colc = np.zeros((RC_H, pad_angles(m)))
    colc[RC_EMU_DN, :m] = 1.0 / mu_dn_safe
    colc[RC_EMU_UP, :m] = -1.0 / mu_up_safe
    colc[RC_IVDN, :m] = 1.0 / mu_dn_safe
    ivup = 1.0 / mu_up_safe
    ivup[0] = 0.0     # µ=0⁺ row: gs·ivup ≡ 0 → I(µ=0)=Jₙ rides exactly
    colc[RC_IVUP, :m] = ivup
    colc[RC_MUUP, :m] = mu_up
    return colc


def stencil_taps(stencils: SweepStencils, mm: str, dtype, device="cpu"):
    """The band stencil — the rows of the TPU package's (4·SLOT, Mp)
    ``wall`` operator — as its ≤ 6 taps per row: (columns int32, hi, lo),
    each (4·SLOT, 6), split as ``wall`` is (lo is 0 in mode 'highest').
    Zero-weight taps read column 0."""
    slot = slot_for(stencils.band_max)
    w = np.zeros((4, slot, 6))
    w[:, :stencils.band_max] = stencils.poly_w
    cols = np.where(w != 0, stencils.poly_src[:, None, :], 0).reshape(4 * slot, 6)
    w = w.reshape(4 * slot, 6)
    if mm == "highest":
        hi = torch.as_tensor(w, dtype=dtype, device=device)
        lo = torch.zeros_like(hi)
    else:
        hi, lo = (p.to(dtype=dtype, device=device) for p in split_bf16(w))
    return torch.as_tensor(cols, dtype=torch.int32, device=device), hi, lo


def build_static_operators(grid, stencils: SweepStencils, surface: str,
                           w_mu: np.ndarray, dtype, mm: str, device="cpu"):
    """Host-built constant matrices (angle-major forms, TPU package shapes).

    All operators are built at the padded angle count mp = pad_angles(m)
    with zero rows/columns beyond the real m: pad field rows stay exactly
    0 through every stage (attenuations exp(0)=1 via zero emu rows,
    sources and operator contributions 0).  Returns a dict: 'wall',
    'place', 'bcmat' as (hi, lo) pairs, 'pvt' (4, Mp), 'colc' (RC_H, Mp,
    128) lane-replicated as in the TPU package.  The streamed solve reads
    the stencil as taps (:func:`stencil_taps`) and the other parts from
    the helpers above; the dense forms are kept to be compared with the
    TPU package's.
    """
    m = grid.nb_angles
    mp = pad_angles(m)
    mu = np.asarray(grid.mu(), np.float64)
    slot = slot_for(stencils.band_max)

    # polyfit stencil: polys = wall_T (4·slot, Mp) · fv_dn;
    # placed = place_T (Mp, slot) · band
    wall_t = np.zeros((4 * slot, mp))
    for c in range(4):
        b = stencils.bands[c]
        src = stencils.poly_src[c]
        w = stencils.poly_w[c]
        for i in range(b):
            for j in range(6):
                wall_t[c * slot + i, src[j]] += w[i, j]
    place_t = np.zeros((mp, slot))
    for i in range(min(slot, m)):
        place_t[m - 1 - i, i] = 1.0
    colc = np.repeat(angle_rows(mu, m)[:, :, None], 128, axis=2)

    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return {"wall": _split_op(wall_t, mm, dtype, device),
            "place": _split_op(place_t, mm, dtype, device),
            "bcmat": _split_op(bc_matrix(surface, w_mu, mu, m), mm, dtype, device),
            "pvt": as_t(band_validity(stencils, m)), "colc": as_t(colc)}


def _pad_blocks(w, m: int, mp: int, row_blocks: int, col_blocks: int):
    """Zero-pad a block matrix of (row_blocks·m, col_blocks·m) to
    (row_blocks·mp, col_blocks·mp), each m-block aligned at multiples of
    mp."""
    if m == mp:
        return w
    w = w.reshape(row_blocks, m, col_blocks, m)
    w = torch.nn.functional.pad(w, (0, mp - m, 0, 0, 0, mp - m))
    return w.reshape(row_blocks * mp, col_blocks * mp)


def stack_source_operator(a_atm, a_aer, nb_angles: int, mm: str, dtype):
    """The (4Mp, 2Mp) stacked Jₙ operator W from the two species' source
    operators A_s (2M, 2M) (jₙ = Iₙ₋₁ @ A_s row-major): output rows
    [atm_dn; atm_up; aer_dn; aer_up], blocks zero-padded to Mp."""
    m = nb_angles
    mp = pad_angles(m)
    w = torch.cat([a_atm.T, a_aer.T], dim=0)         # (4M, 2M): J = W·I
    w = _pad_blocks(w, m, mp, 4, 2)
    return _split_op(w, mm, dtype, w.device)


# --------------------------------------------------------------------------
# Plain tile math on the port's layout (angles last)
# --------------------------------------------------------------------------

def _dot3(hi, lo, x, *, mm: str, dtype):
    """Fixed operator (R, K) applied to x (..., K) → (..., R), in mode mm.

    'bf16x3': the operator comes pre-split into exact bf16 (hi, lo); x is
    split here by round-half-even bf16 rounding (as the TPU kernel's
    ``astype(bfloat16)``); three products hi·x₁ + hi·x₂ + lo·x₁, each
    exact in float32, summed in float32.  'bf16x5': x in three parts,
    five products.  'highest': one full-precision product (lo ignored).
    """
    if mm == "highest":
        return x @ hi.to(dtype).T
    h, l = hi.to(dtype).T, lo.to(dtype).T
    parts = split_parts(x, mm)
    out = parts[0] @ h
    for p in parts[1:]:
        out = out + p @ h
    for p in parts[:-1]:
        out = out + p @ l
    return out


def _smooth_up(v, m: int, muup):
    """µ→0⁺ smoothing walk on up-half tiles (..., Mp); ``m`` is the REAL
    angle count (rows ≥ m are inert pads), ``muup`` the (Mp,) raw up-µ
    row (colc RC_MUUP).

    Walk rows 1..m-3 for the first second difference ≤ 1e-4 and blend
    rows (0, idx) linearly in µ between v[0] and v[idx], with weight
    µ_k/µ_idx (main_lambertian.py:405-411)."""
    Mp = v.shape[-1]
    rowf = torch.arange(Mp, device=v.device, dtype=v.dtype)
    v1 = torch.roll(v, -1, dims=-1)      # v1[l] = v[l+1] (wrap masked below)
    v2 = torch.roll(v, -2, dims=-1)
    d = torch.abs(v - 2.0 * v1 + v2)
    ok = (d <= SMOOTH_TOL) & (rowf >= 1.0) & (rowf <= m - 3)
    first = torch.where(ok, rowf, BIGF).amin(dim=-1, keepdim=True)
    idxf = torch.clamp(first, max=m - 3) + 1.0
    idx = idxf.long()
    i_val = torch.gather(v, -1, idx)
    mu_idx = muup[idx]
    base = v[..., 0:1]
    weight = muup / mu_idx
    blended = (1.0 - weight) * base + weight * i_val
    do = (rowf >= 1.0) & (rowf < idxf)
    return torch.where(do, blended, v)


def split_parts(x, mm: str):
    """x as the parts the split modes multiply: [x] for 'highest', the
    round-half-even bf16 parts (x₁, x₂[, x₃]) otherwise (as _dot3 and the
    kernels split them)."""
    if mm == "highest":
        return [x]
    dtype = x.dtype
    x1 = x.to(torch.bfloat16).to(dtype)
    r1 = x - x1
    x2 = r1.to(torch.bfloat16).to(dtype)
    if mm == "bf16x5":
        return [x1, x2, (r1 - x2).to(torch.bfloat16).to(dtype)]
    return [x1, x2]


def add_terms(acc, hi, lo, parts, mm: str):
    """acc + (hi, lo)·x term by term, in the order the kernels add them
    (hi·x₁, hi·x₂[, hi·x₃], lo·x₁[, lo·x₂])."""
    if mm == "highest":
        return acc + hi * parts[0]
    for p in parts:
        acc = acc + hi * p
    for p in parts[:len(parts) - 1]:
        acc = acc + lo * p
    return acc


def split_sum(x, mm: str):
    """What a one-hot operator row gives in mode mm: x₁ + x₂ (+ x₃)."""
    parts = split_parts(x, mm)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def band_fix_tile(fv, choice, zero_mask, *, taps, pvt, mm: str, nb_angles: int):
    """µ→0⁻ polyfit-band fix on tiles (..., Mp): zero the µ=0⁻ (and pad)
    rows, evaluate the band variant ``choice`` (...,) selects from its
    stencil taps, and place it on the rows pvt marks valid.

    The stencil product W_c·fv has at most 6 nonzero taps per band row
    (SOS_Aer_In_limit.py:113-141), so it is summed tap by tap — the order
    the passB kernel sums them — instead of as the dense (4·SLOT, Mp)
    product of the TPU package; the band value is placed through the
    one-hot operator, i.e. as its split sum."""
    cols, t_hi, t_lo = taps                          # (4·SLOT, 6)
    slot = cols.shape[0] // 4
    fv = torch.where(zero_mask, 0.0, fv)
    parts = split_parts(fv, mm)
    rows = choice.long()[..., None] * slot + torch.arange(slot, device=fv.device)
    band = torch.zeros(rows.shape, dtype=fv.dtype, device=fv.device)
    for j in range(cols.shape[1]):
        col = cols[:, j].long()[rows]
        band = add_terms(band, t_hi[:, j][rows], t_lo[:, j][rows],
                         [torch.gather(p, -1, col) for p in parts], mm)
    band = split_sum(band, mm)
    n = min(slot, nb_angles)
    placed = torch.zeros_like(fv)
    placed[..., nb_angles - n:nb_angles] = torch.flip(band[..., :n], dims=(-1,))
    vsel = pvt[choice.long()]                        # (..., Mp)
    return torch.where(vsel > 0.5, placed, fv)


def ratio_rows_tile(new_top, tot_top, new_bot, tot_bot, real):
    """Convergence rows (main_lambertian.py:311): max ratio new/total over
    the TOA-up and surface-down tiles (C, Mp) → (C,); pad rows and
    zero-total entries are 0/0 and count as converged."""
    def div(a, b):
        ok = real & (b != 0)
        return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)

    return torch.maximum(div(new_top, tot_top).amax(dim=-1),
                         div(new_bot, tot_bot).amax(dim=-1))


def make_i1_block(til, emu_dn, ivup, row0, lastrow, constc, pka, pkr,
                  lamb: bool):
    """Closed-form I₁ (ops/first_order.py regrouped) on the port's layout.

    ``til(i)`` returns per-angle tile i broadcastable to (..., Mp);
    ``emu_dn``/``ivup``/``pka``/``pkr`` are (Mp,) rows; ``row0``/``lastrow``
    the µ=0⁺ and µ=0⁻+pad row masks; ``constc`` the Lambertian surface
    constant per column.  Returns ``i1_block(s, eout, et) -> (i1_down,
    i1_up)`` where ``s(row)`` gives pack row ``row`` broadcastable to
    (..., 1), ``eout`` the four (..., Mp) products of the stacked surface
    operator and ``et`` the e^{(τ−τ*)/µ′} tile."""

    def i1_block(s, eout, et):
        ca = 4.0 * s(PK_COEF_ATM)        # exact: coef rows are ca/4
        cr = 4.0 * s(PK_COEF_AER)
        reg = s(PK_REGION)
        in_a, in_b = reg < 0.5, reg < 1.5
        sel = lambda va, vb, vc: torch.where(in_a, va, torch.where(in_b, vb, vc))
        e0t, es0t = s(PK_E0T), s(PK_ES0T)
        clexp = lambda x: torch.exp(torch.clamp(x, max=0.0))
        # ---- down half (row M-1 = µ=0⁻: att terms masked off) ----
        attb = torch.where(lastrow, 0.0, clexp(s(PK_ABDN) * emu_dn))
        atts = torch.where(lastrow, 0.0, clexp(s(PK_ASDN) * emu_dn))
        dirn = ((ca * til(fo.T_DDA) + cr * til(fo.T_DDR))
                * (e0t - s(PK_E0RDN) * attb))
        dres = (ca * til(fo.T_DBA) + cr * til(fo.T_DBR)) * e0t * s(PK_ABDN)
        dirn = torch.where(til(fo.T_RESDN) > 0.5, dres, dirn)
        if lamb:
            rowsel = ca * eout[0] + cr * eout[1]
            sck = sel(til(fo.T_SCKDNA), til(fo.T_SCKDNB), til(fo.T_SCKDNC))
            surf = constc * (rowsel - atts * sck)
        else:
            surf = ((ca * til(fo.T_DMA) + cr * til(fo.T_DMR))
                    * (es0t - s(PK_ESRDN) * atts))
        before = sel(torch.zeros_like(attb), til(fo.T_ROWA), til(fo.T_ROWB))
        i1d = dirn + surf + before * attb
        # ---- up half (row 0 = µ=0⁺: att terms masked off) ----
        attbu = torch.where(row0, 0.0, clexp(s(PK_ABUP) * ivup))
        attsu = torch.where(row0, 0.0, clexp(s(PK_ASUP) * ivup))
        diru = ((ca * til(fo.T_UDA) + cr * til(fo.T_UDR))
                * (e0t - s(PK_E0RUP) * attbu))
        if lamb:
            rowsel = ca * eout[2] + cr * eout[3]
            sck = sel(til(fo.T_SCKUPA), til(fo.T_SCKUPB), til(fo.T_SCKUPC))
            lim = (ivup * et * (-s(PK_ASUP)) * (ca * pka + cr * pkr) * constc)
            surf = constc * (rowsel - attsu * sck) + lim
        else:
            surf = ((ca * til(fo.T_UMA) + cr * til(fo.T_UMR))
                    * (es0t - s(PK_ESRUP) * attsu))
            sres = (ca * til(fo.T_UBA) + cr * til(fo.T_UBR)) * es0t * (-s(PK_ASUP))
            surf = torch.where(til(fo.T_RESUP) > 0.5, sres, surf)
        before = sel(til(fo.T_ROWBU), til(fo.T_ROWC), til(fo.T_BC))
        i1u = diru + surf + before * attbu
        return i1d, i1u

    return i1_block


# --------------------------------------------------------------------------
# The resident whole-loop solve: one launch runs every order of a batch
# --------------------------------------------------------------------------

MAX_COLS_PER_TILE = 32      # most columns one thread block's tile may hold
MAX_RESIDENT_MP = 512       # the kernel's thread shapes cover Mp <= 512
MAX_TC_MP = 256             # the 256-thread block: its products may take the tensor cores
# the k-tile of the tensor-core products (BK of csrc/quad_mma.cuh and of
# csrc/mega_mma.cuh): their bf16 operator copies pad K with zeros to a
# multiple of it (tc_operator)
TC_K_TILE = 32


def tc_operator(hi, lo):
    """The bf16 copy of a split operator (hi, lo), each (N, K) and exact in
    bf16, that the tensor-core mainloop reads: (2, N, Kp) with [0] = hi and
    [1] = lo, rows k-contiguous as the operator's own (the B operand of a
    row-major A), K zero-padded to Kp, the next multiple of TC_K_TILE.  The
    conversion is lossless."""
    n, k = hi.shape
    kp = -(-k // TC_K_TILE) * TC_K_TILE
    out = torch.zeros((2, n, kp), dtype=torch.bfloat16, device=hi.device)
    out[0, :, :k] = hi
    out[1, :, :k] = lo
    return out


def default_cols_per_tile(mp: int) -> int:
    """Columns per thread block of the resident kernel: as many as pass B
    walks at once (one group of round32(Mp) threads per column in a block
    of 256 threads), one for wider grids."""
    group = -(-mp // 32) * 32
    return max(1, min(MAX_COLS_PER_TILE, 256 // group))


# The ablation flags of the TPU kernel (megakernel._mega_kernel's
# ``ablate``), in the order of their bits (AB_* in csrc/sos_tiles.cuh).
# Each cuts a stage out for timing attribution; results are wrong with any
# flag set.
ABLATE_FLAGS = ("noconv", "noi1", "nosrc", "noloops", "nopassA", "nopoly",
                "nopassB", "nobc", "nofin", "nosmooth", "noratio")
# the variants of tools/ablate_kernel.py, the ones csrc/mega_ablate.cuh builds
ABLATE_VARIANTS = (
    "noconv", "noconv,noi1", "noconv,nosrc", "noconv,noloops", "noconv,nopoly",
    "noconv,nosmooth", "noconv,nofin", "noconv,nobc", "noconv,noratio",
    "noconv,nopassA", "noconv,nopassB", "noconv,nosrc,noloops,nopoly,nofin",
    "noconv,nopassA,nopassB,noratio")


# the library of the ablated builds of each (dtype, mm): csrc/mega_ablate.cu,
# mega_ablate_f32.cu, mega_ablate_f64.cu
ABLATE_LIBRARIES = {(torch.float32, "bf16x3"): "mega_ablate",
                    (torch.float32, "highest"): "mega_ablate_f32",
                    (torch.float64, "highest"): "mega_ablate_f64"}


def ablate_flags(ablate: str) -> frozenset:
    """The set of flags of a comma-separated ``ablate`` string."""
    ab = frozenset(f for f in ablate.split(",") if f) if ablate else frozenset()
    unknown = sorted(ab - set(ABLATE_FLAGS))
    if unknown:
        raise ValueError(f"unknown ablate flags {unknown}; known: {ABLATE_FLAGS}")
    return ab


def ablate_mask(ablate: str) -> int:
    """The AB bit mask of an ``ablate`` string."""
    ab = ablate_flags(ablate)
    return sum(1 << i for i, f in enumerate(ABLATE_FLAGS) if f in ab)


def takes_tensor_cores(ops) -> bool:
    """Whether sos_mega runs its two products (I₁'s surface product, the Jₙ
    source product) on the tensor cores (csrc/mega_mma.cuh): float32 with a
    bf16 split ('bf16x3', 'bf16x5') and Mp ≤ MAX_TC_MP.  float64,
    'highest' and the 512-thread block (Mp > 256) keep the SIMT product."""
    return (ops.dtype == torch.float32 and ops.mm != "highest"
            and ops.mp <= MAX_TC_MP)


def tc_operands(ops, surface_product: bool = True):
    """(ws_tc, astk_tc): the bf16 operator copies (2, 4Mp, Kp) that
    sos_mega's tensor-core product reads, exactly where it takes the tensor
    cores (:func:`takes_tensor_cores`; astk_tc only for a Lambertian
    surface whose I₁ the kernel evaluates, ``surface_product``), else None:
    the kernel reads no copy there.  Raises where a
    copy the product needs is missing (StreamOps builds them on the card
    only): the kernel would refuse to launch, and nothing falls back to the
    SIMT product."""
    if not takes_tensor_cores(ops):
        return None, None
    surface_product = surface_product and ops.lamb
    need = [("ws_tc", 2 * ops.mp)] + ([("astk_tc", ops.mp)] if surface_product else [])
    for name, k in need:
        w = getattr(ops, name)
        kp = -(-k // TC_K_TILE) * TC_K_TILE
        if w is None or tuple(w.shape) != (2, 4 * ops.mp, kp) or w.dtype != torch.bfloat16:
            raise ValueError(f"the tensor-core product needs ops.{name} as a (2, "
                             f"{4 * ops.mp}, {kp}) bfloat16 copy; got "
                             f"{None if w is None else (tuple(w.shape), w.dtype)}")
    return ops.ws_tc, (ops.astk_tc if surface_product else None)


def mega_plain(pack, cpar, tiles, ops, *, tol: float, max_orders: int,
               full: bool, ablate: str = "", i1dn=None, i1up=None):
    """Plain PyTorch version of the whole-loop kernel for one block of C
    columns that share the loop: pack (PK_W, L, C), cpar (CP_W, C), tiles
    (NI, C, Mp), ``ops`` a megastream.StreamOps.

    The first order I₁ starts the fields and the totals: evaluated here
    (``passI_plain``), or the host's planes ``i1dn`` / ``i1up`` (L, C, Mp)
    where they are given (the tiles are then not read); the ratio is
    seeded at 2·tol and n at 1; while any column's ratio is ≥ tol and no
    column has reached ``max_orders``, one order runs pass A, the surface
    BC and pass B, adds the new fields to the totals of the columns still
    active, and renews those columns' ratio and n.  Returns (toa_dn,
    toa_up, srf_dn, srf_up (C, Mp), stats (3, C)), or with ``full``
    (itot_dn, itot_up (L, C, Mp), stats).

    ``ablate`` (any of ABLATE_FLAGS, comma-separated) cuts the stages the
    TPU kernel's flags cut: 'noconv' runs to ``max_orders`` with n counting
    every order, 'noi1' starts from 1 instead of I₁, 'nopassA' lets pass B
    read sdn = jₙ↑ = 0, 'nopassB' skips pass B with its BC and
    accumulation (the ratio is taken on the fields as they stand),
    'noratio' keeps the seed ratio; the others act inside the passes
    (megastream.passA_plain, passB_plain)."""
    from sos_rt_tpu_torch.ops import megastream as ms

    ab = ablate_flags(ablate)
    _, L, C = pack.shape
    Mp, dtype, dev = ops.mp, pack.dtype, pack.device
    if "noi1" in ab:
        fdn = fup = torch.ones((L, C, Mp), dtype=dtype, device=dev)
    elif i1dn is not None:
        fdn, fup = i1dn, i1up                                   # pre: host I₁
    else:
        fdn, fup = ms.passI_plain(pack, tiles, cpar, ops)       # pre: I₁
    sdn = jnup = torch.zeros_like(fdn)
    real = torch.arange(Mp, device=dev) < ops.nb_angles
    if full:
        itot = [fdn.clone(), fup.clone()]
        rows = lambda: (itot[0][0], itot[1][0], itot[0][L - 1], itot[1][L - 1])
    else:
        itot = [fdn[0].clone(), fup[0].clone(), fdn[L - 1].clone(), fup[L - 1].clone()]
        rows = lambda: tuple(itot)
    ratio = torch.full((C,), 2.0 * tol, dtype=dtype, device=dev)
    n = torch.ones((C,), dtype=dtype, device=dev)
    while (("noconv" in ab or bool((ratio >= tol).any()))
           and bool(n.max() < max_orders)):
        active = (ratio >= tol).to(dtype)
        a2 = active[:, None]
        if "nopassA" not in ab:
            sdn, jnup = ms.passA_plain(pack, fdn, fup, ops, ab=ab)
        if "nopassB" not in ab:
            fdn, fup = ms.passB_plain(pack, sdn, jnup, cpar, ops, ab=ab)  # BC + pass B
            if full:
                itot[0] += a2 * fdn
                itot[1] += a2 * fup
            else:
                for k, new in enumerate((fdn[0], fup[0], fdn[L - 1], fup[L - 1])):
                    itot[k] = itot[k] + a2 * new
        if "noratio" not in ab:
            _, tot_up, tot_dn, _ = rows()
            rnew = ratio_rows_tile(fup[0], tot_up, fdn[L - 1], tot_dn, real)
            ratio = torch.where(active > 0.5, rnew, ratio)
        n = n + (1.0 if "noconv" in ab else active)
    stats = torch.stack([n, (ratio < tol).to(dtype), ratio])
    return (*itot, stats)


def mega_call(pack, cpar, tiles, ops, *, tol: float, max_orders: int,
              full: bool, cols_per_tile: int | None = None, ablate: str = "",
              ablate_build: bool | None = None, i1dn=None, i1up=None):
    """The whole order loop of a batch in one kernel launch.  Replaces
    sos_rt_tpu/ops/megakernel.py::_mega_kernel (mega_call).

    pack (PK_W, L, C), cpar (CP_W, C), tiles (NI, C, Mp) hold the whole
    padded batch; every ``cols_per_tile`` columns run their own loop (a
    column's result does not depend on its tile).  On CUDA tensors this
    launches ``sos_mega`` (csrc/megakernel.cu) once, or raises; on CPU
    tensors it runs :func:`mega_plain` tile by tile.  Bound by the
    operations of the source product; one thread block per tile keeps the
    tile's four field planes in an L2-sized workspace and evaluates the
    loop condition itself, so the host never waits between orders.  In
    float32 'bf16x3' / 'bf16x5' with Mp ≤ 256 its two products run on the
    tensor cores from the bf16 operator copies (:func:`tc_operands`); those
    launches also count in ``mega_call.tc_launches``.
    Returns what :func:`mega_plain` returns, for all C columns.

    ``i1dn`` / ``i1up`` (L, C, Mp), the host's first order (the TPU
    kernel's ``i1dn_ref`` / ``i1up_ref``), start the loop in place of the
    kernel's own I₁: on a card ``sos_mega_i1in`` (the same body, its first
    step a copy of the tile's rows from the two planes), counted also in
    ``mega_call.i1in_launches``; it takes no ``ablate``.

    ``ablate`` (one of ABLATE_VARIANTS on a card; results are wrong)
    launches ``sos_mega_ablate`` (csrc/mega_ablate.cuh, one library a type
    and mode: ``ABLATE_LIBRARIES``), the same body with
    those stages cut out, as mega_plain(ablate=...) cuts them.
    ``ablate_build=True`` takes that library for ``ablate=""`` too: its
    build of the solve itself, which must equal sos_mega to the bit."""
    from sos_rt_tpu_torch.ops import megastream as ms

    _, L, C = pack.shape
    Mp = ops.mp
    cb = cols_per_tile or default_cols_per_tile(Mp)
    cb = min(cb, C)
    if C % cb:
        raise ValueError(f"batch {C} is not a multiple of the tile size {cb}")
    mask = ablate_mask(ablate)
    host_i1 = i1dn is not None
    if not pack.is_cuda:
        outs = [mega_plain(*ms.block_of(pack, cpar, tiles, i, cb), ops, tol=tol,
                           max_orders=max_orders, full=full, ablate=ablate,
                           **ms.i1_block_of(i1dn, i1up, i, cb))
                for i in range(C // cb)]
        # columns are axis 1 of the full planes and of stats, axis 0 of rows
        axis = lambda k: 1 if full or k == len(outs[0]) - 1 else 0
        return tuple(torch.cat([o[k] for o in outs], dim=axis(k))
                     for k in range(len(outs[0])))

    planes = (i1dn, i1up) if host_i1 else ()
    dt, mm, stream = ms._kernel_codes(ops, pack, cpar, tiles, *planes)
    if any(tuple(p.shape) != (L, C, Mp) for p in planes):
        raise ValueError(f"i1dn / i1up must be ({L}, {C}, {Mp}); got "
                         f"{[tuple(p.shape) for p in planes]}")
    if Mp > MAX_RESIDENT_MP or cb > MAX_COLS_PER_TILE:
        raise ValueError(f"the resident kernel takes Mp <= {MAX_RESIDENT_MP} and "
                         f"tiles of <= {MAX_COLS_PER_TILE} columns; got Mp={Mp}, "
                         f"cols_per_tile={cb}")
    if ablate_build is None:
        ablate_build = mask != 0
    if host_i1 and ablate_build:
        raise ValueError("the host-I1 kernel sos_mega_i1in takes no ablate flags")
    if host_i1:
        lib = cuda_build.library("megakernel")
        blocks_fn = lib.sos_mega_i1in_blocks
        launch = lambda *a: lib.sos_mega_i1in(i1dn.data_ptr(), i1up.data_ptr(), *a)
        name = "sos_mega_i1in"
    elif ablate_build:
        if mask and mask not in {ablate_mask(v) for v in ABLATE_VARIANTS}:
            raise ValueError(f"ablate={ablate!r} is not built; the variants are "
                             f"{ABLATE_VARIANTS}")
        source = ABLATE_LIBRARIES.get((ops.dtype, ops.mm))
        if Mp > 256 or source is None:
            raise ValueError("the ablated kernel takes Mp <= 256 and float32 'bf16x3' "
                             f"or 'highest' or float64; got Mp={Mp}, {ops.dtype}, "
                             f"mm={ops.mm!r}")
        lib = cuda_build.library(source)
        blocks_fn = lambda *a: lib.sos_mega_ablate_blocks(mask, *a)
        launch, name = (lambda *a: lib.sos_mega_ablate(mask, *a)), "sos_mega_ablate"
    else:
        lib = cuda_build.library("megakernel")
        blocks_fn, launch, name = lib.sos_mega_blocks, lib.sos_mega, "sos_mega"
    dev, dtype = pack.device, ops.dtype
    ws_tc, astk_tc = tc_operands(ops, surface_product=not host_i1)
    # the occupancy query, the shared-memory attribute and the launch act on
    # the current device
    with torch.cuda.device(dev):
        blocks = blocks_fn(dt, mm, Mp, ops.slot)
        if blocks <= 0:
            cuda_build.check(-blocks or 1, f"{name} blocks")
        nblocks = min(C // cb, blocks)
        work = torch.empty((nblocks, 4, L, cb, Mp), dtype=dtype, device=dev)
        counter = torch.zeros((1,), dtype=torch.int32, device=dev)
        shape = (L, C, Mp) if full else (C, Mp)
        outs = [torch.empty(shape, dtype=dtype, device=dev) for _ in range(2 if full else 4)]
        stats = torch.empty((3, C), dtype=dtype, device=dev)
        o = [t.data_ptr() for t in outs] + [0, 0]
        cols, t_hi, t_lo = ops.taps
        p = lambda t: t.data_ptr() if t is not None else None
        cuda_build.check(launch(
            dt, mm, int(ops.lamb), int(full), p(pack), p(cpar), p(tiles), p(ops.colc),
            p(ops.ws[0]), p(ops.ws[1]), p(ops.astk[0]), p(ops.astk[1]),
            p(ws_tc), p(astk_tc),
            p(cols), p(t_hi), p(t_lo), p(ops.pvt), p(ops.bct[0]), p(ops.bct[1]),
            p(work), p(counter), o[0], o[1], o[2], o[3], p(stats),
            L, C, cb, Mp, ops.nb_angles, ops.slot, nblocks, int(max_orders),
            float(tol), stream), name)
    mega_call.launches += 1
    mega_call.tc_launches += ws_tc is not None
    mega_call.i1in_launches += host_i1
    return (*outs, stats)


mega_call.launches = 0
# launches whose products ran on the tensor cores (csrc/mega_mma.cuh)
mega_call.tc_launches = 0
# launches of sos_mega_i1in, the first order given from the host
mega_call.i1in_launches = 0
