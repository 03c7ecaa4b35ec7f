"""The split-mode Jₙ source of the fused and reference engines.

In float32 'bf16x3' / 'bf16x5' the JAX package computes each order's source

    Jₙ[b, l] = in_layer ? w_atm·(α_atm/4)·P_atm + w_aer·(α_aer/4)·P_aer
                        : (α_atm/4)·P_atm,      P_s = [I↓ | I↑][b, l] @ A_s

with split products on the TPU's matrix unit, outside any Pallas kernel
(``sos_rt_tpu/ops/precision.py::make_split_dot`` in ``sos_rt_tpu/fused.py``'s
``source_fn`` and ``sos_rt_tpu/solver.py``'s ``dot_atm`` / ``dot_aer``).
:func:`fused_source` is a wrapper: on a CUDA tensor it launches the
hand-written tensor-core kernel of ``csrc/fused_source.cu`` (or raises) and
adds one to its ``launches`` count; on a CPU tensor it runs
:func:`fused_source_plain`, the fused engine's composition (the four operator
blocks' split products and the mixing), which is also what the kernel is
held against on the card.

Both read the operator as :func:`source_copy` makes it: the stacked operator
W of ``megakernel.stack_source_operator`` (rows [atm_dn; atm_up; aer_dn;
aer_up], each block zero-padded to Mp), split into exact bf16 (hi, lo) and
laid out by ``megakernel.tc_operator`` as (2, 4Mp, Kp); and the per-column
inputs of :func:`source_columns`.  :func:`mix_source` is the mixing, which
the engines' full-precision products share.
"""
from __future__ import annotations

import torch

from sos_rt_tpu_torch.ops import cuda_build
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.ops.precision import split_dot, split_operand

_MODE_CODE = {"bf16x3": 1, "bf16x5": 2}     # MM_BF16X3, MM_BF16X5 of sos_tiles.cuh
SPLIT_MODES = tuple(_MODE_CODE)


def source_copy(a_atm, a_aer, nb_angles: int, mm: str):
    """The (2, 4Mp, Kp) bf16 copy of the stacked source operator, split in
    mode ``mm``, from the two species' (2M, 2M) float32 source operators
    (jₙ = Iₙ₋₁ @ A_s)."""
    return mk.tc_operator(*mk.stack_source_operator(a_atm, a_aer, nb_angles, mm,
                                                    torch.float32))


def source_columns(alb_atm, alb_aer, w_atm, w_aer, idx_up, idx_down, dtype):
    """The mixing's per-column inputs (coef, span): coef (4, B) of ``dtype``
    holds α_atm/4, α_aer/4, w_atm, w_aer; span (2, B) int32 the aerosol
    layer's first and last layer."""
    coef = torch.stack([alb_atm.to(dtype) / 4.0, alb_aer.to(dtype) / 4.0,
                        w_atm.to(dtype), w_aer.to(dtype)]).contiguous()
    span = torch.stack([idx_up, idx_down]).to(torch.int32).contiguous()
    return coef, span


def mix_source(p_atm, p_aer, cols):
    """Jₙ (B, L, 2M) from the two species' products P_s (B, L, 2M): (α/4)·P
    each, blended with the weights inside the aerosol layer."""
    coef, span = cols
    c = lambda i: coef[i][:, None, None]
    jn_atm = c(0) * p_atm
    jn_aer = c(1) * p_aer
    t = torch.arange(p_atm.shape[1], device=p_atm.device)
    in_layer = ((t >= span[0][:, None]) & (t <= span[1][:, None]))[..., None]
    return torch.where(in_layer, c(2) * jn_atm + c(3) * jn_aer, jn_atm)


def operator_blocks(wcopy, nb_angles: int):
    """The four (M, 2M) operator blocks A_atm[:M], A_atm[M:], A_aer[:M],
    A_aer[M:] (jₙ = I↓ @ A_s[:M] + I↑ @ A_s[M:]) as float32 (hi, lo) pairs,
    read back from the copy."""
    m, mp = nb_angles, wcopy.shape[1] // 4
    w = wcopy.float()
    blocks = []
    for s in range(2):
        rows = torch.cat([w[:, 2 * s * mp:2 * s * mp + m],
                          w[:, (2 * s + 1) * mp:(2 * s + 1) * mp + m]], dim=1)
        for kb in range(2):
            blk = rows[:, :, kb * mp:kb * mp + m].transpose(1, 2).contiguous()
            blocks.append((blk[0], blk[1]))
    return blocks


def fused_source_plain(dn, up, wcopy, cols, mm: str):
    """Jₙ (B, L, 2M) from the previous order's halves dn, up (B, L, M) as the
    fused engine composes it: each half split once, four split products a
    pass (``ops/precision.py::split_dot``), summed over the halves, then
    :func:`mix_source`."""
    blocks = operator_blocks(wcopy, dn.shape[-1])
    xd, xu = (split_operand(x, mm, torch.float32) for x in (dn, up))
    p_atm = split_dot(xd, *blocks[0], mm) + split_dot(xu, *blocks[1], mm)
    p_aer = split_dot(xd, *blocks[2], mm) + split_dot(xu, *blocks[3], mm)
    return mix_source(p_atm, p_aer, cols)


def _row_stride(x) -> int:
    """The stride between consecutive (column, layer) rows of a (B, L, M)
    half with contiguous angles: M or 2M floats for the engines' halves."""
    B, L, _ = x.shape
    if x.stride(2) != 1:
        raise ValueError(f"a half must have contiguous angles; strides {x.stride()}")
    if L == 1:
        return x.stride(0)
    if B > 1 and x.stride(0) != L * x.stride(1):
        raise ValueError(f"a half's rows must be evenly spaced; strides {x.stride()}")
    return x.stride(1)


def fused_source(dn, up, wcopy, cols, mm: str):
    """The split-mode Jₙ (B, L, 2M), float32, from the halves dn, up
    (B, L, M) of the previous order: views with contiguous angles and evenly
    spaced rows (a (B, L, M) field, or a half of a (B, L, 2M) one).  On the
    card one launch of ``sos_fused_source`` (csrc/fused_source.cu): passA's
    tensor-core mainloop (``csrc/quad_mma.cuh``) over ``wcopy``
    (:func:`source_copy`), bound by its operations; on the CPU
    :func:`fused_source_plain`."""
    if not dn.is_cuda:
        return fused_source_plain(dn, up, wcopy, cols, mm)
    coef, span = cols
    B, L, M = dn.shape
    mp = mk.pad_angles(M)
    if mm not in _MODE_CODE:
        raise ValueError(f"the source kernel takes the split modes {SPLIT_MODES}; "
                         f"got {mm!r}")
    if up.shape != dn.shape or dn.dtype != torch.float32 or up.dtype != torch.float32 \
            or up.device != dn.device:
        raise ValueError(f"the halves must be float32 (B, L, M) on one device; got "
                         f"{tuple(dn.shape)} {dn.dtype}, {tuple(up.shape)} {up.dtype}")
    kp = wcopy.shape[-1]
    if (wcopy.dtype != torch.bfloat16 or tuple(wcopy.shape[:2]) != (2, 4 * mp)
            or kp < 2 * mp or kp % mk.TC_K_TILE or not wcopy.is_contiguous()
            or wcopy.device != dn.device):
        raise ValueError(f"the operator copy {tuple(wcopy.shape)} {wcopy.dtype} does not "
                         f"fit M = {M} (Mp = {mp})")
    if (coef.shape != (4, B) or coef.dtype != torch.float32 or span.shape != (2, B)
            or span.dtype != torch.int32 or not coef.is_contiguous()
            or not span.is_contiguous() or coef.device != dn.device
            or span.device != dn.device):
        raise ValueError("coef (4, B) float32 and span (2, B) int32, contiguous on the "
                         "halves' device, must fit the batch; got "
                         f"{tuple(coef.shape)}, {tuple(span.shape)}")
    ld_dn, ld_up = _row_stride(dn), _row_stride(up)
    jn = torch.empty((B, L, 2 * M), dtype=torch.float32, device=dn.device)
    lib = cuda_build.library("fused_source")
    with torch.cuda.device(dn.device):  # the launch acts on the current device
        cuda_build.check(lib.sos_fused_source(
            _MODE_CODE[mm], dn.data_ptr(), up.data_ptr(), ld_dn, ld_up, wcopy.data_ptr(),
            kp, coef.data_ptr(), span.data_ptr(), jn.data_ptr(), B, L, M, mp,
            torch.cuda.current_stream(dn.device).cuda_stream), "sos_fused_source")
    fused_source.launches += 1
    return jn


fused_source.launches = 0
KERNELS = (fused_source,)
