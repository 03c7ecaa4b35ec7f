"""Matmul precision modes (counterpart of ``sos_rt_tpu/ops/precision.py``).

    a ≈ a_hi + a_lo,   x ≈ x₁ + x₂ (+ x₃)          (exact bf16 parts)
    a@x ≈ a_hi@x₁ + a_hi@x₂ + a_lo@x₁              (bf16x3)
        ≈ ... + a_hi@x₃ + a_lo@x₂                   (bf16x5)

The operator split here is computed by INTEGER mantissa masking,
``(bits + 0x8000) & 0xFFFF0000`` on the float32 bit pattern: round to
nearest with ties AWAY from zero.  It is not ``.to(torch.bfloat16)``,
which rounds ties to even; the operand split inside the kernels
(``ops/megastream.py``) is the round-half-even one, as in the TPU
package; the split-mode source kernel (``ops/fused_source.py``) splits its
operand as here.  A float round-trip form of this split can be folded to zero by
a compiler that allows excess precision; the integer form cannot.
"""
from __future__ import annotations

import torch


def _hi_f32(a: torch.Tensor) -> torch.Tensor:
    bits = a.view(torch.int32)
    return ((bits + 0x8000) & -65536).view(torch.float32)  # -65536 == 0xFFFF0000


def split_bf16(a):
    """Exact bf16 (hi, lo) split of a float32 tensor (ties away)."""
    a = torch.as_tensor(a).to(torch.float32).contiguous()
    hi_f = _hi_f32(a)
    return hi_f.to(torch.bfloat16), (a - hi_f).to(torch.bfloat16)


def split_bf16_3(a):
    """Exact bf16 (x1, x2, x3) split of a float32 tensor (x1+x2+x3 == a);
    both levels use the integer-masked rounding."""
    a = torch.as_tensor(a).to(torch.float32).contiguous()
    hi_f = _hi_f32(a)
    x2, x3 = split_bf16(a - hi_f)
    return hi_f.to(torch.bfloat16), x2, x3


def split_operand(x, mm: str, dtype):
    """x's exact bf16 parts in split mode ``mm`` as ``dtype``: (x1, x2) for
    'bf16x3', (x1, x2, x3) for 'bf16x5'."""
    split = split_bf16_3 if mm == "bf16x5" else split_bf16
    return tuple(p.to(dtype) for p in split(x))


def split_dot(xs, hi, lo, mm: str):
    """x @ a in split mode ``mm`` from x's parts ``xs`` (:func:`split_operand`)
    and a's (hi, lo) as float tensors."""
    if mm == "bf16x5":
        x1, x2, x3 = xs
        return x1 @ hi + x2 @ hi + x1 @ lo + x3 @ hi + x2 @ lo
    x1, x2 = xs
    return x1 @ hi + x2 @ hi + x1 @ lo


def make_split_dot(a, mm: str, dtype):
    """Return ``dot(x) ≈ x @ a`` in split mode ``mm`` ('bf16x3' or
    'bf16x5'); ``a`` is split once when the closure is built."""
    hi, lo = (p.to(dtype) for p in split_bf16(a))
    return lambda x: split_dot(split_operand(x, mm, dtype), hi, lo, mm)
