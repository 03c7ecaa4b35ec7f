"""The reference's one matrix product and its precision.

``mm(a, b)`` is ``a @ b`` in full precision (``PRODUCTS = "full"``, no TF32
on the card).  With ``PRODUCTS = "tf32"`` both operands of a float32
product are first rounded to TF32 (10 stored mantissa bits, to nearest,
ties away from zero, as the tensor cores convert them), and the product
then accumulates in float32: the control, the step below float32 that a
program might take.  Set it with :func:`products`.
"""
from __future__ import annotations

import contextlib

import torch

PRODUCTS = "full"


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)   # -8192 == 0xFFFFE000


def mm(a, b):
    if PRODUCTS == "tf32" and a.dtype == torch.float32:
        return to_tf32(a) @ to_tf32(b)
    return a @ b


@contextlib.contextmanager
def products(mode: str):
    """Run the reference's products in ``mode`` ('full' or 'tf32')."""
    global PRODUCTS
    if mode not in ("full", "tf32"):
        raise ValueError(f"unknown products mode {mode!r}")
    old, PRODUCTS = PRODUCTS, mode
    cuda = torch.backends.cuda.matmul
    old_tf32, cuda.allow_tf32 = cuda.allow_tf32, False
    try:
        yield
    finally:
        PRODUCTS, cuda.allow_tf32 = old, old_tf32
