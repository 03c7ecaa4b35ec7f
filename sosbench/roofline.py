"""The operations and bytes that a cell's inputs need, for the rooflines.

Each count is of the work these columns need, whatever implements it:
each column's own order count times the work of one column-order, plus
its I₁ once; never the orders of a block's or a batch's slowest column,
nor the padding of a width.  The least time is the larger of operations
over the peak rate of their type and bytes over the memory rate
(``card.py``), and names which of the two bounds it.
"""
from __future__ import annotations

import numpy as np

from sosbench.card import HBM_BYTES_PER_S, PEAK_OPS, SPLIT_PASSES


def _further_orders(n_orders) -> int:
    return int((np.asarray(n_orders, dtype=np.int64) - 1).sum())


def source_flops(n_orders, L: int, width: int, passes: int) -> int:
    """Jₙ's products: per column and further order, the (L, 2w) field
    times the two species' (2w, 2w) operators, each bf16 pass of the split
    mode counted (2·L·2w·4w per pass)."""
    return 2 * 4 * width * 2 * width * L * passes * _further_orders(n_orders)


def i1_flops(columns: int, L: int, width: int, passes: int) -> int:
    """I₁'s Lambertian surface product, once per column (K = w)."""
    return 2 * 4 * width * width * L * passes * columns


def least_s(flops: float, nbytes: float, op_type: str):
    t_ops, t_bytes = flops / PEAK_OPS[op_type], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stream_products(n_orders, L: int, width: int, mm: str):
    """(least s, bound) of the streamed route's tensor-core products over
    columns with counts ``n_orders``: every further order's source product
    and every column's I₁ product, against reading each product's field
    and writing its result (4-byte values)."""
    passes = SPLIT_PASSES[mm]
    cols = len(n_orders)
    flops = source_flops(n_orders, L, width, passes) + i1_flops(cols, L, width, passes)
    nbytes = 2 * L * 2 * width * 4 * (_further_orders(n_orders) + cols)
    return least_s(flops, nbytes, "bf16")


def mega(n_orders, L: int, width: int, mm: str, itemsize: int = 4):
    """(least s, bound) of one resident solve (``sos_mega``) of columns with
    counts ``n_orders``: the source product of every further order and
    I₁'s product once a column, against the compulsory bytes (22 pack rows
    a column, the I₁ tiles, the column parameters, the operators, four
    summary rows and the stats)."""
    passes = SPLIT_PASSES[mm]
    C = len(n_orders)
    nsplit = 2 if mm != "highest" else 1
    flops = source_flops(n_orders, L, width, passes) + i1_flops(C, L, width, passes)
    nbytes = itemsize * (22 * L * C + 25 * C * width + 2 * C + 4 * C * width + 3 * C
                         + nsplit * (8 * width * width + 4 * width * width + width * width))
    return least_s(flops, nbytes, "bf16")


def fused_source(n_orders, L: int, width: int, mm: str, launches: int):
    """(least s, bound) of the fused engine's split-mode source kernel over
    columns with counts ``n_orders``: every further order's product,
    against reading the field and writing Jₙ (4-byte values) and, once a
    launch, the operators' two bf16 parts ((2w, 4w) each)."""
    passes = SPLIT_PASSES[mm]
    flops = source_flops(n_orders, L, width, passes)
    nbytes = 2 * L * 2 * width * 4 * _further_orders(n_orders) + launches * 2 * (2 * width) * (4 * width) * 2
    return least_s(flops, nbytes, "bf16")
