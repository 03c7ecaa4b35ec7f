"""Each roofline's operation count against chip_smoke.py's formulas at the
canonical block (L = 800, 128 columns, width 504 = the padded 501)."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from sosbench import roofline
from sosbench.card import HBM_BYTES_PER_S, PEAK_OPS, SPLIT_PASSES

L, C, MP = 800, 128, 504


def test_peaks_are_chip_smokes():
    assert PEAK_OPS == chip_smoke.PEAK_OPS and HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert SPLIT_PASSES == chip_smoke.SPLIT_PASSES


@pytest.mark.parametrize("mm", ["bf16x3", "bf16x5"])
def test_stream_products_count(mm):
    """Every column at n orders: I₁'s product once and n − 1 source
    products, as passI's and passA's product_flops count a block."""
    ops = SimpleNamespace(mm=mm, lamb=True)
    n = 17
    want = (chip_smoke.product_flops("passI", L, C, MP, ops)
            + (n - 1) * chip_smoke.product_flops("passA", L, C, MP, ops))
    passes = SPLIT_PASSES[mm]
    got = (roofline.source_flops(np.full(C, n), L, MP, passes)
           + roofline.i1_flops(C, L, MP, passes))
    assert got == want
    least, bound = roofline.stream_products(np.full(C, n), L, MP, mm)
    assert bound == "operations" and least == pytest.approx(want / PEAK_OPS["bf16"])


def test_counts_each_columns_own_orders():
    """A column that stopped early adds only its own orders."""
    one = roofline.source_flops([10], L, MP, 3)
    assert roofline.source_flops([10, 4], L, MP, 3) == one + one * 3 // 9


def test_mega_is_mega_bound_ms():
    ops = SimpleNamespace(mm="bf16x3", lamb=True)
    n = torch.tensor(np.random.default_rng(0).integers(3, 20, 4096))
    want_ms, want_bound = chip_smoke.mega_bound_ms(n, 128, 64, ops, 4)
    got_s, got_bound = roofline.mega(n.numpy(), 128, 64, "bf16x3")
    assert got_s * 1e3 == pytest.approx(want_ms) and got_bound == want_bound


def test_fused_source_is_source_bound_ms():
    """One launch over B = 64 columns (rows = B·L) of the canonical grid,
    each column one further order: source_bound_ms's operations."""
    B, M = 64, 501
    wcopy = SimpleNamespace(numel=lambda: 2 * (2 * M) * (4 * M))
    want_ms, want_bound = chip_smoke.source_bound_ms(B * L, M, wcopy, "bf16x3")
    got_s, got_bound = roofline.fused_source(np.full(B, 2), L, M, "bf16x3", 1)
    assert got_bound == want_bound == "operations"
    assert got_s * 1e3 == pytest.approx(want_ms)
