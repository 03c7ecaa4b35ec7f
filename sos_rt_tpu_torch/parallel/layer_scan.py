"""Layer-axis (sequence-parallel) sharded affine scan.

Counterpart of ``sos_rt_tpu/parallel/layer_scan.py``.  The solver's
τ-axis recurrence S_t = a_t·S_{t-1} + b_t is a sequence dimension: with
the layers sharded contiguously over a mesh axis, each rank scans its
local shard, the per-shard affine compositions are combined with ONE
all-gather (the affine maps form a monoid: (a, b)∘(a', b') = (aa',
a'b + b')), and each rank applies its incoming carry locally.  The local
form, :func:`local_affine_scan`, is the one the layer-sharded solve
(``parallel/layer_sharded.py``) runs every order.
"""
from __future__ import annotations

import torch

from sos_rt_tpu_torch.ops.sweeps import _associative_scan
from sos_rt_tpu_torch.parallel.mesh import all_gather_rows, mesh_axis, mesh_device


def local_affine_scan(a_loc, b_loc, axis, reverse: bool = False):
    """S over this rank's shard of the layer axis (-2) of (..., rows, M)
    ``a_loc``, ``b_loc``, the shards in the order of ``axis`` = (process
    group, this rank's place, size) along the global layer axis.  The
    shard's pair-scan (A_t, B_t), S_t = B_t + A_t·S_in, is the solver's
    associative scan (``reverse`` flips, scans and flips back); the carry
    S_in folds the totals of the shards before this one (after it, with
    ``reverse``) from the identity (1, 0), as the TPU package folds them."""
    group, place, size = axis
    if reverse:
        a_loc, b_loc = a_loc.flip(-2), b_loc.flip(-2)
    A, B = _associative_scan(a_loc, b_loc)
    if reverse:
        A, B = A.flip(-2), B.flip(-2)
    edge = 0 if reverse else -1
    tots = all_gather_rows(torch.stack([A[..., edge, :], B[..., edge, :]]), group, size)
    tots = tots.reshape((size, 2) + tuple(A[..., edge, :].shape))
    carry_a = torch.ones_like(tots[0, 0])
    carry_b = torch.zeros_like(tots[0, 1])
    for k in (range(size - 1, place, -1) if reverse else range(place)):
        carry_a, carry_b = carry_a * tots[k, 0], carry_b * tots[k, 0] + tots[k, 1]
    return B + A * carry_b[..., None, :]


def sharded_affine_scan(a, b, mesh, axis: str = "data", reverse: bool = False):
    """S_t = a_t·S_{t-1} + b_t (S_{-1} = 0) with the LAYER axis (axis 0)
    sharded over ``mesh`` axis ``axis``; ``reverse=True`` computes
    S_t = a_t·S_{t+1} + b_t (the upward sweep direction).

    a, b: the global (L, ...) tensors, the same on every rank; L must be
    divisible by the axis size.  Each rank scans its contiguous shard on
    its device; returns the global S on every rank."""
    axis = mesh_axis(mesh, axis)
    group, place, size = axis
    L = a.shape[0]
    if L % size:
        raise ValueError(f"layer axis {L} not divisible by the mesh axis {size}")
    device = mesh_device(mesh)
    rows = slice(place * L // size, (place + 1) * L // size)
    flat = lambda x: torch.as_tensor(x, device=device).reshape(L, -1)[rows]
    s = local_affine_scan(flat(a), flat(b), axis, reverse=reverse)
    return all_gather_rows(s, group, size).reshape(b.shape)
