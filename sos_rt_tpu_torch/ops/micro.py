"""The per-op microbenchmark kernels and their plain versions.

Counterparts of the two Pallas TPU kernels of the JAX package's tools:
``tools/micro_ops.py::kern`` (k reps of one building block of the
resident kernel's passes over an (L, C, M2) = (128, 64, 128) float32
field) and ``tools/micro_pass.py::kern`` (K = 64 elementwise passes over
the same field, in one of four loop structures).  They measure what each
block costs on the card; ``sos_rt_tpu_torch.tools.micro_ops`` and
``micro_pass`` time them.

:func:`micro_ops_call` and :func:`micro_pass_call` launch the kernels of
``csrc/micro.cu`` on CUDA tensors (or raise) and count their launches; on
CPU tensors they run :func:`micro_ops_plain` / :func:`micro_pass_plain`,
which the kernels are held against on the card.

What the patterns compute, per row v of 128 lanes (a (layer, column)):

- ``fma`` v·1.0001 + 0.5; ``rowscalar`` and ``rowscalar_slice`` pk[3]·v +
  0.5; ``lanemask`` v·1.0001 on lanes < 64, else 0; ``tworefs`` v·1.0001 +
  b; ``exp`` exp(v·1e-3); ``lanebrd`` v·a2[0] + 0.5; each product and sum
  rounded separately, as the TPU computes them (the kernels are built with
  ``-fmad=false``);
- ``reduce`` v + Σ v, the sum taken as the kernel takes it (four lanes a
  thread, then a shuffle tree over 32 threads); ``roll`` v + v rolled by
  one lane (v[j] + v[(j+1) mod 128]);
- ``smooth`` the µ→0⁺ smoothing walk of the resident kernel on the up half
  (lanes 64–127, µ the up angles of GridSpec(64, 128)), the down half as
  it is (the JAX tool's ``_smooth_tile`` is gone from the JAX package);
- ``matmul`` v @ a2 in float32; ``matmul_high`` the bf16x3 product
  hi·x₁ + hi·x₂ + lo·x₁ and ``matmul_def`` the one-pass hi·x₁, where v =
  x₁ + x₂ and a2 = hi + lo are split into bf16 parts rounding half to
  even, as XLA splits both operands for Precision.HIGH (not with the
  port's ties-away operator split, ops/precision.py).  The plain version
  sums those exact bf16 products in float64 and rounds once; the kernel
  runs them on the tensor cores with float32 accumulators.

``tworefs`` reads a scratch that the TPU kernel never writes; in Pallas
interpret mode it reads NaN, and here it is filled with NaN.
"""
from __future__ import annotations

import numpy as np
import torch

from sos_rt_tpu_torch.config import GridSpec, full_precision_matmul
from sos_rt_tpu_torch.ops import cuda_build
from sos_rt_tpu_torch.ops.megakernel import _smooth_up

L, C, M2 = 128, 64, 128
M = M2 // 2
K1, K2 = 128, 1024       # micro_ops reps per call (the time is the slope)
K = 64                   # micro_pass passes per call
PATTERNS = ("fma", "rowscalar", "rowscalar_slice", "lanemask", "tworefs", "exp",
            "lanebrd", "reduce", "roll", "smooth", "matmul", "matmul_high",
            "matmul_def")
MODES = ("flat", "chunk", "static", "chunk2d")
# the (mode, g) pairs of the JAX tool's main(); g in layers
PASS_PAIRS = (("flat", L), ("chunk", 8), ("chunk", 16), ("chunk", 32),
              ("chunk2d", 8), ("chunk2d", 16),
              ("static", 8), ("static", 16), ("static", 32))
ROWS_PER_BLOCK = 64      # layers a thread block of the kernels holds


def make_inputs(seed: int = 0, device="cpu"):
    """(xs, pk, a2) drawn as ``tools/micro_ops.py::run`` draws them: four
    fields N(1, 1e-2) (L, C, M2), pk N(0, 1) (L, C, 16) and a2 N(0, 1)
    (M2, M2), float32."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    xs = [f32(rng.standard_normal((L, C, M2)) * 1e-2 + 1.0) for _ in range(4)]
    pk = f32(rng.standard_normal((L, C, 16)))
    a2 = f32(rng.standard_normal((M2, M2)))
    return xs, pk, a2


def mu_up(device="cpu") -> torch.Tensor:
    """The up µ of GridSpec(64, 128) (µ=0⁺ first), float32 (M,)."""
    return torch.as_tensor(GridSpec(M, L).mu()[M:], dtype=torch.float32, device=device)


def bf16_parts(x: torch.Tensor):
    """x = x₁ + x₂ + residual, both parts bf16 rounding half to even, as
    float32 tensors."""
    x1 = x.to(torch.bfloat16).to(torch.float32)
    return x1, (x - x1).to(torch.bfloat16).to(torch.float32)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _reduce_rows(v):
    """Σ v over the lanes, summed as the kernel sums it."""
    x = v.reshape(*v.shape[:-1], 32, 4)
    s = ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]          # (..., 32)
    lanes = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ o]
    return (x + s[..., None]).reshape(v.shape)


def _split_product(v, a2, passes: int):
    """v @ a2 from bf16 parts: hi·x₁ (+ hi·x₂ + lo·x₁ for 3 passes), each
    exact product summed in float64, rounded once to float32."""
    x1, x2 = (p.double() for p in bf16_parts(v))
    hi, lo = (p.double() for p in bf16_parts(a2))
    out = x1 @ hi
    if passes == 3:
        out = out + x2 @ hi + x1 @ lo
    return out.to(torch.float32)


def _one_rep(pat: str, v, pk, a2, mu):
    if pat == "fma":
        return v * 1.0001 + 0.5
    if pat in ("rowscalar", "rowscalar_slice"):
        return pk[..., 3:4] * v + 0.5
    if pat == "lanemask":
        lanes = torch.arange(M2, device=v.device)
        return torch.where(lanes < M, v * 1.0001, 0.0)
    if pat == "tworefs":
        return v * 1.0001 + torch.full_like(v, float("nan"))
    if pat == "exp":
        return torch.exp(v * 1e-3)
    if pat == "lanebrd":
        return v * a2[0] + 0.5
    if pat == "reduce":
        return _reduce_rows(v)
    if pat == "roll":
        return v + torch.roll(v, -1, dims=-1)
    if pat == "smooth":
        return torch.cat([v[..., :M], _smooth_up(v[..., M:], M, mu)], dim=-1)
    if pat == "matmul":
        return v @ a2
    if pat == "matmul_high":
        return _split_product(v, a2, 3)
    if pat == "matmul_def":
        return _split_product(v, a2, 1)
    raise ValueError(f"unknown pattern {pat!r}; one of {PATTERNS}")


def micro_ops_plain(pat: str, k: int, x, pk, a2):
    """k reps of pattern ``pat`` over the field x (L, C, M2)."""
    full_precision_matmul()
    mu = mu_up(x.device)
    a = x
    for _ in range(k):
        a = _one_rep(pat, a, pk, a2, mu)
    return a.clone() if k == 0 else a


def _check_pass(mode: str, g: int):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if mode != "flat" and (g < 8 or g % 8 or ROWS_PER_BLOCK % g
                           or (mode == "static" and g not in (8, 16, 32))):
        raise ValueError(f"mode {mode!r} takes g in 8, 16, 32 (layers a chunk); "
                         f"got {g}")


def micro_pass_plain(mode: str, g: int, x):
    """K passes of a ← a·1.0001 + 0.5 over x (every mode computes the same
    values)."""
    _check_pass(mode, g)
    a = x
    for _ in range(K):
        a = a * 1.0001 + 0.5
    return a


# --------------------------------------------------------------------------
# Wrappers: the CUDA kernel on a card, the plain version on the CPU
# --------------------------------------------------------------------------

def _check_field(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"micro kernel operand must be a contiguous float32 "
                             f"tensor on {dev}; got {t.dtype} on {t.device}")


def micro_ops_call(pat: str, k: int, x, pk, a2, split=None, mu=None):
    """k reps of pattern ``pat`` over x (L, C, M2), with pk (L, C, 16) and
    a2 (M2, M2), all float32.  Replaces tools/micro_ops.py::kern.  On CUDA
    tensors this launches ``sos_micro_ops`` (csrc/micro.cu): the field in
    shared memory over 128 blocks, bound by shared-memory bytes (the
    elementwise patterns) or by operations (the products).  ``split`` (the
    transposed bf16 parts of a2, :func:`split_a2`) and ``mu``
    (:func:`mu_up`) may be passed to keep their preparation out of a timed
    call."""
    if pat not in PATTERNS:
        raise ValueError(f"unknown pattern {pat!r}; one of {PATTERNS}")
    if tuple(x.shape) != (L, C, M2) or tuple(pk.shape) != (L, C, 16) \
            or tuple(a2.shape) != (M2, M2) or k < 0:
        raise ValueError(f"micro_ops takes x ({L}, {C}, {M2}), pk ({L}, {C}, 16), "
                         f"a2 ({M2}, {M2}) and k >= 0; got {tuple(x.shape)}, "
                         f"{tuple(pk.shape)}, {tuple(a2.shape)}, k={k}")
    if not x.is_cuda:
        return micro_ops_plain(pat, k, x, pk, a2)
    _check_field(x, pk, a2)
    hiT, loT = split if split is not None else split_a2(a2)
    mu = mu if mu is not None else mu_up(x.device)
    out = torch.empty_like(x)
    p = lambda t: t.data_ptr()
    lib = cuda_build.library("micro")
    with torch.cuda.device(x.device):
        cuda_build.check(lib.sos_micro_ops(
            PATTERNS.index(pat), int(k), p(x), p(pk), p(a2), p(hiT), p(loT), p(mu),
            p(out), torch.cuda.current_stream(x.device).cuda_stream), "sos_micro_ops")
    micro_ops_call.launches += 1
    return out


def split_a2(a2):
    """The bf16 parts (hi, lo) of a2, rounding half to even, each
    transposed and contiguous (the kernel's B operand is column-major)."""
    hi = a2.to(torch.bfloat16)
    lo = (a2 - hi.to(torch.float32)).to(torch.bfloat16)
    return hi.T.contiguous(), lo.T.contiguous()


def micro_pass_call(mode: str, g: int, x):
    """K passes of a ← a·1.0001 + 0.5 over x (L, C, M2) float32 in loop
    structure ``mode`` with chunks of ``g`` layers.  Replaces
    tools/micro_pass.py::kern.  On CUDA tensors this launches
    ``sos_micro_pass`` (csrc/micro.cu), bound by shared-memory bytes."""
    _check_pass(mode, g)
    if tuple(x.shape) != (L, C, M2):
        raise ValueError(f"micro_pass takes x ({L}, {C}, {M2}); got {tuple(x.shape)}")
    if not x.is_cuda:
        return micro_pass_plain(mode, g, x)
    _check_field(x)
    out = torch.empty_like(x)
    lib = cuda_build.library("micro")
    with torch.cuda.device(x.device):
        cuda_build.check(lib.sos_micro_pass(
            MODES.index(mode), int(g), x.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream), "sos_micro_pass")
    micro_pass_call.launches += 1
    return out


micro_ops_call.launches = micro_pass_call.launches = 0
KERNELS = (micro_ops_call, micro_pass_call)
