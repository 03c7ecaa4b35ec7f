#!/usr/bin/env python3
"""Drive the PyTorch port (sos_rt_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # about 40 s on an H100, the build included

Phases, one JSON line each on stdout:

1. ``card``      the card (nvidia-smi name and power limit), torch and CUDA
                 versions, and the seconds the kernels took to build.
2. ``kernels``   each kernel (passI, passA, passB) against its plain
                 PyTorch version on the card at GridSpec(56, 64), B=8:
                 float64 'highest' within 1e-12 of scale, float32
                 'bf16x3' and 'highest' within 1e-5 of scale (the
                 summation order differs).
3. ``slice_f64`` solve_batch(engine='mega') in float64 on the card against
                 the same solve on the CPU: equal order counts, rtol 1e-9.
4. ``canonical`` the main path at full width: the ``hg`` preset on the
                 501×800 grid, B=256 (two blocks of 128 columns), float32
                 bf16x3, summary outputs; the launch counts of this run;
                 8 of its columns against the same solve in float64 on the
                 card (equal order counts, p50 relative error of the
                 TOA/surface rows below 1e-3); then each kernel timed at
                 this run's block shapes beside its plain version, the
                 least time the card could take (bound_ms) and, for the
                 two products, one torch.matmul of the same shapes.
5. ``fwc_sweep`` the 64×128 FWC sweep preset at B=4096, float32,
                 sort='predict', through solve_batch; the launch counts of
                 this run; 8 of its columns against the same solve in
                 float64 on the card (as in ``canonical``); each kernel
                 against its plain version on the sweep's first block
                 (1024 columns) and on the predictor's 8×16 coarse block,
                 within 1e-4 of scale; each kernel timed on the first block.

Then the ``{"kernels": [...]}`` line (max_abs_err over both paths' blocks), the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no result.  Without CUDA, or without the
package beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "float32": 67e12, "float64": 67e12}
REPLACES = {
    "passI": "sos_rt_tpu/ops/megastream.py:222",
    "passA": "sos_rt_tpu/ops/megastream.py:85",
    "passB": "sos_rt_tpu/ops/megastream.py:128",
}
SOURCE = "sos_rt_tpu_torch/csrc/megastream.cu"
SPLIT_PASSES = {"bf16x3": 3, "bf16x5": 5, "highest": 1}
# kernel against plain at a main-path block, float32 bf16x3, relative to
# each output's largest magnitude: the kernel and cuBLAS sum the
# 3 * 2Mp split products of a passA output in another order, and the
# worst-case bound of such a float32 sum is 3 * 2Mp * 2**-24 of the sum of
# |terms| (the outputs are sums of terms of one sign): 1.8e-4 at the
# canonical Mp = 504, the largest; smaller at the 64x128 grid (2.3e-5) and
# the predictor's 8x16 grid (2.9e-6).
F32_KERNEL_TOL = 1e-4
# float32 against float64 on the same columns: p50 relative error of the
# TOA/surface rows (the float32 accumulation floor is ~2e-4)
F64_P50_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b) -> float:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def timed(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the card (CUDA events, after one
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_scenes(preset, batch: int, device, rng):
    """The preset's scene with (grd_alb, τ*_aer, ω_aer) drawn per column."""
    import dataclasses

    import torch

    from sos_rt_tpu_torch.parallel import broadcast_scene

    t = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, batch), device=device)
    return dataclasses.replace(broadcast_scene(preset.scene, batch, device=device),
                               grd_alb=t(0.0, 0.9), tau_star_aer=t(0.01, 0.4),
                               alb_aer=t(0.7, 1.0))


def test_tables(grid, device, dtype):
    from sos_rt_tpu_torch.solver import PhaseTables

    return PhaseTables.from_models(grid, 0.5, atm=("rayleigh", {}),
                                   aer=("hg", {"g": 0.7}), dtype=dtype,
                                   device=device)


def block_inputs(scenes, tables, grid, opts, device, cols_per_block=None):
    """(pack, cpar, tiles) of the first block and the per-solve operators."""
    from sos_rt_tpu_torch.fused import prepare_stream

    sb = prepare_stream(scenes, tables, grid, opts, cols_per_block=cols_per_block,
                        device=device)
    return sb.block(0), sb.ops


def kernel_vs_plain(pack, cpar, tiles, ops):
    """Run each kernel and its plain version on the same inputs (the plain
    chain feeds the next pass).  Returns {name: max relative error},
    {name: max absolute error} and the plain outputs."""
    import torch

    from sos_rt_tpu_torch.ops import megastream as ms

    rel, absd = {}, {}
    fdn_p, fup_p = ms.passI_plain(pack, tiles, cpar, ops)
    fdn_k, fup_k = ms.passI(pack, tiles, cpar, ops)
    sdn_p, jn_p = ms.passA_plain(pack, fdn_p, fup_p, ops)
    sdn_k, jn_k = ms.passA(pack, fdn_p, fup_p, ops)
    fdn2_p, fup2_p = ms.passB_plain(pack, sdn_p, jn_p, cpar, ops)
    fdn2_k, fup2_k = ms.passB(pack, sdn_p, jn_p, cpar, ops)
    torch.cuda.synchronize()
    for name, pairs in (("passI", ((fdn_k, fdn_p), (fup_k, fup_p))),
                        ("passA", ((sdn_k, sdn_p), (jn_k, jn_p))),
                        ("passB", ((fdn2_k, fdn2_p), (fup2_k, fup2_p)))):
        rel[name] = max(rel_err(k, p) for k, p in pairs)
        absd[name] = max(float((k - p).abs().max()) for k, p in pairs)
        if not all(bool(torch.isfinite(k).all()) for k, _ in pairs):
            fail(f"{name} produced non-finite values")
    return rel, absd, (fdn_p, fup_p, sdn_p, jn_p)


def phase_card():
    import torch

    from sos_rt_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    lib = cuda_build._lib_path("megastream")
    with open(lib + ".log") if os.path.exists(lib + ".log") else open(os.devnull) as fh:
        ptxas = [ln.strip() for ln in fh if "registers" in ln or "spill" in ln]
    emit({"phase": "card", "nvidia_smi": nvidia_smi(),
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": round(build_s, 3),
          "compiled": sorted(built), "ptxas": ptxas})


def phase_kernels(device):
    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import GridSpec, SolverOptions
    from sos_rt_tpu_torch.presets import get_preset

    grid = GridSpec(56, 64)
    rng = np.random.default_rng(SEED)
    scenes = random_scenes(get_preset("hg"), 8, device, rng)
    results = []
    for dtype, mm, tol in (("float64", "highest", 1e-12),
                           ("float32", "bf16x3", 1e-5),
                           ("float32", "highest", 1e-5)):
        for surface in ("lambertian", "specular"):
            opts = SolverOptions(surface=surface, dtype=dtype, mm=mm)
            tables = test_tables(grid, device, getattr(torch, dtype))
            (pack, cpar, tiles), ops = block_inputs(scenes, tables, grid, opts, device)
            rel, _, _ = kernel_vs_plain(pack, cpar, tiles, ops)
            results.append({"dtype": dtype, "mm": mm, "surface": surface,
                            "tol": tol, "rel_err": rel})
            for name, e in rel.items():
                if not e <= tol:
                    fail(f"{name} {dtype} {mm} {surface}: {e:.3e} > {tol}")
    emit({"phase": "kernels", "grid": [56, 64], "batch": 8, "cases": results})


def phase_slice_f64(device):
    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import GridSpec, SolverOptions
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.presets import get_preset

    grid = GridSpec(56, 64)
    out = {"phase": "slice_f64", "grid": [56, 64], "batch": 8}
    for surface in ("lambertian", "specular"):
        opts = SolverOptions(surface=surface, dtype="float64")
        sols = []
        for dev in (device, torch.device("cpu")):
            rng = np.random.default_rng(SEED)
            scenes = random_scenes(get_preset("hg"), 8, dev, rng)
            sols.append(solve_batch(scenes, test_tables(grid, dev, torch.float64),
                                    grid, opts, engine="mega", device=dev))
        gpu, cpu = sols
        if not torch.equal(gpu.n_orders.cpu(), cpu.n_orders):
            fail(f"slice_f64 {surface}: order counts differ "
                 f"{gpu.n_orders.tolist()} vs {cpu.n_orders.tolist()}")
        a, b = gpu.i_total.cpu(), cpu.i_total
        scale = float(b.abs().max())
        if not torch.allclose(a, b, rtol=1e-9, atol=1e-11 * scale):
            fail(f"slice_f64 {surface}: max rel err {rel_err(a, b):.3e}")
        out[surface] = {"n_orders": cpu.n_orders.tolist(), "rel_err": rel_err(a, b)}
    emit(out)


def f32_vs_f64(sol, ref, sub, phase: str) -> dict:
    """Hold columns ``sub`` of a float32 summary against the float64 solve
    ``ref`` of the same columns: equal order counts, and a p50 relative
    error of the TOA/surface rows below F64_P50_TOL."""
    import torch

    if not torch.equal(ref.n_orders, sol.n_orders[sub]):
        fail(f"{phase} f32 vs f64 order counts differ: "
             f"{sol.n_orders[sub].tolist()} vs {ref.n_orders.tolist()}")
    got = torch.cat([sol.i_toa[sub], sol.i_surface[sub]], 1).double()
    want = torch.cat([ref.i_toa, ref.i_surface], 1)
    keep = want.abs() > 1e-12 * want.abs().max()
    rel = (got - want).abs()[keep] / want.abs()[keep]
    p50 = float(rel.median())
    if not p50 < F64_P50_TOL:
        fail(f"{phase} f32 vs f64 p50 relative error {p50:.3e}")
    return {"columns": sub.tolist(), "n_orders": ref.n_orders.tolist(),
            "p50_rel": p50, "max_rel": float(rel.max()), "p50_tol": F64_P50_TOL}


def bound_ms(kind: str, L: int, C: int, Mp: int, ops, itemsize: int):
    """Least time (ms) for one call at these shapes on an H100: the bytes
    the call must move (each input read once, each output written once)
    over the memory rate, against its products' operations over the peak
    rate for their type."""
    plane = L * C * Mp * itemsize
    row = L * C * itemsize                     # one pack row
    passes = SPLIT_PASSES[ops.mm]
    op_type = "bf16" if ops.mm != "highest" else (
        "float64" if itemsize == 8 else "float32")
    nsplit = 2 if ops.mm != "highest" else 1
    if kind == "passI":
        nbytes = 14 * row + 25 * C * Mp * itemsize + 2 * plane
        if ops.lamb:
            nbytes += nsplit * 4 * Mp * Mp * itemsize
        flops = 2 * 4 * Mp * Mp * L * C * passes if ops.lamb else 0
    elif kind == "passA":
        nbytes = 5 * row + 4 * plane + nsplit * 8 * Mp * Mp * itemsize
        flops = 2 * 4 * Mp * 2 * Mp * L * C * passes
    else:
        nbytes = 6 * row + 4 * plane + nsplit * Mp * Mp * itemsize
        flops = 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[op_type] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def phase_canonical(device):
    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import SolverOptions
    from sos_rt_tpu_torch.metrics import solution_metrics
    from sos_rt_tpu_torch.ops import megastream as ms
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables

    preset = get_preset("hg")
    grid, B = preset.grid, 256
    opts = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3")
    rng = np.random.default_rng(SEED)
    scenes = random_scenes(preset, B, device, rng)
    tables = PhaseTables.from_models(grid, 0.5, atm=preset.atm, aer=preset.aer,
                                     dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    ms.reset_launches()
    t0 = time.perf_counter()
    sol = solve_batch(scenes, tables, grid, opts, engine="mega",
                      outputs="summary", cols_per_block=128, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ms.KERNELS}
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel was not launched on the main path: {launches}")
    if not (bool(torch.isfinite(sol.i_toa).all())
            and bool(torch.isfinite(sol.i_surface).all())):
        fail("canonical summary rows are not finite")
    if tuple(sol.i_toa.shape) != (B, 2 * grid.nb_angles):
        fail(f"canonical summary shape {tuple(sol.i_toa.shape)}")

    # 8 columns against the same solve in float64 on the card
    sub = torch.arange(8, device=device) * (B // 8)
    from sos_rt_tpu_torch.fused import take_columns

    s8 = take_columns(scenes, sub)
    t64 = PhaseTables.from_models(grid, 0.5, atm=preset.atm, aer=preset.aer,
                                  dtype=torch.float64, device=device)
    ref = solve_batch(s8, t64, grid, SolverOptions(surface="lambertian",
                                                   dtype="float64"),
                      engine="mega", outputs="summary", device=device)
    f64_check = f32_vs_f64(sol, ref, sub, "canonical")
    metrics = solution_metrics(sol, wall_s=wall)

    # each kernel at this run's block shapes: time, plain time, bound
    (pack, cpar, tiles), ops = block_inputs(scenes, tables, grid, opts, device,
                                            cols_per_block=128)
    rel_k, abs_k, (fdn, fup, sdn, jn) = kernel_vs_plain(pack, cpar, tiles, ops)
    for name, e in rel_k.items():
        if not e <= F32_KERNEL_TOL:
            fail(f"{name} at the canonical block: rel err {e:.3e} > {F32_KERNEL_TOL}")
    L, C, Mp = fdn.shape
    item = fdn.element_size()
    calls = {
        "passI": (lambda: ms.passI(pack, tiles, cpar, ops),
                  lambda: ms.passI_plain(pack, tiles, cpar, ops)),
        "passA": (lambda: ms.passA(pack, fdn, fup, ops),
                  lambda: ms.passA_plain(pack, fdn, fup, ops)),
        "passB": (lambda: ms.passB(pack, sdn, jn, cpar, ops),
                  lambda: ms.passB_plain(pack, sdn, jn, cpar, ops)),
    }
    x2 = torch.randn((L * C, 2 * Mp), device=device, dtype=fdn.dtype)
    w2 = torch.randn((2 * Mp, 4 * Mp), device=device, dtype=fdn.dtype)
    library = {"passA": lambda: x2 @ w2, "passI": lambda: x2[:, :Mp] @ w2[:Mp],
               "passB": None}
    kernels = []
    for name, (kern, plain) in calls.items():
        bms, by = bound_ms(name, L, C, Mp, ops, item)
        lib = library[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": abs_k[name], "max_rel_err": rel_k[name],
            "ms": timed(kern, 5), "plain_ms": timed(plain, 1),
            "bound_ms": bms, "bound_by": by,
            "library_ms": timed(lib, 5) if lib else None})
    emit({"phase": "canonical", "grid": [grid.nb_angles, grid.nb_layers],
          "batch": B, "cols_per_block": 128, "dtype": "float32", "mm": "bf16x3",
          "metrics": metrics, "launches": launches, "f64_check": f64_check,
          "block_shape": [L, C, Mp]})
    return kernels


def phase_fwc_sweep(device):
    """Returns {kernel: max absolute error against plain} over this path's
    block shapes."""
    import dataclasses

    import numpy as np
    import torch

    from sos_rt_tpu_torch.fused import (coarse_problem, predict_cols_per_block,
                                        take_columns)
    from sos_rt_tpu_torch.metrics import solution_metrics
    from sos_rt_tpu_torch.ops import megastream as ms
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables

    preset = get_preset("fwc_sweep")
    B = 4096
    rng = np.random.default_rng(SEED)
    scenes = random_scenes(preset, B, device, rng)
    tables = PhaseTables.from_models(preset.grid, 0.5, atm=preset.atm,
                                     aer=preset.aer, dtype=torch.float32,
                                     device=device)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        ms.reset_launches()
        t0 = time.perf_counter()
        sol = solve_batch(scenes, tables, preset.grid, preset.opts, engine="mega",
                          outputs="summary", sort="predict", device=device)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, sol))
    launches = {k.__name__: k.launches for k in ms.KERNELS}
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel was not launched on the fwc_sweep path: {launches}")
    wall, sol = runs[-1]
    if not (bool(torch.isfinite(sol.i_toa).all())
            and bool(torch.isfinite(sol.i_surface).all())):
        fail("fwc_sweep summary rows are not finite")
    if tuple(sol.i_toa.shape) != (B, 2 * preset.grid.nb_angles):
        fail(f"fwc_sweep summary shape {tuple(sol.i_toa.shape)}")

    # 8 columns against the same solve in float64 on the card
    sub = torch.arange(8, device=device) * (B // 8)
    s8 = take_columns(scenes, sub)
    t64 = PhaseTables.from_models(preset.grid, 0.5, atm=preset.atm,
                                  aer=preset.aer, dtype=torch.float64,
                                  device=device)
    ref = solve_batch(s8, t64, preset.grid,
                      dataclasses.replace(preset.opts, dtype="float64"),
                      engine="mega", outputs="summary", device=device)
    f64_check = f32_vs_f64(sol, ref, sub, "fwc_sweep")

    # the kernels at the shapes this path gives them: the sweep's first
    # block (the default block size) and the predictor's coarse solve
    (pack, cpar, tiles), ops = block_inputs(scenes, tables, preset.grid,
                                            preset.opts, device)
    rel_k, abs_k, (fdn, fup, sdn, jn) = kernel_vs_plain(pack, cpar, tiles, ops)
    cg, ct = coarse_problem(tables, preset.grid, device)
    (cpk, ccp, cti), cops = block_inputs(scenes, ct, cg, preset.opts, device,
                                         cols_per_block=predict_cols_per_block(device))
    rel_c, abs_c, _ = kernel_vs_plain(cpk, ccp, cti, cops)
    for where, rel in (("fwc block", rel_k), ("predictor block", rel_c)):
        for name, e in rel.items():
            if not e <= F32_KERNEL_TOL:
                fail(f"{name} at the {where}: rel err {e:.3e} > {F32_KERNEL_TOL}")
    L, C, Mp = fdn.shape
    kernel_ms = {
        "passI": timed(lambda: ms.passI(pack, tiles, cpar, ops), 5),
        "passA": timed(lambda: ms.passA(pack, fdn, fup, ops), 5),
        "passB": timed(lambda: ms.passB(pack, sdn, jn, cpar, ops), 5),
    }
    emit({"phase": "fwc_sweep", "grid": [64, 128], "batch": B,
          "sort": "predict", "first_wall_s": runs[0][0],
          "metrics": solution_metrics(sol, wall_s=wall), "launches": launches,
          "f64_check": f64_check, "block_shape": [L, C, Mp],
          "predictor_block_shape": [cpk.shape[1], cpk.shape[2], cops.mp],
          "rel_err": {"block": rel_k, "predictor": rel_c},
          "block_ms": kernel_ms})
    return {name: max(abs_k[name], abs_c[name]) for name in abs_k}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import sos_rt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    os.environ.setdefault("SOS_RT_CACHE_DIR",
                          os.path.join(HERE, "build", "sos_rt_tpu_torch", "tables"))
    device = torch.device("cuda")
    t0 = time.perf_counter()
    phase_card()
    phase_kernels(device)
    phase_slice_f64(device)
    kernels = phase_canonical(device)
    fwc_abs = phase_fwc_sweep(device)
    for k in kernels:        # the largest difference over both paths' blocks
        k["max_abs_err"] = max(k["max_abs_err"], fwc_abs[k["name"]])
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
