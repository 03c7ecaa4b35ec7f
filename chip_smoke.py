#!/usr/bin/env python3
"""Drive the PyTorch port (sos_rt_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # about 5 min on an H100, the build included

Phases, one JSON line each on stdout:

1. ``card``      the card (nvidia-smi name and power limit), torch and CUDA
                 versions, the seconds the kernels took to build, ptxas's
                 registers, spills and shared memory of each kernel (by
                 name: the four tensor-core kernels of passA/passI, with
                 their dynamic shared memory, the two of the split-mode
                 source (fused_source.cu, the same mainloop), the stage
                 kernels of passB
                 and up_sweep_smooth, and the down sweep's float32 and
                 float64 builds), and sos_mega's registers and
                 spills per build: the SIMT builds held equal to
                 MEGA_PTXAS_SIMT, the two tensor-core builds to the
                 registers of MEGA_PTXAS_TC and at most its spills;
                 sos_mega_i1in's builds (MEGA_AB_I1IN) beside them.
2. ``kernels``   each kernel (passI, passA, passB) against its plain
                 PyTorch version on the card at GridSpec(56, 64), B=8:
                 float64 'highest' within 1e-12 of scale, float32
                 'bf16x3' and 'highest' within 1e-5 of scale (the
                 summation order differs), passI/passA on the tensor cores
                 in 'bf16x3' and on the SIMT product otherwise (the
                 ``tc_launches`` counts); the resident whole-loop kernel
                 (mega_call) against mega_plain on the same batch: equal
                 order counts, summary rows within 1e-12 (float64) and 1e-4
                 (float32 'bf16x3', 'bf16x5', its products on the tensor
                 cores: mega_call.tc_launches) of scale; the fused engine's
                 two sweep kernels (down_sweep, up_sweep_smooth) against
                 their plain versions on the J_n of a real second order:
                 down_sweep to the bit (same_bits), up_sweep_smooth float64
                 within 1e-12 and float32 within 1e-6 of scale (0.0 is
                 expected: both do the same separately rounded operations
                 in the same order).
3. ``slice_f64`` solve_batch(engine='mega') in float64 on the card against
                 the same solve on the CPU: equal order counts, rtol 1e-9.
4. ``canonical`` the main path at full width: the ``hg`` preset on the
                 501×800 grid, B=256 (two blocks of 128 columns), float32
                 bf16x3, summary outputs; the launch counts of this run;
                 8 of its columns against the same solve in float64 on the
                 card (equal order counts, p50 relative error of the
                 TOA/surface rows below 1e-3); every passI/passA launch on
                 the tensor cores; then each kernel timed at this run's
                 block shapes beside its plain version, the least time the
                 card could take (bound_ms) and, for the two products, one
                 torch.matmul of the same shapes; passA split into its
                 product and its downward recurrence, passB into its band
                 fix, upward walk and smoothing (torch.profiler, by kernel
                 name), and the products' achieved TFLOP/s (bf16
                 split-pass FLOPs over their time) beside their bound.
5. ``fwc_sweep`` the 64×128 FWC sweep preset at B=4096, float32,
                 sort='predict', through solve_batch (which takes the
                 resident kernel at this grid); the launch counts of
                 this run (every mega_call launch on the tensor cores); 8
                 of its columns against the same solve in float64 on the
                 card (as in ``canonical``); each streamed
                 kernel against its plain version at the shapes
                 solve_batch_mega(stream=True) gives them on this batch, the
                 sweep's first block (1024 columns) and a 1024-column block
                 of the 8×16 coarse grid (an explicitly streamed predictor
                 solve, as phase ``resident`` times it), within 1e-4 of
                 scale, on the tensor cores; each kernel timed on the first
                 block.

6. ``resident``  the same 4096-column batch through
                 solve_batch_mega(stream=False) and (stream=True), in turns:
                 order counts and summary rows within MEGA_BATCH_LIMITS (both
                 products on the tensor cores, in two mainloops), with the
                 counts of columns and values off, wall time
                 and launch counts of both, every float32 mega_call launch
                 on the tensor cores; 8 columns in float64, both on the SIMT
                 product (no tensor-core launch): equal order counts, within
                 1e-12; the coarse 8×16 predictor solve both
                 ways (it runs resident; MEGA_BATCH_LIMITS) and mega_call
                 against mega_plain there;
                 mega_call timed alone on the sorted batch beside mega_plain,
                 its bound and its product-only yardstick (library_ms: one
                 FP32 torch.matmul of an order's (4096·128 × 128)·(128 ×
                 256) source product times the orders the batch needs, and
                 one of I1's (4096·128 × 64)·(64 × 256) product).
7. ``sweep_cli`` the production entry point: ``python -m sos_rt_tpu_torch
                 sweep --preset fwc_sweep --batch 16384 --chunk 4096`` with
                 the default 64-value µ0 pool (per-column P0 tables), through
                 cli.main (every mega_call launch on the tensor cores); the
                 shards loaded back: shapes, all finite, all converged, 8
                 columns against the float64 solve on the card;
                 a second call with --resume that solves no shard.
8. ``i1_host``   the mega engine with the first order from the host
                 (i1='host'): the 64×128 batch of ``resident`` through
                 solve_batch_mega(stream=False, sort='predict', i1='host')
                 (one sos_mega_i1in launch, no passI) against i1='kernel'
                 (MEGA_BATCH_LIMITS in float32; 8 columns in float64: equal
                 order counts, rows within 1e-12); sos_mega_i1in against
                 mega_plain from the same planes on the sorted batch
                 (MEGA_BATCH_LIMITS), timed in turns beside sos_mega, its
                 bound (the solve's without I1's product, plus the two
                 planes read) and the source product's yardstick; the
                 canonical 501×800 batch, B=256, streamed: no passI,
                 passA and passB as with the kernels' I1.

9. ``reference_f64`` solve_batch(engine='reference') in float64 on the card
                 against the same solve on the CPU at GridSpec(56, 64), B=8,
                 both surfaces, both scan_impl values: equal order counts,
                 I_total and I1 within rtol 1e-9, no kernel launched.
10. ``reference`` the reference engine at full width: the ``hg`` preset on the
                 501×800 grid, B=64: float32 with full-precision products
                 (mm=None), col/s of a second call (the first's wall
                 beside it), orders and peak memory, 8 columns against
                 the float64 reference solve (as in ``canonical``); the same
                 8 columns in bf16x3 (the source kernel once an order, no
                 other launch) against it too; float64
                 on the whole batch against solve_batch(engine='mega') in
                 float64 (equal order counts, rtol 1e-9); the sequential
                 scans on 8 columns, timed beside the associative ones.
11. ``mie_tables`` the eva and wildfire presets' log-normal Mie tables at
                 501 angles, built anew (cache=False): the wall time of
                 each, their normalizations, and that the native core
                 (csrc/miecore.cpp, built with g++) built them.
12. ``run_cli``  ``python -m sos_rt_tpu_torch run`` in a process of its own
                 with ``--preset hg``, with no preset (its default, eva) and
                 with ``--preset wildfire`` (float64, one column at
                 501×800): wall time, order count, every output finite, I
                 against the mega engine in float64 on the card (rtol
                 1e-9).
13. ``critical_albedo`` ``critical-albedo [--preset hg] --tau-aer 0.02,0.5
                 --num 16`` through cli.main, on hg and on the default
                 preset (eva) (mega engine, float32: the streamed kernels
                 at 501×800, every passI/passA launch on the tensor cores):
                 wall time, curve, launch counts; then 4 lanes of
                 critical_albedo_batch(engine='mega') in float64 against
                 critical_albedo (the reference engine's per-column path):
                 the same albedos.
14. ``sweep_orders`` run_sweep(save_orders=True) on the ``fwc_sweep`` preset,
                 4096 columns, one shard, the 64-value µ0 pool: col/s, peak
                 memory; 8 columns' per-order rows against
                 solve_column_orders of each column on the card (equal
                 validity, rows within 1e-5 of scale).
15. ``single_layer`` tests/test_vdh.py's semi-infinite case (96 × 2400,
                 τ* = 25, float64) on the card: equal to the CPU (rtol
                 1e-9) and to the H-function law at µ ≥ 0.3 (rtol 1e-3).
15b. ``edge_layers`` an aerosol layer that reaches the bottom layer and one
                 that starts in the top layer (EDGE_COLUMNS, the columns of
                 tests/test_torch_edge_layers.py, 48×40): the reference
                 engine, the mega engine resident and streamed, and the
                 fused engine on the card in float64 (equal order counts
                 and rtol 1e-9 against the reference engine on the CPU) and
                 float32 (equal order counts, p50 relative error below
                 F64_P50_TOL), every field finite, a synchronise after
                 each solve; the launch counts show the fused engine
                 taking the bottom batch of the mega engine.
15c. ``mesh``     column sharding over a DeviceMesh (parallel.make_mesh): a
                 world-size-1 NCCL group started in this process; the
                 fwc_sweep batch (resident sos_mega), the canonical batch
                 (streamed passI/A/B, summary) and the fused_canonical batch
                 (engine='fused') through solve_batch(mesh=) equal to the
                 unsharded solve_batch(sort='score') to the bit, with the
                 same launches, and both col/s; 8 canonical columns in
                 float64 with shard_tables=True (reference engine) against
                 the unsharded solve (equal order counts, rtol 1e-12), and
                 in bf16x3, where the route keeps the plain split products
                 (no launch; against the float64 solve as in
                 ``canonical``);
                 solve_batch_multihost on the fwc batch to the bit; then,
                 the group destroyed, ``python -m sos_rt_tpu_torch sweep
                 --preset fwc_sweep --batch 16384 --chunk 4096 --mesh`` in
                 its own process (n_devices 1) against the same command with
                 --sort score and no --mesh: the same shards to the bit;
                 then MESH_RANKS gloo ranks on the one card (CUDA tensors,
                 processes of their own, mesh_rank): the fwc batch on a
                 (2, 1) mesh within MEGA_BATCH_LIMITS of the unsharded
                 solve, every rank launching mega_call, shard_tables on a
                 (1, 2) mesh (rtol 1e-12).
15d. ``layer_sharded`` solve_column_layer_sharded on a ('data',) mesh of a
                 world-size-1 NCCL group at 64 × 800 (the fwc_sweep
                 preset's angles and models, LAYER_SCENE), both surfaces:
                 float64 against solve_column on the card (equal order
                 counts, within 1e-12 of scale), float32 equal order counts
                 and p50 below F64_P50_TOL against float64; the gloo ranks'
                 column of phase ``mesh`` the same way; one 64 × 65,536
                 column in float64 beside solve_column: wall s, orders,
                 peak memory, and within 1e-12 of scale.
16. ``fused_f64`` solve_batch(engine='fused') in float64 on the card against
                 the same solve on the CPU, on GridSpec(56, 64) and on the
                 Gauss grid GridSpec(51, 24) with small-µ columns: equal
                 order counts, rtol 1e-9.
17. ``fused_canonical`` the fused engine's path at full width: the ``hg``
                 preset on the 501×800 grid at τ*_atm = 0.044 (the molecular
                 optical depth near 670 nm), B=64, float32 bf16x3, entered
                 as solve_batch(engine='mega', outputs='summary'): no
                 column's polyfit band covers the grid's small-µ columns
                 (mega_small_ok is false), so the whole batch takes the
                 fused engine; the launch counts (each sweep kernel once an
                 order, the source kernel too, no mega kernel); 8 columns
                 against the float64 fused solve on the card; the same solve
                 with the plain split-product source within MEGA_BATCH_LIMITS
                 of it; the source kernel (sos_fused_source) at this block
                 against fused_source_plain in bf16x3 and bf16x5
                 (F32_KERNEL_TOL), timed beside it, its bound and one
                 torch.mm of its bf16 passes (library_ms); each sweep kernel
                 at this block against
                 its plain version (down_sweep to the bit), timed beside it,
                 its bound and its share of the bound, down_sweep also
                 beside a PyTorch copy of its source (copy_ms: the same
                 bytes, no arithmetic);
                 up_sweep_smooth split into its walk, join smoothings and
                 row pass (torch.profiler, by kernel name).
18. ``fused_sweep`` the 4096-column sweep batch of phase ``resident`` through
                 engine='fused' beside the mega engine on the same batch:
                 col/s of both, the share of columns whose order counts
                 differ (limit 0.1%), the sweep kernels at this block
                 (down_sweep to the bit), timed as in ``fused_canonical``.
19. ``micro_ops`` the tools path: ``python -m sos_rt_tpu_torch.tools.micro_ops``
                 (all 13 patterns, K1 = 128 and K2 = 1024 reps) through its
                 main(), with its launch count; then each pattern's kernel
                 against its plain version at k = 1 and 2 on make_inputs(0),
                 each rep on the same input (the second rep's plain version
                 on the kernel's first rep): to the bit but for the three
                 products (1e-5 of scale);
                 one library call a rep where one torch call computes it;
                 each pattern's share of its per-pass bound; and each
                 kernel's rep loop in its SASS (tools/sass.py: cuobjdump),
                 which must issue at least the shared loads and stores of
                 its source (MICRO_REP_LOOP_LEAST).
20. ``micro_pass`` ``python -m sos_rt_tpu_torch.tools.micro_pass`` through its
                 main(); each of the 9 (mode, g) pairs against its plain
                 version to the bit, on the tool's ones and a random field;
                 each pair's share of its per-pass bound, one call (the
                 tool's ms, the host's dispatch included) and queued (the
                 card's own, tools/card.py::queued_ms); each kernel's
                 pass loop in its SASS, as for micro_ops.
21. ``ablate``   the resident kernel's ablated builds (csrc/mega_ablate.cuh,
                 built by mega_ablate.cu, mega_ablate_f32.cu, mega_ablate_f64.cu):
                 its build of the solve itself (no flag) equal to sos_mega to
                 the bit on the sorted 4096-column sweep batch; each of the
                 13 variants of tools/ablate_kernel.py against
                 mega_plain(ablate=...) on its 1024-column batch (order
                 counts all max_orders, rows within MEGA_BATCH_LIMITS but
                 for ABLATE_AT_THRESHOLD, the columns that are off again in
                 float64 within 1e-12); then
                 ``python -m sos_rt_tpu_torch.tools.ablate_kernel`` (16
                 orders, B=4096) through its main(): where mega_call's time
                 goes.
22. ``ablate_stream`` the streamed passes' ablated builds
                 (csrc/megastream_ablate.cu): each flag of passA (nosrc,
                 noloops) and of passB (nopoly, noloops, nofin, nosmooth)
                 against passA_plain / passB_plain with the same flag on
                 the kernels phase's block (float64 within 1e-12, float32
                 bf16x3 within F32_KERNEL_TOL) and on one canonical
                 128-column block, two orders of the plain chain each
                 (passB to the bit, nosrc's jₙ↑ to the bit); the empty
                 mask of each ablated build equal to sos_passA / the
                 passB stages to the bit; nofin equal to nosmooth; each
                 variant timed at the canonical block; the whole streamed
                 loop on the card against the CPU for the tool's variants
                 and each loop flag (float64: equal order counts, 1e-12;
                 float32 the loop flags, MEGA_BATCH_LIMITS), with the
                 launches each variant makes (nopassA,nopassB none); then
                 ``python -m sos_rt_tpu_torch.tools.ablate_stream`` (12
                 orders, B=128) through its main(), with its launch counts.
23. ``trace``    tools/profile.py on the card: the reference engine's
                 canonical column (its --canonical), the fused_canonical
                 batch, 8 canonical columns through the reference engine in
                 bf16x3 (in both, sos.source_jn runs the source kernel and no
                 other), the canonical batch (mega, streamed), the 64×128
                 sweep batch (mega, resident) and the sweep command once:
                 device ms by scope (each present on the reference and
                 fused engines) and by kernel, the window's host ms and
                 the device's busy share; beside them the route's
                 layer_reaches_ground on one 4096-column chunk.

``python3 chip_smoke.py --gpus`` runs only ``mesh_gpus``, on a host with
more than one card: ``sweep --preset fwc_sweep --batch 65536 --chunk 16384
--mesh`` under torchrun (one NCCL rank a card) against the same command on
one card with --sort score: the shards within MEGA_BATCH_LIMITS, both
commands' metrics (n_devices the number of cards) and walls.

Then the ``{"kernels": [...]}`` line (eight kernels, and sos_mega_i1in
after mega_call, and fused_source after the sweep kernels; passA and passB with their ablated build under
``ablated``: its source, its launches in ``ablate_stream``'s tool run, its
largest difference from the plain versions at the canonical block and each
variant's ms there; max_abs_err over both
paths' blocks; share_of_bound = bound_ms / ms for the sweep and micro
kernels; for micro_ops and micro_pass the sums over their patterns' K1
calls and their pairs' calls, with pass_bound_ms, the sum of the per-pass
bounds their tools time against, and its share; micro_pass also its
queued_ms and queued_pass_bound_share), the nvidia-smi line and,
last,
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
    "mega_call": "sos_rt_tpu/ops/megakernel.py:303",
    "mega_call_i1in": "sos_rt_tpu/ops/megakernel.py:303",
    "down_sweep": "sos_rt_tpu/ops/pallas_sweeps.py:90",
    "up_sweep_smooth": "sos_rt_tpu/ops/pallas_sweeps.py:167",
    "micro_ops": "tools/micro_ops.py:28",
    "micro_pass": "tools/micro_pass.py:22",
    # not a Pallas kernel: the JAX package's split products (make_split_dot)
    # of sos_rt_tpu/fused.py:663-668 and sos_rt_tpu/solver.py:226-232
    "fused_source": "sos_rt_tpu/ops/precision.py:59",
}
SOURCE = "sos_rt_tpu_torch/csrc/megastream.cu"
MEGA_SOURCE = "sos_rt_tpu_torch/csrc/megakernel.cu"
FUSED_SOURCE = "sos_rt_tpu_torch/csrc/fused_sweeps.cu"
SPLIT_SOURCE = "sos_rt_tpu_torch/csrc/fused_source.cu"
MICRO_SOURCE = "sos_rt_tpu_torch/csrc/micro.cu"
STREAM_ABLATE_SOURCE = "sos_rt_tpu_torch/csrc/megastream_ablate.cu"
# the least shared loads and stores (LDS, STS) that the rep (pass) loop of
# each micro kernel issues in its SASS, from micro.cu: a row pattern one
# float4 of each of a warp's 8 rows, read and written; smooth each of a
# warp's 2 rows' float2 and sv[idx], and the float2 back; matmul a 4-k step
# (8 rows' float4s, a2's two float4s of each k) and its 8 rows' two float4s
# back; the wgmma products two reps a loop, each its 32 float2 splits and its
# 32 float2 stores; a pass a thread's 8 float4s, or for chunk / chunk2d
# those of the bodies of 1, 2, 4 and 8 float4s that the loop holds
MICRO_REP_LOOP_LEAST = {"smooth": (4, 2), "matmul": (16, 16), "matmul_def": (64, 64),
                        "matmul_high": (64, 64), "chunk": (15, 15), "chunk2d": (15, 15)}
# micro_ops products against their plain versions, of scale: the kernel sums
# 128 products in another order than cuBLAS (matmul) or sums the exact bf16
# products with float32 accumulators where the plain version rounds a float64
# sum once (matmul_high, matmul_def)
MICRO_PRODUCT_TOL = 1e-5
# the attribution run (tools/ablate_kernel.py's defaults) and the batch its
# variants are held against mega_plain on
ABLATE_ORDERS, ABLATE_BATCH, ABLATE_CHECK_BATCH = 16, 4096, 1024
# the streamed attribution run (tools/ablate_stream.py's defaults), the
# order count of the whole-loop checks, and the loop's own flags they run
STREAM_ABLATE_ORDERS, STREAM_ABLATE_BATCH, STREAM_LOOP_ORDERS = 12, 128, 6
STREAM_LOOP_FLAGS = ("sccond", "nopassA", "nopassB", "notiles", "noratio",
                     "noconv,sccond")
# variants whose float32 fields leave the smoothing threshold's resolution:
# without the source product the field grows to ~7e3, where one float32 ulp
# (~5e-4) exceeds the walk's 1e-4 threshold, and from a start of 1 on every
# angle the walk meets near-zero second differences; float32 rounding then
# decides the blend endpoints far more often than in the solve (measured on
# an H100: 0.69% and 1.9% of row values off, at most 8.3e-2 of scale), so
# MEGA_BATCH_LIMITS do not apply to them in float32; every column that is
# off is held in float64 instead, to 1e-12
ABLATE_AT_THRESHOLD = ("noconv,noi1", "noconv,nosrc")
# a sweep kernel against its plain version, of scale: both do the same
# separately rounded operations in the same order, so 0.0 is expected; a
# last-bit difference would show as ~1e-7 (float32) and, where it moves a
# smoothing blend's endpoint, as ~1e-2.  The kernels in SWEEP_SAME_BITS are
# held to the bits (same_bits) instead.
SWEEP_TOL = {"float64": 1e-12, "float32": 1e-6}
SWEEP_SAME_BITS = ("down_sweep",)
# columns of the float32 sweep batch whose order count may differ between
# the fused and the mega engine (a ratio within rounding of the 100 ppm line)
FUSED_N_DIFFERS_FRAC = 1e-3
# operations per value of a sweep (multiplies, adds, compares; an
# exponential counted as one), for the bound's operations side
SWEEP_OPS = {"down_sweep": 8, "up_sweep_smooth": 30}
# Two whole float32 loops with other product arithmetic over thousands of
# columns (see mega_vs_plain): about three times what mega_call against
# mega_plain shows on the 4096-column sweep batch on an H100 (2.4e-4, 1,
# 8.6e-4, 2.0e-2 with the SIMT product; 0, 0, 6.3e-4, 2.0e-2 with the
# tensor-core one).  The same limits hold the resident execution against the
# streamed one in float32: both run their products on the tensor cores, in
# two mainloops (wgmma in csrc/quad_mma.cuh, mma.sync in csrc/mega_mma.cuh),
# which both add each k16 block's sum to the running one apart, in the same
# term order; the rest of the two executions (epilogues, recurrences) is
# compiled apart, so a last bit can still move a smoothing endpoint or a
# ratio across the 100 ppm line.  In float64 both run the same SIMT product
# and agree to rtol 1e-12 with equal order counts.
MEGA_BATCH_LIMITS = {"n_differs_frac": 1e-3, "n_differs_max": 1.0,
                     "rows_off_frac": 3e-3, "rows_max_rel": 5e-2}
# sos_mega's (registers, spill store bytes) per build (dtype, mm, threads)
# as ptxas reports them for csrc/megakernel.cu (CUDA 12.8, sm_90a).  The
# builds on the SIMT product (float64, 'highest', the 512-thread block of
# Mp > 256) as they were before the resident kernel had a tensor-core
# product; they must keep them exactly:
MEGA_PTXAS_SIMT = {("float64", "highest", 256): (128, 440),
                   ("float64", "highest", 512): (128, 440),
                   ("float32", "highest", 256): (128, 116),
                   ("float32", "highest", 512): (128, 116),
                   ("float32", "bf16x3", 512): (128, 144),
                   ("float32", "bf16x5", 512): (128, 164)}
# The two builds whose products run on the tensor cores (csrc/mega_mma.cuh)
# as their first build recorded them; their SIMT predecessors spilled 144
# (bf16x3) and 164 (bf16x5) bytes.  They must keep the registers and spill
# no more:
MEGA_PTXAS_TC = {("float32", "bf16x3", 256): (128, 72),
                 ("float32", "bf16x5", 256): (128, 96)}
# the AB bit of mega_body.cuh that builds sos_mega_i1in (the first order
# from the host); its builds report their registers and spills beside
# sos_mega's, unchecked
MEGA_AB_I1IN = 2048
SPLIT_PASSES = {"bf16x3": 3, "bf16x5": 5, "highest": 1}
# kernel against plain at a main-path block, float32 bf16x3, relative to
# each output's largest magnitude: the kernel sums the 3 * 2Mp split
# products of a passA output on the tensor cores (float32 accumulators, one
# k16 block of exact bf16 products at a time, in the tensor core's order)
# and cuBLAS sums the same products in another order; the worst-case bound
# of such a float32 sum is 3 * 2Mp * 2**-24 of the sum of |terms| (the
# outputs are sums of terms of one sign): 1.8e-4 at the canonical Mp = 504,
# the largest; smaller at the 64x128 grid (2.3e-5) and the predictor's 8x16
# grid (2.9e-6).  Measured on an H100: 2.2e-5 (passA) and 7.0e-6 (passI) at
# the canonical block, as the SIMT product gave (2.5e-5, 6.0e-6); 2.3e-6
# and 3.1e-7 at the other two.
F32_KERNEL_TOL = 1e-4
# float32 against float64 on the same columns: p50 relative error of the
# TOA/surface rows (the float32 accumulation floor is ~2e-4)
F64_P50_TOL = 1e-3


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T0, 1)}
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
    from sos_rt_tpu_torch.fused import prepare_batch

    sb = prepare_batch(scenes, tables, grid, opts, cols_per_block=cols_per_block,
                       device=device)
    return sb.block(0), sb.ops


def launch_counts() -> dict:
    """Launches of every kernel wrapper, and of passI / passA / mega_call
    those whose products ran on the tensor cores (``passI_tc``,
    ``passA_tc``, ``mega_call_tc``), of mega_call those of sos_mega_i1in
    (``mega_call_i1in``), and of passA / passB those of their ablated
    builds (``passA_ablate``, ``passB_ablate``)."""
    from sos_rt_tpu_torch.ops import megastream as ms

    counts = {k.__name__: k.launches for k in ms.COUNTED_KERNELS}
    counts.update({f"{k.__name__}_tc": k.tc_launches for k in ms.TC_KERNELS})
    counts.update({f"{k.__name__}_ablate": k.ablate_launches for k in ms.ABLATE_KERNELS})
    counts["mega_call_tc"] = ms.mega_call.tc_launches
    counts["mega_call_i1in"] = ms.mega_call.i1in_launches
    return counts


def mega_tc_ok(launches: dict, what: str):
    """Fail unless mega_call ran and every launch took the tensor cores
    (float32 'bf16x3' / 'bf16x5' at Mp <= 256)."""
    if launches["mega_call"] == 0 or launches["mega_call_tc"] != launches["mega_call"]:
        fail(f"{what}: mega_call launched {launches['mega_call']} times, "
             f"{launches['mega_call_tc']} on the tensor cores")


def tc_route_ok(launches: dict, tensor_cores: bool, what: str):
    """Fail unless every launch of passI and passA ran its product on the
    tensor cores (float32 'bf16x3' / 'bf16x5') or none did (the SIMT
    product of float64 and 'highest')."""
    for k in ("passI", "passA"):
        want = launches[k] if tensor_cores else 0
        if launches[k] == 0 or launches[f"{k}_tc"] != want:
            fail(f"{what}: {k} launched {launches[k]} times, {launches[f'{k}_tc']} on "
                 f"the tensor cores (expected {want})")


def check_path_launches(launches: dict, grid, dtype, phase: str):
    """Fail unless every kernel of the default route at ``grid`` was
    launched: mega_call where solve_batch_mega(stream=None) runs resident,
    the three streamed kernels where it runs streamed."""
    from sos_rt_tpu_torch import fused

    streamed = fused.resolve_stream(None, grid, dtype)
    need = {"passI", "passA", "passB"} if streamed else {"mega_call"}
    missing = sorted(k for k in need if launches[k] == 0)
    if missing:
        fail(f"{phase}: kernels of the path were not launched: {missing} ({launches})")


def mega_vs_plain(pack, cpar, tiles, ops, opts, tol: float, what: str,
                  f64_batch=None, planes=None):
    """mega_call against mega_plain on the same batch (summary outputs).
    Returns (max relative error, max absolute error, extra findings: among
    them plain_ms, the wall of the one mega_plain call).

    At a few columns: equal order counts and flags, rows within ``tol`` of
    scale.  With ``f64_batch`` (thousands of float32 columns) the whole
    loop meets its two discontinuities somewhere in the batch: a last-bit
    difference between the kernel's and cuBLAS's sums moves the endpoint
    of a µ→0⁺ smoothing blend (1e-3..1e-2 of scale on a few angles, PERF.md
    "Threshold flips"), and that can carry a column's ratio across the
    100 ppm line one order sooner or later.  The limits then are
    MEGA_BATCH_LIMITS: order counts differ in at most one column in a
    thousand and by at most 1, at most three row values in a thousand are
    off by more than ``tol`` of scale, and none by more than 5e-2.  That
    rounding alone puts those columns off is then shown, not assumed:
    ``f64_batch(columns)`` prepares the columns that are off in float64,
    where no sum's last bit reaches a threshold, and there the kernel and
    the plain version must give equal order counts and rows within 1e-12
    of scale, so the kernel takes the same branches on these very columns.
    ``planes`` (the host's I₁ planes, ``MegaBatch.i1_planes()``) start both
    loops from the same first order (sos_mega_i1in); ``f64_batch`` then
    prepares its columns with i1='host' too."""
    import torch

    from sos_rt_tpu_torch.ops import megakernel as mk

    planes = planes or {}
    kw = dict(tol=float(opts.tol), max_orders=int(opts.max_orders), full=False)
    got = mk.mega_call(pack, cpar, tiles, ops, **kw, **planes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = mk.mega_plain(pack, cpar, tiles, ops, **kw, **planes)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not all(bool(torch.isfinite(g).all()) for g in got):
        fail(f"mega_call {what}: non-finite values")
    rel = max(rel_err(g, w) for g, w in zip(got[:4], want[:4]))
    absd = max(float((g - w).abs().max()) for g, w in zip(got[:4], want[:4]))
    extra = {"plain_ms": plain_ms}
    if f64_batch is not None:
        found, off = loops_within_limits(got[-1][mk.ST_N], want[-1][mk.ST_N], got[:4],
                                         want[:4], f"mega_call {what}", tol)
        extra.update(found)
        cols = torch.nonzero(off)[:, 0]
        extra["columns_off"] = int(cols.numel())
        if cols.numel():
            sb, opts64 = f64_batch(cols)
            extra["columns_off_f64_rel"], _, _ = mega_vs_plain(
                sb.pack, sb.cpar, sb.tiles, sb.ops, opts64, 1e-12,
                f"{what}, its {cols.numel()} columns that are off, in float64",
                planes=sb.i1_planes())
    else:
        for row in (mk.ST_N, mk.ST_CONV):
            if not torch.equal(got[-1][row], want[-1][row]):
                fail(f"mega_call {what}: stats row {row} differs from mega_plain")
        if not rel <= tol:
            fail(f"mega_call {what}: rel err {rel:.3e} > {tol}")
    return rel, absd, extra


def loops_within_limits(n_a, n_b, rows_a, rows_b, what: str, tol: float = F32_KERNEL_TOL):
    """Two whole float32 loops over thousands of columns with other product
    arithmetic, held to MEGA_BATCH_LIMITS: their order counts ``n_a``,
    ``n_b`` and their summary rows, the (columns, angles) tensors of
    ``rows_a`` against ``rows_b`` (a value is off when it differs by more
    than ``tol`` of its tensor's scale).  Returns the findings and the mask
    of the columns whose order count differs or that have a value off."""
    import torch

    dn = (n_a - n_b).abs()
    off = torch.cat([(a - b).abs() > tol * float(b.abs().max())
                     for a, b in zip(rows_a, rows_b)], 1)
    found = {"n_differs_frac": float((dn > 0).float().mean()),
             "n_differs_max": float(dn.max()),
             "rows_off_frac": float(off.float().mean()),
             "rows_max_rel": max(rel_err(a, b) for a, b in zip(rows_a, rows_b)),
             "n_differs_count": int((dn > 0).sum()), "rows_off_count": int(off.sum())}
    for k, lim in MEGA_BATCH_LIMITS.items():
        if not found[k] <= lim:
            fail(f"{what}: {k} = {found[k]:.3e} > {lim} ({found})")
    return found, (dn > 0) | off.any(1)


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


def second_order_source(fb):
    """J_n (B, L, 2M) of the fused batch's second order."""
    m = fb.M
    return fb.source(fb.i1[:, :, :m], fb.i1[:, :, m:])


def sweep_calls(fb, jn):
    """{name: (kernel call, plain call)} of the two sweep kernels on the
    source ``jn``, as the engine's order step gives it to them: the halves
    are views of the (B, L, 2M) source, the BC comes from the fixed I_down."""
    from sos_rt_tpu_torch.ops import fused_sweeps as fs

    m = fb.M
    dn_args = (jn[:, :, :m], fb.pack, fb.mu_down_safe)
    bc = fb.surface_bc(fb.narrow_down_fixes(fs.down_sweep_plain(*dn_args), jn))
    up_args = (jn[:, :, m:], fb.pack, fb.cparams, fb.mu_up_row, bc)
    return {"down_sweep": (lambda: fs.down_sweep(*dn_args),
                           lambda: fs.down_sweep_plain(*dn_args)),
            "up_sweep_smooth": (lambda: fs.up_sweep_smooth(*up_args),
                                lambda: fs.up_sweep_smooth_plain(*up_args))}


def sweeps_vs_plain(calls, dtype: str, what: str):
    """Each sweep kernel against its plain version on the same inputs.
    Returns {name: max relative error}, {name: max absolute error}."""
    import torch

    rel, absd = {}, {}
    for name, (kern, plain) in calls.items():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {what}: non-finite values")
        rel[name] = rel_err(got, want)
        absd[name] = float((got - want).abs().max())
        if name in SWEEP_SAME_BITS:
            if not same_bits(got, want):
                fail(f"{name} {what}: not equal to its plain version to the bit "
                     f"(rel err {rel[name]:.3e}, {int((got != want).sum())} values)")
        elif not rel[name] <= SWEEP_TOL[dtype]:
            fail(f"{name} {what}: rel err {rel[name]:.3e} > {SWEEP_TOL[dtype]}")
    return rel, absd


def sweep_bound_ms(name: str, B: int, L: int, M: int, itemsize: int):
    """Least time (ms) for one sweep call on an H100: one read of its half
    of J_n, one write of the field, pack (B, L, 8), the µ row and for the
    up sweep cparams (B, 8) and the BC (B, M), over the memory rate, against
    its operations over the card's FP32/FP64 rate."""
    values = 2 * B * L * M + 8 * B * L + M
    if name == "up_sweep_smooth":
        values += 8 * B + B * M
    t_bytes = values * itemsize / HBM_BYTES_PER_S * 1e3
    op_type = "float64" if itemsize == 8 else "float32"
    t_ops = SWEEP_OPS[name] * B * L * M / PEAK_OPS[op_type] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def sweep_block_times(calls, B: int, L: int, M: int, itemsize: int, jn_down,
                      reps: int = 5):
    """{name: {ms, plain_ms, bound_ms, bound_by, share_of_bound}} at this
    block; down_sweep also has copy_ms: one PyTorch copy of its source
    ``jn_down`` into a (B, L, M) field, the same bytes read and written
    with no arithmetic, what the card streams with this layout."""
    import torch

    out = {}
    for name, (kern, plain) in calls.items():
        bms, by = sweep_bound_ms(name, B, L, M, itemsize)
        ms = timed(kern, reps)
        out[name] = {"ms": ms, "plain_ms": timed(plain, 1), "bound_ms": bms,
                     "bound_by": by, "share_of_bound": bms / ms}
    field = torch.empty((B, L, M), dtype=jn_down.dtype, device=jn_down.device)
    out["down_sweep"]["copy_ms"] = timed(lambda: field.copy_(jn_down), reps)
    return out


def fused_launches_ok(launches: dict, n_max: int, phase: str, split: bool = False):
    """Fail unless the run went through the fused engine alone: each sweep
    kernel once per order after the first, no mega kernel, and in the split
    modes (``split``) the source kernel once per order after the first."""
    want = {k: 0 for k in launches}
    want["down_sweep"] = want["up_sweep_smooth"] = n_max - 1
    if split:
        want["fused_source"] = n_max - 1
    if launches != want:
        fail(f"{phase}: launches {launches}, expected {want}")


def ptxas_entries(log_path: str) -> list:
    """[(function, registers, spill store bytes, static shared bytes)] of
    each kernel in a ``ptxas -v`` log, in the order ptxas reports them."""
    out, name, spill = [], None, None
    with open(log_path) as fh:
        for ln in fh:
            if "Function properties for" in ln:
                name = ln.split("Function properties for")[1].strip()
            elif "bytes spill stores" in ln:
                spill = int(ln.split(" bytes spill stores")[0].split()[-1])
            elif "Used " in ln and " registers" in ln:
                smem = (int(ln.split(" bytes smem")[0].split()[-1])
                        if " bytes smem" in ln else 0)
                out.append((name, int(ln.split("Used ")[1].split()[0]), spill, smem))
    return out


def mega_build(mangled: str) -> tuple:
    """((dtype, mm, threads), AB bits) of mega_kernel<T, MODE, NT, AB> by its
    name: AB 0 is the solve (sos_mega), AB_I1IN the solve with the first
    order from the host (sos_mega_i1in)."""
    import re

    t, mode, nt, ab = re.search(r"mega_kernelI([fd])Li(\d)ELi(\d+)ELi(\d+)E",
                                mangled).groups()
    return ({"f": "float32", "d": "float64"}[t],
            {"0": "highest", "1": "bf16x3", "2": "bf16x5"}[mode], int(nt)), int(ab)


def tc_kernel_label(mangled: str) -> str:
    """'passA bf16x3' for tc::quad_mma<1, LoadFields<float>, ...>, 'passI',
    'fused_source' for LoadSurfaceExp, LoadFieldRows."""
    import re

    mode = {"1": "bf16x3", "2": "bf16x5"}[re.search(r"quad_mmaILi(\d)E", mangled).group(1)]
    user = ("fused_source " if "LoadFieldRows" in mangled else
            "passA " if "LoadFields" in mangled else "passI ")
    return user + mode


def down_kernel_label(mangled: str):
    """'float32' for down_sweep<float>, None for another kernel."""
    import re

    m = re.search(r"down_sweepI([fd])E", mangled)
    if m is None:
        return None
    return "float32" if m.group(1) == "f" else "float64"


SPLIT_KERNELS = ("pass_b_band", "pass_b_up", "pass_b_smooth", "up_sweep_walk",
                 "up_sweep_joins", "up_sweep_rows")


def split_kernel_label(mangled: str):
    """'pass_b_up float32 bf16x3' for sos::pb::pass_b_up<float, 1>, etc.;
    None for a kernel that is no stage of passB or up_sweep_smooth."""
    import re

    m = re.search(r"(%s)I([fd])(?:Li(\d)E)?" % "|".join(SPLIT_KERNELS), mangled)
    if m is None:
        return None
    name, t, mode = m.groups()
    label = f"{name} {'float32' if t == 'f' else 'float64'}"
    return label + (f" {['highest', 'bf16x3', 'bf16x5'][int(mode)]}" if mode else "")


def phase_card():
    import torch

    from sos_rt_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    # the tensor-core mainloop's kernels; sos_mega's registers and spills
    # against MEGA_PTXAS_SIMT and MEGA_PTXAS_TC
    tc_smem = cuda_build.library("megastream").sos_tc_smem()
    tc_kernels = [{"kernel": tc_kernel_label(name), "registers": regs,
                   "spill_store_bytes": spill, "static_smem_bytes": smem,
                   "dynamic_smem_bytes": tc_smem}
                  for name, regs, spill, smem in ptxas_entries(
                      cuda_build._lib_path("megastream") + ".log") if "quad_mma" in name]
    if len(tc_kernels) != 4:
        fail(f"megastream.cu built {len(tc_kernels)} tensor-core kernels, not 4")
    # the split-mode source kernel's two builds (bf16x3, bf16x5) on the same
    # mainloop
    src_kernels = [{"kernel": tc_kernel_label(name), "registers": regs,
                    "spill_store_bytes": spill, "static_smem_bytes": smem,
                    "dynamic_smem_bytes": tc_smem}
                   for name, regs, spill, smem in ptxas_entries(
                       cuda_build._lib_path("fused_source") + ".log") if "quad_mma" in name]
    if sorted(k["kernel"] for k in src_kernels) != ["fused_source bf16x3",
                                                      "fused_source bf16x5"]:
        fail(f"fused_source.cu built {[k['kernel'] for k in src_kernels]}")
    # the stage kernels of passB (csrc/pass_b_split.cuh) and up_sweep_smooth
    stages = [{"kernel": split_kernel_label(name), "registers": regs,
               "spill_store_bytes": spill, "static_smem_bytes": smem}
              for src in ("megastream", "fused_sweeps")
              for name, regs, spill, smem in ptxas_entries(
                  cuda_build._lib_path(src) + ".log") if split_kernel_label(name)]
    if len(stages) != 16:
        fail(f"{len(stages)} stage kernels of passB and up_sweep_smooth were built, not 16")
    # the down sweep's two builds (float32, float64)
    down = [{"kernel": down_kernel_label(name), "registers": regs,
             "spill_store_bytes": spill}
            for name, regs, spill, _ in ptxas_entries(
                cuda_build._lib_path("fused_sweeps") + ".log") if down_kernel_label(name)]
    if len(down) != 2:
        fail(f"fused_sweeps.cu built {len(down)} down-sweep kernels, not 2")
    builds = {}
    for name, regs, spill, _ in ptxas_entries(cuda_build._lib_path("megakernel") + ".log"):
        key, ab = mega_build(name)
        builds.setdefault(ab, {})[key] = (regs, spill)
    mega, i1in = builds.get(0, {}), builds.get(MEGA_AB_I1IN, {})
    if (set(builds) != {0, MEGA_AB_I1IN} or set(mega) != set(i1in)
            or set(mega) != set(MEGA_PTXAS_SIMT) | set(MEGA_PTXAS_TC)):
        fail(f"megakernel.cu built {[(ab, sorted(b)) for ab, b in builds.items()]}")
    changed = {k: mega[k] for k, ref in MEGA_PTXAS_SIMT.items() if mega[k] != ref}
    changed.update({k: mega[k] for k, (regs, spill) in MEGA_PTXAS_TC.items()
                    if mega[k][0] != regs or mega[k][1] > spill})
    if changed:
        fail(f"sos_mega's registers or spills moved: {changed} "
             f"(SIMT {MEGA_PTXAS_SIMT}, tensor cores {MEGA_PTXAS_TC})")
    ptxas = {}
    for name in cuda_build.SOURCES:
        if name in cuda_build.ABLATE_SOURCES + ("megastream_ablate",):
            continue
        log = cuda_build._lib_path(name) + ".log"
        with open(log) if os.path.exists(log) else open(os.devnull) as fh:
            ptxas[name] = [ln.strip() for ln in fh
                           if "registers" in ln or "spill" in ln]
    # the ablated builds: one summary line for their 42 kernels, the 14 of
    # float32 'bf16x3' (on the tensor cores) apart
    span = lambda v: [min(v, default=None), max(v, default=None)]
    abl = [e for src in cuda_build.ABLATE_SOURCES
           for e in ptxas_entries(cuda_build._lib_path(src) + ".log")]
    ptxas["mega_ablate"] = {
        key: {"kernels": len(e), "registers": span([r for _, r, _, _ in e]),
              "spill_store_bytes": span([sp for _, _, sp, _ in e])}
        for key, e in (("tensor_cores", [x for x in abl if "kernelIfLi1E" in x[0]]),
                       ("simt", [x for x in abl if "kernelIfLi1E" not in x[0]]))}
    # the streamed passes' ablated build: one summary line for its kernels
    sabl = ptxas_entries(cuda_build._lib_path("megastream_ablate") + ".log")
    ptxas["megastream_ablate"] = {"kernels": len(sabl),
                                  "registers": span([r for _, r, _, _ in sabl]),
                                  "spill_store_bytes": span([sp for _, _, sp, _ in sabl])}
    emit({"phase": "card", "nvidia_smi": nvidia_smi(),
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": round(build_s, 3),
          "compiled": sorted(built),
          "build_s_by_source": {k: round(v, 1) for k, v in built.items()},
          "tensor_core_kernels": tc_kernels, "fused_source_kernels": src_kernels,
          "stage_kernels": stages, "down_sweep_kernels": down,
          "sos_mega_ptxas": {f"{d} {m} {nt}": v for (d, m, nt), v in sorted(mega.items())},
          "sos_mega_i1in_ptxas": {f"{d} {m} {nt}": v
                                  for (d, m, nt), v in sorted(i1in.items())},
          "ptxas": ptxas})


def phase_kernels(device):
    """Returns {sweep kernel: max absolute error against plain, float32}."""
    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import GridSpec, SolverOptions
    from sos_rt_tpu_torch.ops import megastream as ms
    from sos_rt_tpu_torch.presets import get_preset

    grid = GridSpec(56, 64)
    rng = np.random.default_rng(SEED)
    scenes = random_scenes(get_preset("hg"), 8, device, rng)
    results = []
    sweep_abs = {}
    for dtype, mm, tol in (("float64", "highest", 1e-12),
                           ("float32", "bf16x3", 1e-5),
                           ("float32", "highest", 1e-5)):
        for surface in ("lambertian", "specular"):
            opts = SolverOptions(surface=surface, dtype=dtype, mm=mm)
            tables = test_tables(grid, device, getattr(torch, dtype))
            (pack, cpar, tiles), ops = block_inputs(scenes, tables, grid, opts, device)
            ms.reset_launches()
            rel, _, _ = kernel_vs_plain(pack, cpar, tiles, ops)
            tc_route_ok(launch_counts(), ms.takes_tensor_cores(ops.dtype, mm),
                        f"kernels {dtype} {mm} {surface}")
            results.append({"dtype": dtype, "mm": mm, "surface": surface,
                            "tol": tol, "rel_err": rel})
            for name, e in rel.items():
                if not e <= tol:
                    fail(f"{name} {dtype} {mm} {surface}: {e:.3e} > {tol}")
    mega = []
    for dtype, mm, tol in (("float64", "highest", 1e-12),
                           ("float32", "bf16x3", F32_KERNEL_TOL),
                           ("float32", "bf16x5", F32_KERNEL_TOL)):
        for surface in ("lambertian", "specular"):
            from sos_rt_tpu_torch.fused import prepare_batch

            opts = SolverOptions(surface=surface, dtype=dtype, mm=mm)
            sb = prepare_batch(scenes, test_tables(grid, device, getattr(torch, dtype)),
                               grid, opts, device=device)
            ms.reset_launches()
            rel, _, _ = mega_vs_plain(sb.pack, sb.cpar, sb.tiles, sb.ops, opts, tol,
                                      f"{dtype} {mm} {surface}")
            if launch_counts()["mega_call_tc"] != (dtype == "float32"):
                fail(f"mega_call {dtype} {mm} {surface}: launches {launch_counts()}")
            mega.append({"dtype": dtype, "mm": mm, "surface": surface, "tol": tol,
                         "rel_err": rel})
    from sos_rt_tpu_torch.fused import FusedBatch

    sweeps = []
    for dtype in ("float64", "float32"):
        for surface in ("lambertian", "specular"):
            opts = SolverOptions(surface=surface, dtype=dtype)
            fb = FusedBatch(scenes, test_tables(grid, device, getattr(torch, dtype)),
                            grid, opts, device)
            rel, absd = sweeps_vs_plain(sweep_calls(fb, second_order_source(fb)), dtype,
                                        f"{dtype} {surface}")
            sweeps.append({"dtype": dtype, "surface": surface, "tol": SWEEP_TOL[dtype],
                           "rel_err": rel})
            if dtype == "float32":
                for k, v in absd.items():
                    sweep_abs[k] = max(sweep_abs.get(k, 0.0), v)
    emit({"phase": "kernels", "grid": [56, 64], "batch": 8, "cases": results,
          "mega_call": mega, "sweeps": sweeps})
    return sweep_abs


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


def device_ms_by_kernel(fn, names, reps: int = 3) -> dict:
    """Device milliseconds per call of ``fn`` spent in the kernels whose
    names contain each of ``names``: torch.profiler with CUDA activities
    over ``reps`` calls after a warm-up; None where the trace shows no
    device time for a name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name in names:
        us = sum((getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0))
                 for ev in events if name in ev.key)
        out[name] = us / 1e3 / reps if us > 0 else None
    return out


def product_flops(kind: str, L: int, C: int, Mp: int, ops) -> int:
    """Floating-point operations of a call's quad product, counting each
    bf16 pass of the split mode (passA: K = 2Mp; passI: K = Mp, none for a
    specular surface)."""
    k = 2 * Mp if kind == "passA" else (Mp if ops.lamb else 0)
    return 2 * 4 * Mp * k * L * C * SPLIT_PASSES[ops.mm]


def phase_canonical(device):
    import dataclasses

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
    launches = launch_counts()
    check_path_launches(launches, grid, torch.float32, "canonical")
    tc_route_ok(launches, True, "canonical")
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
    # passA's time split into its product (the tensor-core mainloop,
    # csrc/quad_mma.cuh) and the downward recurrence, by kernel name in a
    # profiler trace; the products' achieved rate in bf16 split-pass FLOPs
    split = device_ms_by_kernel(calls["passA"][0], ("quad_mma", "down_scan"))
    # passB's time split into its three kernels (csrc/pass_b_split.cuh)
    passb_stages = device_ms_by_kernel(calls["passB"][0], SPLIT_KERNELS[:3])
    by_name = {k["name"]: k for k in kernels}
    # passI's closed form alone: the same block with a specular surface,
    # whose passI has no product (K = 0)
    (spk, scp, sti), sops = block_inputs(scenes, tables, grid,
                                         dataclasses.replace(opts, surface="specular"),
                                         device, cols_per_block=128)
    closed_form_ms = timed(lambda: ms.passI(spk, sti, scp, sops), 5)
    rate = lambda kind, t: (product_flops(kind, L, C, Mp, ops) / (t * 1e-3) / 1e12
                            if t else None)
    tensor_cores = {
        "passA": {"product_ms": split["quad_mma"], "down_scan_ms": split["down_scan"],
                  "tflops": rate("passA", split["quad_mma"]),
                  "product_bound_ms": product_flops("passA", L, C, Mp, ops)
                  / PEAK_OPS["bf16"] * 1e3},
        "passI": {"ms": by_name["passI"]["ms"], "closed_form_ms": closed_form_ms,
                  "tflops": rate("passI", by_name["passI"]["ms"]),
                  "product_bound_ms": product_flops("passI", L, C, Mp, ops)
                  / PEAK_OPS["bf16"] * 1e3},
        "peak_tflops": PEAK_OPS["bf16"] / 1e12}
    emit({"phase": "canonical", "grid": [grid.nb_angles, grid.nb_layers],
          "batch": B, "cols_per_block": 128, "dtype": "float32", "mm": "bf16x3",
          "metrics": metrics, "launches": launches, "f64_check": f64_check,
          "block_shape": [L, C, Mp], "tensor_cores": tensor_cores,
          "passB_stages_ms": passb_stages})
    return kernels


def phase_fwc_sweep(device):
    """Returns {kernel: max absolute error against plain} over this path's
    block shapes."""
    import dataclasses

    import numpy as np
    import torch

    from sos_rt_tpu_torch.fused import (MAX_COLS_PER_BLOCK, coarse_problem,
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
    launches = launch_counts()
    check_path_launches(launches, preset.grid, torch.float32, "fwc_sweep")
    mega_tc_ok(launches, "fwc_sweep")
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

    # the streamed kernels at the shapes the streamed solve of this batch
    # gives them: the sweep's first block (the default block size) and the
    # coarse grid's block
    (pack, cpar, tiles), ops = block_inputs(scenes, tables, preset.grid,
                                            preset.opts, device)
    ms.reset_launches()
    rel_k, abs_k, (fdn, fup, sdn, jn) = kernel_vs_plain(pack, cpar, tiles, ops)
    tc_route_ok(launch_counts(), True, "fwc_sweep, the sweep's block")
    cg, ct = coarse_problem(tables, preset.grid, device)
    (cpk, ccp, cti), cops = block_inputs(scenes, ct, cg, preset.opts, device,
                                         cols_per_block=MAX_COLS_PER_BLOCK)
    ms.reset_launches()
    rel_c, abs_c, _ = kernel_vs_plain(cpk, ccp, cti, cops)
    tc_route_ok(launch_counts(), True, "fwc_sweep, the coarse block")
    for where, rel in (("fwc block", rel_k), ("coarse block", rel_c)):
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
          "coarse_block_shape": [cpk.shape[1], cpk.shape[2], cops.mp],
          "rel_err": {"block": rel_k, "coarse": rel_c},
          "block_ms": kernel_ms})
    return {name: max(abs_k[name], abs_c[name]) for name in abs_k}


def mega_bound_ms(n_orders, L: int, Mp: int, ops, itemsize: int, host_i1=False):
    """Least time (ms) for mega_call on a batch whose columns took
    ``n_orders`` orders: its products' operations (per column the I1
    surface product once and the source product once per further order,
    each 2·rows·K·L per pass of the mm mode) over the peak rate for their
    type, against its compulsory bytes (the 22 pack rows it reads, the I1
    tiles, cpar, the operators, four summary rows and the stats) over the
    memory rate.  ``host_i1`` (sos_mega_i1in): no I1 product, and in place
    of the I1 inputs (11 pack rows, the tiles, cpar's constant, the surface
    operator) the two (L, C, Mp) planes of the host's I1."""
    C = int(n_orders.numel())
    passes = SPLIT_PASSES[ops.mm]
    op_type = "bf16" if ops.mm != "highest" else (
        "float64" if itemsize == 8 else "float32")
    nsplit = 2 if ops.mm != "highest" else 1
    orders = int((n_orders - 1).sum())
    flops = 2 * 4 * Mp * 2 * Mp * L * passes * orders
    if ops.lamb and not host_i1:
        flops += 2 * 4 * Mp * Mp * L * passes * C
    if host_i1:
        nbytes = itemsize * (11 * L * C + 2 * L * C * Mp + C + 4 * C * Mp + 3 * C
                             + nsplit * (8 * Mp * Mp + Mp * Mp))
    else:
        nbytes = itemsize * (22 * L * C + 25 * C * Mp + 2 * C + 4 * C * Mp + 3 * C
                             + nsplit * (8 * Mp * Mp + 4 * Mp * Mp + Mp * Mp))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[op_type] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def mega_library_ms(n_orders, L: int, Mp: int, ops, host_i1=False):
    """mega_call's product-only yardstick (ms): one FP32 torch.matmul of the
    batch's source product, (C·L × 2Mp)·(2Mp × 4Mp), times the source
    products the batch needs per column (the mean of n − 1), plus one of
    I1's surface product (C·L × Mp)·(Mp × 4Mp) for a Lambertian surface
    whose I1 the kernel evaluates (not ``host_i1``).  The epilogues,
    recurrences and pass B are not in it."""
    import torch

    from sos_rt_tpu_torch.config import full_precision_matmul

    full_precision_matmul()                  # FP32, not TF32
    C, dev = int(n_orders.numel()), ops.colc.device
    g = torch.Generator(device=dev).manual_seed(SEED)
    mat = lambda r, k: torch.rand((r, k), generator=g, device=dev)
    x, w = mat(C * L, 2 * Mp), mat(4 * Mp, 2 * Mp)
    total = timed(lambda: torch.matmul(x, w.T), 3) * float((n_orders - 1).mean())
    if ops.lamb and not host_i1:
        x1, w1 = mat(C * L, Mp), mat(4 * Mp, Mp)
        total += timed(lambda: torch.matmul(x1, w1.T), 3)
    return total


def fwc_batch(device, B: int = 4096):
    """The fwc_sweep phase's batch: the fwc_sweep preset, one shared µ0
    table, (ρ, τ*_aer, ω_aer) drawn per column from SEED."""
    import numpy as np
    import torch

    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables

    preset = get_preset("fwc_sweep")
    scenes = random_scenes(preset, B, device, np.random.default_rng(SEED))
    tables = {dt: PhaseTables.from_models(preset.grid, 0.5, atm=preset.atm,
                                          aer=preset.aer, dtype=dt, device=device)
              for dt in (torch.float32, torch.float64)}
    return preset, scenes, tables


def timed_solve(fn):
    import torch

    from sos_rt_tpu_torch.ops import megastream as ms

    torch.cuda.synchronize()
    ms.reset_launches()
    t0 = time.perf_counter()
    sol = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, sol, launch_counts()


def phase_resident(device):
    """Resident against streamed on the 4096-column sweep batch.  Returns
    the kernels-line entry of mega_call (launches filled in by the caller)."""
    import dataclasses

    import torch

    from sos_rt_tpu_torch import fused
    from sos_rt_tpu_torch.fused import (coarse_problem, prepare_batch,
                                        solve_batch_mega, take_columns)
    from sos_rt_tpu_torch.metrics import solution_metrics
    from sos_rt_tpu_torch.ops import megakernel as mk

    preset, scenes, tables = fwc_batch(device)
    B = scenes.mu0.shape[0]
    solve = lambda stream, **kw: solve_batch_mega(
        scenes, tables[torch.float32], preset.grid, preset.opts, outputs="summary",
        sort="predict", stream=stream, device=device, **kw)
    runs = {False: [], True: []}
    for stream in (False, True, True, False, False, True):   # in turns
        runs[stream].append(timed_solve(lambda: solve(stream)))
    (_, res, res_l), (_, stm, stm_l) = runs[False][-1], runs[True][-1]
    # the solve proper, without the predictor pre-solve (which may run the
    # other execution): resident launches mega_call and no pass, streamed
    # the passes and no mega_call
    by_score = lambda stream: solve_batch_mega(
        scenes, tables[torch.float32], preset.grid, preset.opts, outputs="summary",
        sort=True, stream=stream, device=device)
    _, _, res_own = timed_solve(lambda: by_score(False))
    _, _, stm_own = timed_solve(lambda: by_score(True))
    if not (res_l["mega_call"] >= 1 and res_own["mega_call"] == 1
            and res_own["passI"] == res_own["passA"] == res_own["passB"] == 0):
        fail(f"resident call launched {res_l}, without predictor {res_own}")
    mega_tc_ok(res_l, "resident call")
    mega_tc_ok(res_own, "resident call without predictor")
    if not (stm_own["mega_call"] == 0 and stm_own["passA"] > 0 and stm_own["passB"] > 0
            and stm_l["passA"] > 0):
        fail(f"streamed call launched {stm_l}, without predictor {stm_own}")
    # float32: both products on the tensor cores, in two mainloops
    # (MEGA_BATCH_LIMITS)
    rows = lambda s: torch.cat([s.i_toa, s.i_surface], 1)
    summary = lambda s: (s.i_toa, s.i_surface)
    vs_streamed, _ = loops_within_limits(res.n_orders, stm.n_orders, summary(res),
                                         summary(stm), "resident vs streamed")
    if not (stm_own["passA"] == stm_own["passA_tc"] and stm_own["passI"] == stm_own["passI_tc"]):
        fail(f"the streamed float32 solve left the tensor cores: {stm_own}")

    # 8 columns in float64, both executions
    sub = torch.arange(8, device=device) * (B // 8)
    o64 = dataclasses.replace(preset.opts, dtype="float64")
    _, r64, r64_l = timed_solve(lambda: solve_batch_mega(
        take_columns(scenes, sub), tables[torch.float64], preset.grid, o64,
        outputs="summary", stream=False, device=device))
    if not (r64_l["mega_call"] == 1 and r64_l["mega_call_tc"] == 0):
        fail(f"the resident float64 solve did not run the SIMT product: {r64_l}")
    _, s64, s64_l = timed_solve(lambda: solve_batch_mega(
        take_columns(scenes, sub), tables[torch.float64], preset.grid, o64,
        outputs="summary", stream=True, device=device))
    if not (s64_l["passA"] > 0 and s64_l["passA_tc"] == s64_l["passI_tc"] == 0):
        fail(f"the streamed float64 solve did not run the SIMT product: {s64_l}")
    if not torch.equal(r64.n_orders, s64.n_orders):
        fail("float64 resident and streamed order counts differ")
    if not torch.allclose(rows(r64), rows(s64), rtol=1e-12, atol=0.0):
        fail(f"float64 resident vs streamed: {rel_err(rows(r64), rows(s64)):.3e}")

    # the predictor's coarse 8x16 solve, both executions
    cg, ct = coarse_problem(tables[torch.float32], preset.grid, device)
    coarse = {}
    for stream, cpb in ((True, fused.MAX_COLS_PER_BLOCK), (False, None)) * 2:
        coarse[stream] = timed_solve(lambda: solve_batch_mega(
            scenes, ct, cg, preset.opts, outputs="summary", sort=False,
            cols_per_block=cpb, stream=stream, device=device))
    coarse_vs_streamed, _ = loops_within_limits(
        coarse[False][1].n_orders, coarse[True][1].n_orders, summary(coarse[False][1]),
        summary(coarse[True][1]), "coarse predictor solve, resident vs streamed")
    csb = prepare_batch(scenes, ct, cg, preset.opts, device=device,
                        cols_per_block=mk.default_cols_per_tile(mk.pad_angles(cg.nb_angles)))
    f64_of = lambda sc, tb, gr, cb: lambda cols: (
        prepare_batch(take_columns(sc, cols), tb, gr, o64, cols_per_block=cb,
                      device=device), o64)
    cg64, ct64 = coarse_problem(tables[torch.float64], preset.grid, device)
    _, coarse_abs, coarse_vs_plain = mega_vs_plain(
        csb.pack, csb.cpar, csb.tiles, csb.ops, preset.opts, F32_KERNEL_TOL,
        "at the predictor's coarse batch",
        f64_batch=f64_of(scenes, ct64, cg64, csb.cols_per_block))

    # mega_call alone on the batch in the order the solve gives it
    key = fused.sort_key(scenes, tables[torch.float32], preset.grid, preset.opts,
                         "predict", device)
    perm = torch.argsort(key, stable=True)
    cb = mk.default_cols_per_tile(mk.pad_angles(preset.grid.nb_angles))
    sorted_scenes = take_columns(scenes, perm)
    sb = prepare_batch(sorted_scenes, tables[torch.float32], preset.grid,
                       preset.opts, cols_per_block=cb, device=device)
    kw = dict(tol=float(preset.opts.tol), max_orders=int(preset.opts.max_orders),
              full=False)
    call = lambda: mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    rel, absd, vs_plain = mega_vs_plain(sb.pack, sb.cpar, sb.tiles, sb.ops,
                                        preset.opts, F32_KERNEL_TOL,
                                        "at the sweep batch",
                                        f64_batch=f64_of(sorted_scenes,
                                                         tables[torch.float64],
                                                         preset.grid, cb))
    n_orders = call()[-1][mk.ST_N]
    L, Mp = preset.grid.nb_layers, sb.ops.mp
    bms, by = mega_bound_ms(n_orders, L, Mp, sb.ops, sb.pack.element_size())
    lib_ms = mega_library_ms(n_orders, L, Mp, sb.ops)
    entry = {"name": "mega_call", "route": "cuda", "source": MEGA_SOURCE,
             "replaces": REPLACES["mega_call"], "launches": 0,
             "max_abs_err": max(absd, coarse_abs), "max_rel_err": rel,
             "ms": timed(call, 3),
             "plain_ms": timed(lambda: mk.mega_plain(sb.pack, sb.cpar, sb.tiles,
                                                     sb.ops, **kw), 1),
             "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
    emit({"phase": "resident", "grid": [64, 128], "batch": B, "sort": "predict",
          "cols_per_tile": cb, "vs_streamed": vs_streamed, "limits": MEGA_BATCH_LIMITS,
          "vs_streamed_equal": bool(torch.equal(rows(res), rows(stm))
                                    and torch.equal(res.n_orders, stm.n_orders)),
          "f64_rows_rel_diff": rel_err(rows(r64), rows(s64)),
          "launches_without_predictor": {"resident": res_own, "streamed": stm_own},
          "resident": {"wall_s": [r[0] for r in runs[False]], "launches": res_l,
                       "metrics": solution_metrics(res, wall_s=runs[False][-1][0])},
          "streamed": {"wall_s": [r[0] for r in runs[True]], "launches": stm_l,
                       "metrics": solution_metrics(stm, wall_s=runs[True][-1][0])},
          "stream_none_runs": "streamed" if fused.resolve_stream(
              None, preset.grid, torch.float32) else "resident",
          "predictor_8x16": {"streamed_s": coarse[True][0], "resident_s": coarse[False][0],
                             "runs": "streamed" if fused.resolve_stream(
                                 None, cg, torch.float32) else "resident",
                             "vs_streamed": coarse_vs_streamed,
                             "vs_plain": coarse_vs_plain},
          "mega_call": {**{k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")},
                        "vs_plain": vs_plain, "limits": MEGA_BATCH_LIMITS}})
    return entry


def phase_sweep_cli(device):
    """The sweep command at full width.  Returns mega_call's launches on
    this run."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import numpy as np
    import torch

    from sos_rt_tpu_torch import cli
    from sos_rt_tpu_torch.fused import SweepSummary, take_columns
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.sweep import build_sweep_batch, load_sweep

    B, chunk = 16384, 4096
    out_dir = os.path.join(HERE, "build", "sos_rt_tpu_torch", "sweep_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["sweep", "--preset", "fwc_sweep", "--batch", str(B), "--chunk", str(chunk),
            "-o", out_dir, "--metrics", os.path.join(out_dir, "metrics.json")]

    def run(extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            wall, _, launches = timed_solve(lambda: cli.main(argv + extra))
        lines = [ln for ln in buf.getvalue().splitlines() if "sweep_metrics" in ln]
        if len(lines) != 1:
            fail(f"sweep_cli printed {len(lines)} sweep_metrics lines")
        return wall, launches, json.loads(lines[0])["sweep_metrics"]

    wall, launches, m = run([])
    preset = get_preset("fwc_sweep")
    check_path_launches(launches, preset.grid, torch.float32, "sweep_cli")
    # per chunk one launch for the coarse predictor pre-solve, one for the solve
    if launches["mega_call"] != 2 * (B // chunk):
        fail(f"sweep_cli: {launches['mega_call']} mega_call launches for "
             f"{B // chunk} chunks")
    mega_tc_ok(launches, "sweep_cli")
    res = load_sweep(out_dir)
    M = preset.grid.nb_angles
    for k in ("i_toa", "i_surface"):
        if res[k].shape != (B, 2 * M) or not np.isfinite(res[k]).all():
            fail(f"sweep_cli: {k} has shape {res[k].shape} or non-finite values")
    if not (res["converged"].all() and m["complete"] and m["n_unconverged"] == 0):
        fail(f"sweep_cli: unconverged columns: {m}")

    # 8 columns against the float64 solve of the same scenes on the card
    scenes, _ = build_sweep_batch(preset, B, seed=0, mu0_pool=64, device=device)
    _, t64 = build_sweep_batch(preset, B, seed=0, mu0_pool=64, dtype=torch.float64,
                               device=device)
    sub = torch.arange(8, device=device) * (B // 8)
    ref = solve_batch(take_columns(scenes, sub), t64.take(sub), preset.grid,
                      dataclasses.replace(preset.opts, dtype="float64"),
                      engine="mega", outputs="summary", device=device)
    on_card = lambda k: torch.as_tensor(res[k], device=device)
    sol = SweepSummary(i_toa=on_card("i_toa"), i_surface=on_card("i_surface"),
                       n_orders=on_card("n_orders"), converged=on_card("converged"),
                       tau=None, idx_up=None, idx_down=None)
    f64_check = f32_vs_f64(sol, ref, sub, "sweep_cli")

    wall2, launches2, m2 = run(["--resume"])
    if any(launches2.values()) or "wall_s" in m2 or not m2["complete"]:
        fail(f"sweep_cli --resume solved again: {launches2} {m2}")
    emit({"phase": "sweep_cli", "grid": [M, preset.grid.nb_layers], "batch": B,
          "chunk": chunk, "mu0_pool": 64, "argv": argv[:7], "metrics": m,
          "col_per_s": m["col_per_s"], "call_wall_s": wall, "launches": launches,
          "f64_check": f64_check, "resume": {"call_wall_s": wall2, "metrics": m2}})
    return launches["mega_call"]


def phase_fused_f64(device):
    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import GridSpec, SolverOptions
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.presets import get_preset

    out = {"phase": "fused_f64", "batch": 8, "cases": []}
    for grid, surface in ((GridSpec(56, 64), "lambertian"), (GridSpec(56, 64), "specular"),
                          (GridSpec(51, 24, spacing="gauss"), "lambertian")):
        opts = SolverOptions(surface=surface, dtype="float64")
        sols = []
        for dev in (device, torch.device("cpu")):
            rng = np.random.default_rng(SEED)
            scenes = random_scenes(get_preset("hg"), 8, dev, rng)
            _, sol, launches = timed_solve(lambda: solve_batch(
                scenes, test_tables(grid, dev, torch.float64), grid, opts,
                engine="fused", device=dev))
            sols.append(sol)
            if dev.type == "cuda":
                fused_launches_ok(launches, int(sol.n_orders.max()), "fused_f64")
        gpu, cpu = sols
        what = f"fused_f64 {grid} {surface}"
        if not torch.equal(gpu.n_orders.cpu(), cpu.n_orders):
            fail(f"{what}: order counts differ {gpu.n_orders.tolist()} vs "
                 f"{cpu.n_orders.tolist()}")
        for name in ("i_total", "i1"):
            a, b = getattr(gpu, name).cpu(), getattr(cpu, name)
            if not torch.allclose(a, b, rtol=1e-9, atol=1e-11 * float(b.abs().max())):
                fail(f"{what}: {name} max rel err {rel_err(a, b):.3e}")
        out["cases"].append({"grid": [grid.nb_angles, grid.nb_layers, grid.spacing],
                             "surface": surface, "n_orders": cpu.n_orders.tolist(),
                             "rel_err": rel_err(gpu.i_total.cpu(), cpu.i_total)})
    emit(out)


def source_bound_ms(rows: int, m: int, wcopy, mm: str):
    """Least time (ms) for one split-mode source call on an H100: X in and
    J_n out (rows x 2M float32 each), the bf16 operator copy and the
    per-column inputs over the memory rate, against the split passes' bf16
    operations (rows x 2M x 4M products a pass) over the dense bf16 rate."""
    nbytes = 2 * rows * 2 * m * 4 + wcopy.numel() * 2
    flops = 2 * rows * 2 * m * 4 * m * SPLIT_PASSES[mm]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS["bf16"] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def source_library_ms(dn, up, wcopy, mm: str, reps: int = 5):
    """The source's products as one cuBLAS call: the split passes side by
    side, X's parts [x1 | x2 | x1 (| x3 | x2)] (rows, passes x 2M) bf16
    against [hi; hi; lo (; hi; lo)] (passes x 2M, 4M), one torch.mm with a
    float32 result (no split, no mixing).  Returns (ms or None, what)."""
    import torch

    from sos_rt_tpu_torch.ops.precision import split_operand

    m, mp, dev = dn.shape[-1], wcopy.shape[1] // 4, dn.device
    x = torch.cat([dn, up], dim=2).reshape(-1, 2 * m)
    xs = [p.to(torch.bfloat16) for p in split_operand(x, mm, torch.float32)]
    k = torch.cat([torch.arange(m), mp + torch.arange(m)]).to(dev)
    rows = torch.cat([q * mp + torch.arange(m) for q in range(4)]).to(dev)
    hi, lo = (wcopy[i][rows][:, k].T.contiguous() for i in range(2))
    terms = [(0, hi), (1, hi), (0, lo)] + ([(2, hi), (1, lo)] if mm == "bf16x5" else [])
    xcat = torch.cat([xs[i] for i, _ in terms], dim=1)
    wcat = torch.cat([w for _, w in terms], dim=0)
    what = (f"one torch.mm of ({xcat.shape[0]} x {xcat.shape[1]}) x ({wcat.shape[0]} x "
            f"{wcat.shape[1]}) bf16, float32 out")
    try:
        torch.mm(xcat[:8], wcat, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        why = str(e).splitlines()[0][:160]
        return None, f"torch {torch.__version__}: torch.mm takes no float32 out_dtype ({why})"
    return timed(lambda: torch.mm(xcat, wcat, out_dtype=torch.float32), reps), what


def fused_source_block(fb, launches: int):
    """The split-mode source kernel at the fused batch's block: against
    fused_source_plain in both modes (F32_KERNEL_TOL of scale), then in the
    batch's mode timed on second_order_source beside the plain version (the
    twelve float32 cuBLAS products and the mixing), its bound and the
    library call.  Returns its kernels-line entry."""
    import torch

    from sos_rt_tpu_torch.ops import fused_source as fsrc

    m = fb.M
    dn, up = fb.i1[:, :, :m], fb.i1[:, :, m:]
    rel, absd = {}, 0.0
    for mm in ("bf16x3", "bf16x5"):
        got = fsrc.fused_source(dn, up, fb.wcopy, fb.cols, mm)
        torch.cuda.synchronize()
        want = fsrc.fused_source_plain(dn, up, fb.wcopy, fb.cols, mm)
        if not bool(torch.isfinite(got).all()):
            fail(f"fused_source {mm}: non-finite values")
        rel[mm] = rel_err(got, want)
        absd = max(absd, float((got - want).abs().max()))
        if not rel[mm] <= F32_KERNEL_TOL:
            fail(f"fused_source {mm} at the fused canonical block: rel err {rel[mm]:.3e} "
                 f"> {F32_KERNEL_TOL}")
        del got, want
    bms, by = source_bound_ms(fb.B * fb.L, m, fb.wcopy, fb.mm)
    lib_ms, lib_what = source_library_ms(dn, up, fb.wcopy, fb.mm)
    return {"name": "fused_source", "route": "cuda", "source": SPLIT_SOURCE,
            "replaces": REPLACES["fused_source"],
            "note": "not a Pallas kernel: the JAX package's split products",
            "launches": launches, "max_abs_err": absd, "max_rel_err": rel,
            "ms": timed(lambda: second_order_source(fb), 5),
            "plain_ms": timed(lambda: fsrc.fused_source_plain(dn, up, fb.wcopy, fb.cols,
                                                              fb.mm), 2),
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms, "library": lib_what,
            "block_shape": [fb.B, fb.L, m], "mm": fb.mm}


def phase_fused_canonical(device, sweep_abs):
    """The fused engine's path at full width.  Returns the kernels-line
    entries of the two sweep kernels and of the source kernel."""
    import dataclasses

    import numpy as np
    import torch

    from unittest import mock

    from sos_rt_tpu_torch import fused
    from sos_rt_tpu_torch.config import SolverOptions
    from sos_rt_tpu_torch.fused import FusedBatch, take_columns, to_summary
    from sos_rt_tpu_torch.metrics import solution_metrics
    from sos_rt_tpu_torch.ops.fused_source import fused_source_plain
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.parallel.mesh import mega_small_ok
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables

    preset = get_preset("hg")
    grid, B = preset.grid, 64
    opts = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3")
    scenes = dataclasses.replace(
        random_scenes(preset, B, device, np.random.default_rng(SEED)),
        tau_star_atm=torch.full((B,), 0.044, dtype=torch.float64, device=device))
    if mega_small_ok(scenes, grid):
        fail("fused_canonical: mega_small_ok is true, the batch would not take the "
             "fused engine")
    tables = {dt: PhaseTables.from_models(grid, 0.5, atm=preset.atm, aer=preset.aer,
                                          dtype=dt, device=device)
              for dt in (torch.float32, torch.float64)}
    torch.cuda.reset_peak_memory_stats()
    wall, sol, launches = timed_solve(lambda: solve_batch(
        scenes, tables[torch.float32], grid, opts, engine="mega", outputs="summary",
        device=device))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fused_launches_ok(launches, int(sol.n_orders.max()), "fused_canonical", split=True)
    if not (bool(torch.isfinite(sol.i_toa).all())
            and bool(torch.isfinite(sol.i_surface).all())):
        fail("fused_canonical summary rows are not finite")
    if tuple(sol.i_toa.shape) != (B, 2 * grid.nb_angles):
        fail(f"fused_canonical summary shape {tuple(sol.i_toa.shape)}")

    # 8 columns against the float64 fused solve on the card
    sub = torch.arange(8, device=device) * (B // 8)
    ref = to_summary(solve_batch(take_columns(scenes, sub), tables[torch.float64], grid,
                                 SolverOptions(surface="lambertian", dtype="float64"),
                                 engine="fused", device=device))
    f64_check = f32_vs_f64(sol, ref, sub, "fused_canonical")
    # the same solve with the plain source (the split products), against the
    # kernel's: two whole float32 loops, MEGA_BATCH_LIMITS
    with mock.patch.object(fused, "fused_source", fused_source_plain):
        plain_wall, plain_sol, plain_launches = timed_solve(lambda: solve_batch(
            scenes, tables[torch.float32], grid, opts, engine="mega", outputs="summary",
            device=device))
    if plain_launches["fused_source"]:
        fail(f"fused_canonical: the plain-source solve launched {plain_launches}")
    vs_plain, _ = loops_within_limits(sol.n_orders, plain_sol.n_orders,
                                      (sol.i_toa, sol.i_surface),
                                      (plain_sol.i_toa, plain_sol.i_surface),
                                      "fused_canonical kernel source vs plain source")
    vs_plain["plain_source_col_per_s"] = B / plain_wall

    # each sweep kernel at this run's block (the whole batch)
    fb = FusedBatch(scenes, tables[torch.float32], grid, opts, device)
    L, M = grid.nb_layers, grid.nb_angles
    jn = second_order_source(fb)
    calls = sweep_calls(fb, jn)
    rel, absd = sweeps_vs_plain(calls, "float32", "at the canonical block")
    times = sweep_block_times(calls, B, L, M, 4, jn[:, :, :M])
    # up_sweep_smooth's time split into its three kernels
    up_stages = device_ms_by_kernel(calls["up_sweep_smooth"][0], SPLIT_KERNELS[3:])
    source = fused_source_block(fb, launches["fused_source"])
    emit({"phase": "fused_canonical", "grid": [M, L], "batch": B, "dtype": "float32",
          "mm": "bf16x3", "tau_star_atm": 0.044, "entered_as": "engine='mega'",
          "mega_small_ok": False, "metrics": solution_metrics(sol, wall_s=wall),
          "launches": launches, "f64_check": f64_check, "peak_memory_gb": peak_gb,
          "kernel_vs_plain_source": vs_plain, "block_shape": [B, L, M], "rel_err": rel,
          "block": times, "up_sweep_stages_ms": up_stages, "fused_source": source})
    return [{"name": name, "route": "cuda", "source": FUSED_SOURCE,
             "replaces": REPLACES[name], "launches": launches[name],
             "max_abs_err": max(absd[name], sweep_abs[name]), "max_rel_err": rel[name],
             **times[name], "library_ms": None} for name in calls] + [source]


def phase_fused_sweep(device):
    """The sweep batch through the fused engine beside the mega engine.
    Returns {sweep kernel: max absolute error against plain}."""
    import torch

    from sos_rt_tpu_torch.fused import FusedBatch
    from sos_rt_tpu_torch.metrics import solution_metrics
    from sos_rt_tpu_torch.parallel import solve_batch

    preset, scenes, tables = fwc_batch(device)
    B = scenes.mu0.shape[0]
    t32 = tables[torch.float32]
    runs = {"fused": [], "mega": []}
    for engine in ("mega", "fused", "fused", "mega"):           # in turns
        outputs = "summary" if engine == "mega" else "full"
        runs[engine].append(timed_solve(lambda: solve_batch(
            scenes, t32, preset.grid, preset.opts, engine=engine, outputs=outputs,
            sort="predict", device=device)))
    (wall, sol, launches), (mega_wall, mega, _) = runs["fused"][-1], runs["mega"][-1]
    fused_launches_ok(launches, int(sol.n_orders.max()), "fused_sweep")
    if not bool(torch.isfinite(sol.i_total).all()):
        fail("fused_sweep: non-finite values")
    differs = float((sol.n_orders != mega.n_orders).float().mean())
    if not differs <= FUSED_N_DIFFERS_FRAC:
        fail(f"fused_sweep: order counts differ from the mega engine's in "
             f"{differs:.3%} of the columns (limit {FUSED_N_DIFFERS_FRAC:.1%})")
    same = sol.n_orders == mega.n_orders
    rows = torch.cat([sol.i_total[:, 0], sol.i_total[:, -1]], 1)[same]
    mega_rows = torch.cat([mega.i_toa, mega.i_surface], 1)[same]
    keep = mega_rows.abs() > 1e-12 * mega_rows.abs().max()
    p50 = float(((rows - mega_rows).abs()[keep] / mega_rows.abs()[keep]).median())
    if not p50 < F64_P50_TOL:
        fail(f"fused_sweep: p50 relative difference to the mega engine {p50:.3e}")
    del sol, runs
    torch.cuda.empty_cache()

    fb = FusedBatch(scenes, t32, preset.grid, preset.opts, device)
    L, M = preset.grid.nb_layers, preset.grid.nb_angles
    jn = second_order_source(fb)
    calls = sweep_calls(fb, jn)
    rel, absd = sweeps_vs_plain(calls, "float32", "at the sweep block")
    emit({"phase": "fused_sweep", "grid": [M, L], "batch": B,
          "fused": {"wall_s": wall, "col_per_s": B / wall, "launches": launches},
          "mega": {"wall_s": mega_wall, "col_per_s": B / mega_wall,
                   "metrics": solution_metrics(mega, wall_s=mega_wall)},
          "n_differs_frac": differs, "n_differs_limit": FUSED_N_DIFFERS_FRAC,
          "p50_rel_to_mega": p50, "block_shape": [B, L, M], "rel_err": rel,
          "block": sweep_block_times(calls, B, L, M, 4, jn[:, :, :M])})
    return absd


def no_launches(launches: dict, phase: str):
    """Fail unless the run launched no kernel (the reference engine is
    plain PyTorch)."""
    if any(launches.values()):
        fail(f"{phase}: the reference engine launched kernels: {launches}")


def same_solutions(a, b, rtol: float, what: str) -> float:
    """Fail unless two full solutions have equal order counts and fields
    within ``rtol`` (atol 1e-11 of scale).  Returns the largest difference
    of scale."""
    import torch

    if not torch.equal(a.n_orders.cpu(), b.n_orders.cpu()):
        fail(f"{what}: order counts differ {a.n_orders.tolist()} vs "
             f"{b.n_orders.tolist()}")
    x, y = a.i_total.cpu(), b.i_total.cpu()
    if not torch.allclose(x, y, rtol=rtol, atol=1e-11 * float(y.abs().max())):
        fail(f"{what}: max rel err {rel_err(x, y):.3e}")
    return rel_err(x, y)


def phase_reference_f64(device):
    """The reference engine in float64 on the card against the CPU."""
    import dataclasses

    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import GridSpec, SolverOptions
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.presets import get_preset

    grid = GridSpec(56, 64)
    out = {"phase": "reference_f64", "grid": [56, 64], "batch": 8, "cases": []}
    for surface in ("lambertian", "specular"):
        for scan_impl in ("associative", "sequential"):
            opts = SolverOptions(surface=surface, dtype="float64", scan_impl=scan_impl)
            sols = []
            for dev in (device, torch.device("cpu")):
                scenes = random_scenes(get_preset("hg"), 8, dev,
                                       np.random.default_rng(SEED))
                _, sol, launches = timed_solve(lambda: solve_batch(
                    scenes, test_tables(grid, dev, torch.float64), grid, opts,
                    engine="reference", device=dev))
                sols.append(sol)
            no_launches(launches, "reference_f64")
            what = f"reference_f64 {surface} {scan_impl}"
            err = same_solutions(*sols, 1e-9, what)
            same_solutions(dataclasses.replace(sols[0], i_total=sols[0].i1),
                           dataclasses.replace(sols[1], i_total=sols[1].i1), 1e-9,
                           what + " i1")
            out["cases"].append({"surface": surface, "scan_impl": scan_impl,
                                 "n_orders": sols[1].n_orders.tolist(), "rel_err": err})
    emit(out)


def phase_reference(device):
    """The reference engine at full width: the hg preset on the 501×800
    grid, B=64."""
    import dataclasses

    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import SolverOptions
    from sos_rt_tpu_torch.fused import take_columns, to_summary
    from sos_rt_tpu_torch.metrics import solution_metrics
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables

    preset = get_preset("hg")
    grid, B = preset.grid, 64
    scenes = random_scenes(preset, B, device, np.random.default_rng(SEED))
    tables = {dt: PhaseTables.from_models(grid, 0.5, atm=preset.atm, aer=preset.aer,
                                          dtype=dt, device=device)
              for dt in (torch.float32, torch.float64)}
    opts = {dt: SolverOptions(surface="lambertian", dtype=dt)
            for dt in ("float32", "float64")}
    solve = lambda s, t, o, **kw: solve_batch(s, t, grid, o, device=device, **kw)
    out = {"phase": "reference", "grid": [grid.nb_angles, grid.nb_layers], "batch": B}

    # float32, full-precision products (mm=None); the first call pays the
    # first use of this batch's shapes, the second is the one reported
    run32 = lambda: solve(scenes, tables[torch.float32], opts["float32"])
    torch.cuda.empty_cache()
    first_wall = timed_solve(run32)[0]
    torch.cuda.reset_peak_memory_stats()
    wall, sol32, launches = timed_solve(run32)
    no_launches(launches, "reference")
    if not bool(torch.isfinite(sol32.i_total).all()):
        fail("reference: float32 values are not finite")
    out["float32"] = {"mm": None, "first_wall_s": first_wall,
                      "metrics": solution_metrics(sol32, wall_s=wall),
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    sub = torch.arange(8, device=device) * (B // 8)
    s8 = take_columns(scenes, sub)
    ref8 = solve(s8, tables[torch.float64], opts["float64"], engine="reference")
    out["float32"]["f64_check"] = f32_vs_f64(to_summary(sol32), to_summary(ref8), sub,
                                             "reference")
    del sol32
    torch.cuda.empty_cache()

    # the same 8 columns in bf16x3: the source kernel once an order
    o3 = dataclasses.replace(opts["float32"], mm="bf16x3")
    wall3, sol3, launches3 = timed_solve(lambda: solve(s8, tables[torch.float32], o3))
    want = {k: 0 for k in launches3}
    want["fused_source"] = int(sol3.n_orders.max()) - 1
    if launches3 != want:
        fail(f"reference bf16x3: launches {launches3}, expected {want}")
    out["bf16x3_8"] = {"wall_s": wall3, "launches": {"fused_source": want["fused_source"]},
                       "f64_check": f32_vs_f64(to_summary(sol3), to_summary(ref8),
                                               torch.arange(8, device=device),
                                               "reference bf16x3")}
    del sol3

    # float64, the whole batch, against the mega engine on the card
    torch.cuda.reset_peak_memory_stats()
    wall64, sol64, _ = timed_solve(lambda: solve(scenes, tables[torch.float64],
                                                 opts["float64"]))
    peak64 = torch.cuda.max_memory_allocated() / 1e9
    mega_wall, mega64, mega_launches = timed_solve(lambda: solve(
        scenes, tables[torch.float64], opts["float64"], engine="mega"))
    check_path_launches(mega_launches, grid, torch.float64, "reference (mega float64)")
    err = same_solutions(sol64, mega64, 1e-9, "reference float64 vs mega float64")
    out["float64"] = {"metrics": solution_metrics(sol64, wall_s=wall64),
                      "peak_memory_gb": peak64, "mega_wall_s": mega_wall,
                      "rel_err_to_mega": err}
    del sol64, mega64
    torch.cuda.empty_cache()

    # the sequential scans on 8 of the columns (800 steps a sweep)
    seq = dataclasses.replace(opts["float32"], scan_impl="sequential")
    wall_seq, sol_seq, _ = timed_solve(lambda: solve(s8, tables[torch.float32], seq))
    wall_assoc, sol_assoc, _ = timed_solve(lambda: solve(s8, tables[torch.float32],
                                                         opts["float32"]))
    if not torch.equal(sol_seq.n_orders, sol_assoc.n_orders):
        fail(f"reference: sequential scans' order counts {sol_seq.n_orders.tolist()} "
             f"vs associative {sol_assoc.n_orders.tolist()}")
    out["sequential_8"] = {"wall_s": wall_seq, "associative_wall_s": wall_assoc,
                           "n_orders": sol_seq.n_orders.tolist(),
                           "rel_to_associative": rel_err(sol_seq.i_total,
                                                         sol_assoc.i_total)}
    emit(out)


# the run command's cases: the hg preset, its default (eva: log-normal Mie,
# Lambertian) and wildfire (log-normal Mie, specular surface)
RUN_CLI_CASES = (("hg", ["--preset", "hg"]), ("eva", []),
                 ("wildfire", ["--preset", "wildfire"]))


def phase_run_cli(device):
    """``python -m sos_rt_tpu_torch run`` in a process of its own for each of
    RUN_CLI_CASES, against the mega engine in float64 on the card."""
    import numpy as np
    import torch

    from sos_rt_tpu_torch.parallel import broadcast_scene, solve_batch
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables, solve_column

    out_dir = os.path.join(HERE, "build", "sos_rt_tpu_torch", "run_cli")
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for name, flags in RUN_CLI_CASES:
        path = os.path.join(out_dir, f"{name}.npz")
        argv = [sys.executable, "-m", "sos_rt_tpu_torch", "run", *flags, "-o", path]
        t0 = time.perf_counter()
        res = subprocess.run(argv, cwd=HERE, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f"run_cli {name} exited {res.returncode}: {res.stderr[-2000:]}")
        with np.load(path) as z:
            got = {k: z[k] for k in z.files}
        for k in ("flux_up", "flux_down", "net_flux", "diffusivity", "heating_rate", "I"):
            if not np.isfinite(got[k]).all():
                fail(f"run_cli {name}: {k} has non-finite values")
        preset = get_preset(name)
        tables = PhaseTables.from_models(preset.grid, 0.5, atm=preset.atm,
                                         aer=preset.aer, dtype=torch.float64,
                                         device=device)
        mega = solve_batch(broadcast_scene(preset.scene, 1, device=device), tables,
                           preset.grid, preset.opts, engine="mega", device=device)
        want = mega.i_total[0].cpu().numpy()
        if int(got["n_orders"]) != int(mega.n_orders[0]):
            fail(f"run_cli {name}: {int(got['n_orders'])} orders, the mega engine "
                 f"{int(mega.n_orders[0])}")
        if not np.allclose(got["I"], want, rtol=1e-9, atol=1e-11 * np.abs(want).max()):
            fail(f"run_cli {name}: I differs from the mega engine's, max rel "
                 f"{np.abs(got['I'] - want).max() / np.abs(want).max():.3e}")
        # the same column's solve warm, in this process (the command's own
        # "solved in" line times the first solve of a fresh process)
        warm = [timed_solve(lambda: solve_column(preset.scene, tables, preset.grid,
                                                 preset.opts, device=device))[0]
                for _ in range(2)]
        solved = [ln for ln in res.stderr.splitlines() if "solved in" in ln]
        runs.append({
            "preset": name, "argv": argv[2:-2], "surface": preset.opts.surface,
            "warm_solve_s": warm, "wall_s": wall,
            "solve_line": solved[0] if solved else None,
            "n_orders": int(got["n_orders"]),
            "rel_err_to_mega": float(np.abs(got["I"] - want).max() / np.abs(want).max()),
            "toa_net_flux": float(-got["flux_down"][0] - got["flux_up"][0])})
    grid = get_preset("hg").grid
    emit({"phase": "run_cli", "grid": [grid.nb_angles, grid.nb_layers],
          "dtype": "float64", "runs": runs})


def phase_critical_albedo(device):
    """The critical-albedo command (mega engine, float32, 16 lanes) at
    501×800 on the hg preset and on its default preset (eva), then for each
    the batched bisection against the per-column one in float64 on 4
    lanes."""
    import contextlib
    import dataclasses
    import io

    import torch

    from sos_rt_tpu_torch import cli
    from sos_rt_tpu_torch.forcing import critical_albedo, critical_albedo_batch
    from sos_rt_tpu_torch.parallel import broadcast_scene
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables

    out_dir = os.path.join(HERE, "build", "sos_rt_tpu_torch")
    os.makedirs(out_dir, exist_ok=True)
    out = {"phase": "critical_albedo", "dtype": "float32", "engine": "mega",
           "runs": []}
    for name, flags in (("hg", ["--preset", "hg"]), ("eva", [])):
        out_path = os.path.join(out_dir, f"critical_albedo_{name}.json")
        argv = ["critical-albedo", *flags, "--tau-aer", "0.02,0.5", "--num", "16",
                "-o", out_path]
        with contextlib.redirect_stderr(io.StringIO()):
            wall, _, launches = timed_solve(lambda: cli.main(argv))
        preset = get_preset(name)
        check_path_launches(launches, preset.grid, torch.float32,
                            f"critical_albedo {name}")
        tc_route_ok(launches, True, f"critical_albedo {name}")
        with open(out_path) as f:
            res = json.load(f)
        curve = res["critical_albedo"]
        if (res["preset"] != name or len(curve) != 16
                or not all(0.0 <= a <= 1.0 for a in curve.values())):
            fail(f"critical_albedo {name}: {res}")

        taus = torch.tensor([0.02, 0.1, 0.25, 0.5], dtype=torch.float64, device=device)
        scenes = dataclasses.replace(broadcast_scene(preset.scene, 4, device=device),
                                     tau_star_aer=taus)
        tables = PhaseTables.from_models(preset.grid, 0.5, atm=preset.atm,
                                         aer=preset.aer, dtype=torch.float64,
                                         device=device)
        t0 = time.perf_counter()
        batch = critical_albedo_batch(scenes, tables, preset.grid, preset.opts,
                                      engine="mega", device=device)
        t1 = time.perf_counter()
        column = critical_albedo(scenes, tables, preset.grid, preset.opts, device=device)
        t2 = time.perf_counter()
        if not torch.allclose(batch, column, rtol=1e-9, atol=1e-12):
            fail(f"critical_albedo {name}: batched {batch.tolist()} vs per-column "
                 f"{column.tolist()}")
        out["runs"].append({
            "preset": name, "argv": argv[:-2],
            "grid": [preset.grid.nb_angles, preset.grid.nb_layers], "wall_s": wall,
            "launches": launches, "curve": curve,
            "f64_lanes": {"tau_star_aer": taus.tolist(), "albedo": column.tolist(),
                          "batch_mega_wall_s": t1 - t0, "column_wall_s": t2 - t1}})
    emit(out)


def phase_mie_tables():
    """The eva and wildfire presets' log-normal Mie tables at 501 angles,
    built anew (cache=False) on the host: which core built them (the native
    one, built with g++ from sos_rt_tpu_torch/csrc/miecore.cpp, or the NumPy
    series; the phase fails without the native core: g++ is where nvcc
    is), the wall time of each, and their normalizations (∫P0 dµ = 2, each
    column of P 4)."""
    import numpy as np

    from sos_rt_tpu_torch.models import _native, build_phase_tables
    from sos_rt_tpu_torch.presets import get_preset

    native = _native.get_lib() is not None
    if not native:
        fail("mie_tables: the native Mie core did not build or load")
    out = {"phase": "mie_tables", "native_core": native,
           "library": os.path.relpath(_native.lib_path(), HERE), "tables": {}}
    for name in ("eva", "wildfire"):
        preset = get_preset(name)
        kind, params = preset.aer
        mu, w = preset.grid.mu(), preset.grid.trapz_weights()
        t0 = time.perf_counter()
        p0, p = build_phase_tables(kind, mu, 0.5, cache=False, **params)
        wall = time.perf_counter() - t0
        m2 = 2 * preset.grid.nb_angles
        if p0.shape != (m2,) or p.shape != (m2, m2) or not (
                np.isfinite(p0).all() and np.isfinite(p).all()):
            fail(f"mie_tables {name}: shapes {p0.shape}, {p.shape} or non-finite")
        norms = [abs(float(np.sum(p0 * w)) - 2.0) / 2.0,
                 float(np.abs(p.T @ w - 4.0).max()) / 4.0]
        if not max(norms) <= 1e-10:
            fail(f"mie_tables {name}: normalizations off by {norms}")
        out["tables"][name] = {"kind": kind, "angles": preset.grid.nb_angles,
                               "wall_s": wall, "norm_rel_err": norms}
    emit(out)


def phase_i1_host(device):
    """The mega engine with the first order from the host (i1='host'): the
    64×128 sweep batch resident (sos_mega_i1in) and the canonical batch
    streamed (no passI).  Returns the kernels-line entry of sos_mega_i1in."""
    import dataclasses

    import numpy as np
    import torch

    from sos_rt_tpu_torch import fused
    from sos_rt_tpu_torch.config import SolverOptions
    from sos_rt_tpu_torch.fused import prepare_batch, solve_batch_mega, take_columns
    from sos_rt_tpu_torch.ops import megakernel as mk
    from sos_rt_tpu_torch.parallel.mesh import mega_small_ok
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables

    preset, scenes, tables = fwc_batch(device)
    B, grid = scenes.mu0.shape[0], preset.grid
    f32, f64 = tables[torch.float32], tables[torch.float64]
    solve = lambda i1, sc, tb, opts: solve_batch_mega(
        sc, tb, grid, opts, outputs="summary", sort="predict", stream=False, i1=i1,
        device=device)
    # the main path: every count 0 just before, read just after
    wall_h, host, host_l = timed_solve(lambda: solve("host", scenes, f32, preset.opts))
    wall_k, kern, kern_l = timed_solve(lambda: solve("kernel", scenes, f32, preset.opts))
    if not (host_l["mega_call_i1in"] == 1 and host_l["passI"] == 0
            and host_l["mega_call"] == kern_l["mega_call"]
            and kern_l["mega_call_i1in"] == 0):
        fail(f"i1_host: launches {host_l}, with the kernel's I1 {kern_l}")
    mega_tc_ok(host_l, "i1_host")
    summary = lambda s: (s.i_toa, s.i_surface)
    host_vs_kernel, _ = loops_within_limits(host.n_orders, kern.n_orders, summary(host),
                                            summary(kern), "i1_host: host vs kernel I1")
    # 8 columns in float64: equal order counts
    sub = torch.arange(8, device=device) * (B // 8)
    o64 = dataclasses.replace(preset.opts, dtype="float64")
    h64, k64 = (solve(i1, take_columns(scenes, sub), f64, o64) for i1 in ("host", "kernel"))
    if not torch.equal(h64.n_orders, k64.n_orders):
        fail(f"i1_host float64: order counts {h64.n_orders.tolist()} vs "
             f"{k64.n_orders.tolist()}")
    rows = lambda s: torch.cat([s.i_toa, s.i_surface], 1)
    f64_rel = rel_err(rows(h64), rows(k64))
    if not f64_rel <= 1e-12:
        fail(f"i1_host float64: host vs kernel I1 rows {f64_rel:.3e}")

    # sos_mega_i1in against mega_plain from the same planes, and timed beside
    # sos_mega, on the batch in the order the solve gives it
    key = fused.sort_key(scenes, f32, grid, preset.opts, "predict", device)
    perm = torch.argsort(key, stable=True)
    cb = mk.default_cols_per_tile(mk.pad_angles(grid.nb_angles))
    sorted_scenes = take_columns(scenes, perm)
    prep = lambda sc, tb, opts, i1: prepare_batch(sc, tb, grid, opts, cols_per_block=cb,
                                                  device=device, i1=i1)
    sb, sbk = prep(sorted_scenes, f32, preset.opts, "host"), prep(
        sorted_scenes, f32, preset.opts, "kernel")
    rel, absd, vs_plain = mega_vs_plain(
        sb.pack, sb.cpar, sb.tiles, sb.ops, preset.opts, F32_KERNEL_TOL,
        "sos_mega_i1in at the sweep batch", planes=sb.i1_planes(),
        f64_batch=lambda cols: (prep(take_columns(sorted_scenes, cols), f64, o64,
                                     "host"), o64))
    kw = dict(tol=float(preset.opts.tol), max_orders=int(preset.opts.max_orders),
              full=False)
    planes = sb.i1_planes()
    call = lambda: mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw, **planes)
    call_kernel = lambda: mk.mega_call(sbk.pack, sbk.cpar, sbk.tiles, sbk.ops, **kw)
    n_orders = call()[-1][mk.ST_N]
    L, Mp = grid.nb_layers, sb.ops.mp
    times = {"sos_mega_i1in": [], "sos_mega": []}
    for _ in range(2):                         # in turns, in one call
        times["sos_mega_i1in"].append(timed(call, 3))
        times["sos_mega"].append(timed(call_kernel, 3))
    bms, by = mega_bound_ms(n_orders, L, Mp, sb.ops, sb.pack.element_size(), host_i1=True)
    entry = {"name": "mega_call_i1in", "route": "cuda", "source": MEGA_SOURCE,
             "replaces": REPLACES["mega_call_i1in"],
             "launches": host_l["mega_call_i1in"], "max_abs_err": absd,
             "max_rel_err": rel, "ms": min(times["sos_mega_i1in"]),
             "plain_ms": vs_plain.pop("plain_ms"),
             "bound_ms": bms, "bound_by": by,
             "library_ms": mega_library_ms(n_orders, L, Mp, sb.ops, host_i1=True)}

    # the canonical batch, streamed: no passI, passA and passB as with the
    # kernels' I1
    canon = get_preset("hg")
    copts = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3")
    cscenes = random_scenes(canon, 256, device, np.random.default_rng(SEED))
    ctables = PhaseTables.from_models(canon.grid, 0.5, atm=canon.atm, aer=canon.aer,
                                      dtype=torch.float32, device=device)
    # the grid has small-µ columns: the mega path takes the batch where each
    # column's polyfit band covers them, as solve_batch(engine='mega') checks
    covered = mega_small_ok(cscenes, canon.grid)
    if not covered:
        fail("i1_host canonical: the batch would go to the fused engine")
    csolve = lambda i1: solve_batch_mega(cscenes, ctables, canon.grid, copts,
                                         outputs="summary", cols_per_block=128, i1=i1,
                                         allow_small=covered, device=device)
    torch.cuda.reset_peak_memory_stats()
    cwall_h, chost, chost_l = timed_solve(lambda: csolve("host"))
    cpeak = torch.cuda.max_memory_allocated() / 1e9
    cwall_k, ckern, ckern_l = timed_solve(lambda: csolve("kernel"))
    if not (chost_l["passI"] == 0 and ckern_l["passI"] > 0
            and (chost_l["passA"], chost_l["passB"]) == (ckern_l["passA"], ckern_l["passB"])
            and chost_l["passA"] == chost_l["passA_tc"] > 0):
        fail(f"i1_host canonical: launches {chost_l}, with the kernels' I1 {ckern_l}")
    if not (bool(torch.isfinite(chost.i_toa).all())
            and bool(torch.isfinite(chost.i_surface).all())):
        fail("i1_host canonical: summary rows are not finite")
    dn = (chost.n_orders - ckern.n_orders).abs()
    emit({"phase": "i1_host", "grid": [grid.nb_angles, grid.nb_layers], "batch": B,
          "sort": "predict",
          "wall_s": {"host": wall_h, "kernel": wall_k},
          "launches": {"host": host_l, "kernel": kern_l},
          "host_vs_kernel": host_vs_kernel, "limits": MEGA_BATCH_LIMITS,
          "f64_8": {"n_orders": h64.n_orders.tolist(), "rows_rel": f64_rel},
          "sos_mega_i1in": {**{k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                                     "bound_by", "library_ms")},
                            "vs_plain": vs_plain, "ms_in_turns": times},
          "canonical": {"grid": [canon.grid.nb_angles, canon.grid.nb_layers],
                        "batch": 256, "wall_s": {"host": cwall_h, "kernel": cwall_k},
                        "peak_memory_gb_host": cpeak,
                        "launches": {"host": chost_l, "kernel": ckern_l},
                        "n_differs": int((dn > 0).sum()),
                        "rows_rel": max(rel_err(a, b) for a, b in zip(
                            summary(chost), summary(ckern)))}})
    return entry


# van de Hulst's angles at which the single-layer solve is read
VDH_MU = (0.1, 0.3, 0.5, 0.7, 0.9, 1.0)


def phase_single_layer(device):
    """tests/test_vdh.py's semi-infinite case on the card: one isotropic
    slab, 96 angles × 2400 layers, τ* = 25, ω = 0.8, µ0 = 0.5, float64:
    the card against the CPU (equal order counts, rtol 1e-9) and against
    the published H-function law (ω/4)H(µ)H(µ0)/(µ+µ0) at µ ≥ 0.3 (rtol
    1e-3, as test_vdh.py); no kernel launched."""
    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import GridSpec, SolverOptions
    from sos_rt_tpu_torch.models import build_phase_tables
    from sos_rt_tpu_torch.single_layer import solve_single_layer, vdh_extract
    from sos_rt_tpu_torch.validation import semi_infinite_reflection

    grid = GridSpec(nb_angles=96, nb_layers=2400)
    opts = SolverOptions(max_orders=120, dtype="float64")
    mu0, omega, tau_star = 0.5, 0.8, 25.0
    tables = build_phase_tables("iso", grid.mu(), mu0)
    run = lambda dev: solve_single_layer(mu0, tau_star, tables, grid, opts, alb=omega,
                                         device=dev)
    walls, sols = {}, {}
    for name, dev in (("card", device), ("card_warm", device),
                      ("cpu", torch.device("cpu"))):
        walls[name], sols[name], launches = timed_solve(lambda: run(dev))
        no_launches(launches, "single_layer")
    card, cpu = sols["card"], sols["cpu"]
    if not (int(card.n_orders) == int(cpu.n_orders) and bool(card.converged)):
        fail(f"single_layer: orders {int(card.n_orders)} on the card, "
             f"{int(cpu.n_orders)} on the CPU (converged {bool(card.converged)})")
    a, b = card.i_total.cpu(), cpu.i_total
    if not torch.allclose(a, b, rtol=1e-9, atol=1e-11 * float(b.abs().max())):
        fail(f"single_layer: card vs CPU {rel_err(a, b):.3e}")
    mu = np.asarray(VDH_MU)
    up, _ = vdh_extract(card.i_total, grid, mu_values=mu)
    want = semi_infinite_reflection(mu, mu0, omega)
    sel = mu >= 0.3
    theory = float(np.max(np.abs(up[sel] - want[sel]) / np.abs(want[sel])))
    if not theory <= 1e-3:
        fail(f"single_layer: {theory:.3e} off the H-function law (rtol 1e-3)")
    emit({"phase": "single_layer", "grid": [96, 2400], "tau_star": tau_star,
          "omega": omega, "mu0": mu0, "dtype": "float64",
          "n_orders": int(card.n_orders), "wall_s": walls,
          "card_vs_cpu_rel": rel_err(a, b), "vs_h_function_rel": theory,
          "i_up_vdh": dict(zip(VDH_MU, up.tolist()))})


def phase_sweep_orders(device):
    """run_sweep(save_orders=True) on the sweep preset, 4096 columns, one
    shard; 8 columns against solve_column_orders on the card."""
    import shutil

    import numpy as np
    import torch

    from sos_rt_tpu_torch.fused import take_columns
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import solve_column_orders
    from sos_rt_tpu_torch.sweep import build_sweep_batch, load_sweep, run_sweep

    preset = get_preset("fwc_sweep")
    B = 4096
    out_dir = os.path.join(HERE, "build", "sos_rt_tpu_torch", "sweep_orders")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    wall, m, launches = timed_solve(lambda: run_sweep(
        preset, B, mu0_pool=64, chunk=B, out_dir=out_dir, save_orders=True,
        device=device))
    no_launches(launches, "sweep_orders")
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = load_sweep(out_dir)
    K, M2 = preset.opts.max_orders, 2 * preset.grid.nb_angles
    for k in ("orders_toa", "orders_surface"):
        if res[k].shape != (B, K, M2) or not np.isfinite(res[k]).all():
            fail(f"sweep_orders: {k} has shape {res[k].shape} or non-finite values")
    if not (np.array_equal(res["order_valid"].sum(1), res["n_orders"])
            and m["complete"]):
        fail(f"sweep_orders: valid slots do not count the orders: {m}")
    scenes, tables = build_sweep_batch(preset, B, mu0_pool=64, device=device)
    worst = 0.0
    for c in range(0, B, B // 8):
        sol, buf, valid = solve_column_orders(
            take_columns(scenes, [c]), tables.take([c]), preset.grid, preset.opts,
            save_rows=(0, -1), device=device)
        if not np.array_equal(valid.cpu().numpy(), res["order_valid"][c]):
            fail(f"sweep_orders: column {c}: valid {valid.tolist()} vs "
                 f"{res['order_valid'][c].tolist()}")
        for r, k in ((0, "orders_toa"), (1, "orders_surface")):
            want = buf[:, r].cpu().numpy()
            err = np.abs(res[k][c] - want).max() / np.abs(want).max()
            if not err <= 1e-5:
                fail(f"sweep_orders: column {c} {k} off by {err:.3e} of scale")
            worst = max(worst, float(err))
    emit({"phase": "sweep_orders", "grid": [64, 128], "batch": B, "chunk": B,
          "mu0_pool": 64, "dtype": preset.opts.dtype, "metrics": m,
          "col_per_s": m["col_per_s"], "call_wall_s": wall, "peak_memory_gb": peak,
          "checked_columns": 8, "max_rel_to_column": worst})


# the columns of tests/test_torch_edge_layers.py, (z_up, z_down) km on a
# 48-angle x 40-layer grid from z0 = 120 km: an aerosol layer that reaches
# the bottom layer (the mega engine hands such a batch to the fused engine)
# and one that starts in the top layer
EDGE_GRID = (48, 40)
EDGE_COLUMNS = {"bottom": ((25.0, 0.1), (25.0, 0.3), (25.0, 1.0), (3.0, 0.5)),
                "top": ((119.0, 17.0), (120.0, 17.0))}


def edge_scenes(zs, device):
    """The default scene over len(zs) columns with the given layer bounds
    and albedos / aerosol depths spread as tests/torch_cases.jax_scenes
    spreads them."""
    import dataclasses

    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import Scene
    from sos_rt_tpu_torch.parallel import broadcast_scene

    B = len(zs)
    t = lambda v: torch.as_tensor(np.asarray(v, np.float64), device=device)
    return dataclasses.replace(broadcast_scene(Scene(), B, device=device),
                               z_up=t([z[0] for z in zs]), z_down=t([z[1] for z in zs]),
                               grd_alb=t(np.linspace(0.0, 0.8, B)),
                               tau_star_aer=t(np.linspace(0.02, 0.35, B)),
                               alb_aer=t(np.linspace(0.7, 1.0, B)))


def phase_edge_layers(device):
    """An aerosol layer in the bottom or the top layer on the card: the
    reference engine, the mega engine resident and streamed, and the fused
    engine, in float64 (against the reference engine on the CPU: equal order
    counts, rtol 1e-9) and float32 (equal order counts, p50 relative error
    below F64_P50_TOL); every field finite; the mega engine's launches show
    the fused engine taking the bottom batch and the mega kernels the top
    one."""
    import torch

    from sos_rt_tpu_torch.config import GridSpec, SolverOptions
    from sos_rt_tpu_torch.fused import solve_batch_fused, solve_batch_mega
    from sos_rt_tpu_torch.ops import megastream as ms
    from sos_rt_tpu_torch.parallel import solve_batch

    grid, cpu = GridSpec(*EDGE_GRID), torch.device("cpu")
    engines = {
        "reference": lambda *a: solve_batch(*a, engine="reference", device=device),
        "mega_resident": lambda *a: solve_batch_mega(*a, stream=False, device=device),
        "mega_streamed": lambda *a: solve_batch_mega(*a, stream=True, device=device),
        "fused": lambda *a: solve_batch_fused(*a, device=device)}
    out = {"phase": "edge_layers", "grid": list(EDGE_GRID), "cases": []}
    for edge, zs in EDGE_COLUMNS.items():
        ref = solve_batch(edge_scenes(zs, cpu), test_tables(grid, cpu, torch.float64), grid,
                          SolverOptions(surface="lambertian", dtype="float64"),
                          engine="reference", device=cpu)
        for dtype in ("float64", "float32"):
            tdt = getattr(torch, dtype)
            args = (edge_scenes(zs, device), test_tables(grid, device, tdt), grid,
                    SolverOptions(surface="lambertian", dtype=dtype))
            for name, run in engines.items():
                what = f"edge_layers {edge} {dtype} {name}"
                ms.reset_launches()
                sol = run(*args)
                torch.cuda.synchronize()
                launches = {k: v for k, v in launch_counts().items() if v}
                if not bool(torch.isfinite(sol.i_total).all()):
                    fail(f"{what}: non-finite field")
                if name == "reference":
                    no_launches(launches, what)
                elif name == "fused" or edge == "bottom":
                    if not launches.get("down_sweep") or launches.get("mega_call") \
                            or launches.get("passI"):
                        fail(f"{what}: expected the fused engine's kernels, got {launches}")
                elif not launches.get("mega_call" if name == "mega_resident" else "passI"):
                    fail(f"{what}: expected the mega kernels, got {launches}")
                case = {"edge": edge, "dtype": dtype, "engine": name,
                        "n_orders": sol.n_orders.tolist(), "launches": launches}
                if dtype == "float64":
                    case["rel_err"] = same_solutions(sol, ref, 1e-9, what)
                else:
                    if not torch.equal(sol.n_orders.cpu(), ref.n_orders):
                        fail(f"{what}: order counts {sol.n_orders.tolist()} vs float64 "
                             f"{ref.n_orders.tolist()}")
                    got, want = sol.i_total.cpu().double(), ref.i_total
                    keep = want.abs() > 1e-12 * want.abs().max()
                    rel = (got - want).abs()[keep] / want.abs()[keep]
                    case["p50_rel_vs_f64"] = float(rel.median())
                    if not case["p50_rel_vs_f64"] < F64_P50_TOL:
                        fail(f"{what}: p50 relative error {case['p50_rel_vs_f64']:.3e}")
                out["cases"].append(case)
    emit(out)


# the card's share of the mesh phases: the gloo group of MESH_RANKS ranks on
# the one card (CUDA tensors; NCCL takes one rank a card), the mesh the
# sharded-tables case runs on, and the layer-sharded grids
MESH_RANKS = 2
LAYER_GRID = (64, 800)
LONG_LAYERS = 65536
# the sweep of ``--gpus`` (four chunks)
GPUS_BATCH = 65536
LAYER_SCENE = dict(mu0=0.5, grd_alb=0.3, tau_star_aer=0.2)


def canonical_batch(device, B: int, dtype, **over):
    """The canonical phase's batch: the ``hg`` preset at 501×800, (ρ,
    τ*_aer, ω_aer) drawn per column from SEED, one shared µ0 table."""
    import dataclasses

    import numpy as np
    import torch

    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables

    preset = get_preset("hg")
    scenes = random_scenes(preset, B, device, np.random.default_rng(SEED))
    scenes = dataclasses.replace(scenes, **{
        k: torch.full((B,), v, dtype=torch.float64, device=device) for k, v in over.items()})
    return preset.grid, scenes, PhaseTables.from_models(
        preset.grid, 0.5, atm=preset.atm, aer=preset.aer, dtype=dtype, device=device)


def layer_problem(device, dtype, nb_layers: int = LAYER_GRID[1]):
    """The layer-sharded column: the fwc_sweep preset's 64 angles and
    phase models at ``nb_layers`` layers, LAYER_SCENE."""
    from sos_rt_tpu_torch.config import GridSpec, Scene
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables

    preset = get_preset("fwc_sweep")
    grid = GridSpec(LAYER_GRID[0], nb_layers)
    return Scene(**LAYER_SCENE), PhaseTables.from_models(
        grid, LAYER_SCENE["mu0"], atm=preset.atm, aer=preset.aer, dtype=dtype,
        device=device), grid


def mesh_rank(rank: int, world: int, store: str, out: str):
    """One rank of the gloo group on the card (run by phase ``mesh`` in a
    process of its own): the fwc batch on a (world, 1) mesh, the 8
    canonical columns with shard_tables on a (1, world) mesh, and the
    layer-sharded column on a (world,) mesh; writes its results to
    ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sos_rt_tpu_torch.config import SolverOptions
    from sos_rt_tpu_torch.fused import take_columns
    from sos_rt_tpu_torch.ops import megastream as ms
    from sos_rt_tpu_torch.parallel import make_mesh, solve_batch
    from sos_rt_tpu_torch.parallel.layer_sharded import solve_column_layer_sharded

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    res = {}
    preset, scenes, tables = fwc_batch(torch.device("cuda"))
    ms.reset_launches()
    sol = solve_batch(scenes, tables[torch.float32], preset.grid, preset.opts,
                      engine="mega", outputs="summary", mesh=make_mesh(device="cuda"))
    res["fwc_launches"] = np.array(json.dumps(launch_counts()))
    for k in ("n_orders", "i_toa", "i_surface"):
        res[f"fwc_{k}"] = getattr(sol, k).cpu().numpy()
    grid, scenes, tables = canonical_batch(torch.device("cuda"), 256, torch.float64)
    sub = torch.arange(8, device="cuda") * 32
    sol = solve_batch(take_columns(scenes, sub), tables, grid,
                      SolverOptions(surface="lambertian", dtype="float64"),
                      engine="reference", shard_tables=True,
                      mesh=make_mesh((1, world), device="cuda"))
    res["tp_n_orders"], res["tp_i_total"] = sol.n_orders.cpu().numpy(), sol.i_total.cpu().numpy()
    scene, tables, grid = layer_problem(torch.device("cuda"), torch.float64)
    sol = solve_column_layer_sharded(scene, tables, grid, SolverOptions(dtype="float64"),
                                     make_mesh((world,), ("data",), device="cuda"))
    res["ls_n_orders"], res["ls_i_total"] = sol.n_orders.cpu().numpy(), sol.i_total.cpu().numpy()
    np.savez(out, **res)
    dist.destroy_process_group()


def run_mesh_ranks(world: int) -> list:
    """mesh_rank on ``world`` processes of their own (a file store under
    build/); returns each rank's results and the wall seconds."""
    import shutil

    import numpy as np

    tmp = os.path.join(HERE, "build", "sos_rt_tpu_torch", "mesh_ranks")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    src = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
           "chip_smoke.mesh_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r), str(world),
                               os.path.join(tmp, "store"), os.path.join(tmp, f"rank{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"mesh: rank {r} of {world} failed:\n{log[-3000:]}")
    outs = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs, time.perf_counter() - t0


def phase_mesh(device):
    """Column sharding over a DeviceMesh: a world-size-1 NCCL group in this
    process, then MESH_RANKS gloo ranks on the one card.  Returns the gloo
    ranks' results (phase ``layer_sharded`` reads their layer-sharded
    column)."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from sos_rt_tpu_torch import cli
    from sos_rt_tpu_torch.config import SolverOptions
    from sos_rt_tpu_torch.fused import take_columns, to_summary
    from sos_rt_tpu_torch.parallel import make_mesh, solve_batch
    from sos_rt_tpu_torch.parallel.distributed import solve_batch_multihost
    from sos_rt_tpu_torch.sweep import load_sweep

    mesh = make_mesh()
    out = {"phase": "mesh", "world_size": dist.get_world_size(),
           "backend": dist.get_backend(), "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "cases": {}}

    def same_bits(name, a, b):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                fail(f"mesh {name}: {f.name} differs from the unsharded solve")

    def pair(name, args, need, **kw):
        """The unsharded solve sorted by the score and the meshed one, to
        the bit, with the same launches."""
        wall_p, plain, launches_p = timed_solve(lambda: solve_batch(
            *args, sort="score", device=device, **kw))
        wall_m, meshed, launches = timed_solve(lambda: solve_batch(*args, mesh=mesh, **kw))
        same_bits(name, meshed, plain)
        if launches != launches_p or any(launches[k] == 0 for k in need):
            fail(f"mesh {name}: launches {launches}, unsharded {launches_p}")
        B = plain.n_orders.shape[0]
        out["cases"][name] = {"batch": B, "col_per_s": B / wall_m,
                              "plain_col_per_s": B / wall_p, "same_bits": True,
                              "launches": {k: v for k, v in launches.items() if v}}
        return plain

    preset, scenes, tables = fwc_batch(device)
    fwc_args = (scenes, tables[torch.float32], preset.grid, preset.opts)
    fwc = pair("fwc_sweep", fwc_args, ("mega_call",), engine="mega", outputs="summary")
    grid, cscenes, ctables = canonical_batch(device, 256, torch.float32)
    f32 = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3")
    pair("canonical", (cscenes, ctables, grid, f32), ("passI", "passA", "passB"),
         engine="mega", outputs="summary", cols_per_block=128)
    fgrid, fscenes, ftables = canonical_batch(device, 64, torch.float32, tau_star_atm=0.044)
    pair("fused_canonical", (fscenes, ftables, fgrid, f32), ("down_sweep", "up_sweep_smooth"),
         engine="fused")

    # the sharded source operators on the reference engine, float64
    _, _, t64 = canonical_batch(device, 8, torch.float64)
    sub = torch.arange(8, device=device) * 32
    s8, f64 = take_columns(cscenes, sub), SolverOptions(surface="lambertian", dtype="float64")
    plain = solve_batch(s8, t64, grid, f64, engine="reference", device=device)
    tp = solve_batch(s8, t64, grid, f64, engine="reference", shard_tables=True, mesh=mesh)
    out["cases"]["reference_shard_tables"] = {
        "batch": 8, "n_orders": tp.n_orders.tolist(),
        "rel_err": same_solutions(tp, plain, 1e-12, "mesh reference_shard_tables")}
    # in bf16x3 each rank holds only some of the operators' columns: the
    # route keeps the plain split products, no source kernel
    _, _, t32 = canonical_batch(device, 8, torch.float32)
    _, tp3, launches3 = timed_solve(lambda: solve_batch(
        s8, t32, grid, f32, engine="reference", shard_tables=True, mesh=mesh))
    if any(launches3.values()):
        fail(f"mesh reference_shard_tables bf16x3: launches {launches3}")
    out["cases"]["reference_shard_tables_bf16x3"] = {
        "batch": 8, "source": "split products (ops/precision.py), no kernel",
        "f64_check": f32_vs_f64(to_summary(tp3), to_summary(plain),
                                torch.arange(8, device=device),
                                "mesh reference_shard_tables bf16x3")}

    # each rank solves the columns it holds
    wall, local, launches = timed_solve(lambda: solve_batch_multihost(
        *fwc_args, engine="mega", outputs="summary"))
    same_bits("multihost", local, fwc)
    out["cases"]["multihost"] = {"batch": fwc.n_orders.shape[0], "same_bits": True,
                                 "col_per_s": fwc.n_orders.shape[0] / wall,
                                 "launches": {k: v for k, v in launches.items() if v}}
    dist.destroy_process_group()

    # the sweep command with --mesh in a process of its own, beside the
    # same command without it, sorted by the score, in this one
    dirs = {k: os.path.join(HERE, "build", "sos_rt_tpu_torch", f"sweep_{k}")
            for k in ("mesh", "score")}
    argv = ["sweep", "--preset", "fwc_sweep", "--batch", "16384", "--chunk", "4096"]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "sos_rt_tpu_torch", *argv, "--mesh",
                          "-o", dirs["mesh"], "--metrics",
                          os.path.join(dirs["mesh"], "metrics.json")],
                         cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"mesh: sweep --mesh failed:\n{run.stderr[-3000:]}")
    with open(os.path.join(dirs["mesh"], "metrics.json")) as f:
        m = json.load(f)
    if m.get("n_devices") != 1 or not m.get("complete"):
        fail(f"mesh: sweep --mesh metrics {m}")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv + ["--sort", "score", "-o", dirs["score"]])
    got, want = load_sweep(dirs["mesh"]), load_sweep(dirs["score"])
    if sorted(got) != sorted(want) or not all(np.array_equal(got[k], want[k]) for k in want):
        fail("mesh: sweep --mesh shards differ from the unmeshed command's")
    out["sweep_cli_mesh"] = {"argv": argv + ["--mesh"], "metrics": m, "call_wall_s": wall,
                             "same_bits": True,
                             "log": [ln for ln in run.stderr.splitlines()
                                     if ln.startswith("[sos]")]}

    # MESH_RANKS gloo ranks on the card
    outs, wall = run_mesh_ranks(MESH_RANKS)
    rows = lambda o: [torch.as_tensor(o["fwc_i_toa"]), torch.as_tensor(o["fwc_i_surface"])]
    for r, o in enumerate(outs):
        if any(not np.array_equal(o[k], outs[0][k]) for k in o if k != "fwc_launches"):
            fail(f"mesh: rank {r} of the gloo run holds another result than rank 0")
        if not json.loads(str(o["fwc_launches"]))["mega_call"]:
            fail(f"mesh: rank {r} launched no mega_call")
    found, _ = loops_within_limits(torch.as_tensor(outs[0]["fwc_n_orders"]),
                                   fwc.n_orders.cpu(), rows(outs[0]),
                                   [fwc.i_toa.cpu(), fwc.i_surface.cpu()],
                                   f"mesh gloo {MESH_RANKS} ranks fwc_sweep")
    tp_ranks = dataclasses.replace(plain, n_orders=torch.as_tensor(outs[0]["tp_n_orders"]),
                                   i_total=torch.as_tensor(outs[0]["tp_i_total"]))
    out["gloo_ranks"] = {
        "world_size": MESH_RANKS, "backend": "gloo", "wall_s": wall,
        "fwc_sweep": {**found, "same_bits": bool(
            np.array_equal(outs[0]["fwc_i_toa"], fwc.i_toa.cpu().numpy())
            and np.array_equal(outs[0]["fwc_n_orders"], fwc.n_orders.cpu().numpy())),
            "launches": [json.loads(str(o["fwc_launches"])) for o in outs]},
        "reference_shard_tables": same_solutions(tp_ranks, plain, 1e-12,
                                                 "mesh gloo reference_shard_tables")}
    emit(out)
    return outs


def phase_mesh_gpus():
    """``sweep --mesh`` over every visible card (torchrun, one NCCL rank a
    card) against the same command on one card with --sort score, each in
    processes of their own: the shards within MEGA_BATCH_LIMITS (and
    whether they are equal to the bit), both commands' metrics (col/s:
    run_sweep's solve time per shard) and walls.  Run by ``--gpus``."""
    import numpy as np
    import torch

    from sos_rt_tpu_torch.ops.cuda_build import build_all
    from sos_rt_tpu_torch.sweep import load_sweep

    n = torch.cuda.device_count()
    if n < 2:
        fail(f"--gpus needs more than one card, {n} visible")
    build_all(("megakernel", "megastream"))     # once, before the ranks load them
    argv = ["sweep", "--preset", "fwc_sweep", "--batch", str(GPUS_BATCH), "--chunk",
            str(GPUS_BATCH // 4)]
    runs = {"mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     f"--nproc-per-node={n}", "-m", "sos_rt_tpu_torch", *argv, "--mesh"],
            "one_card": [sys.executable, "-m", "sos_rt_tpu_torch", *argv, "--sort", "score"]}
    out = {"phase": "mesh_gpus", "world_size": n, "argv": argv, "cards": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()}
    res = {}
    for name, cmd in runs.items():
        d = os.path.join(HERE, "build", "sos_rt_tpu_torch", f"gpus_{name}")
        t0 = time.perf_counter()
        run = subprocess.run(cmd + ["-o", d, "--metrics", os.path.join(d, "metrics.json")],
                             cwd=HERE, capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            fail(f"mesh_gpus {name} failed:\n{run.stderr[-3000:]}")
        with open(os.path.join(d, "metrics.json")) as f:
            out[name] = {"metrics": json.load(f), "call_wall_s": time.perf_counter() - t0,
                         "log": [ln for ln in run.stderr.splitlines() if ln.startswith("[sos]")]}
        res[name] = load_sweep(d)
    if out["mesh"]["metrics"]["n_devices"] != n:
        fail(f"mesh_gpus: n_devices {out['mesh']['metrics']['n_devices']}, {n} cards")
    a, b = res["mesh"], res["one_card"]
    t = lambda x: torch.as_tensor(x)
    out["found"], _ = loops_within_limits(t(a["n_orders"]), t(b["n_orders"]),
                                          [t(a["i_toa"]), t(a["i_surface"])],
                                          [t(b["i_toa"]), t(b["i_surface"])], "mesh_gpus")
    out["same_bits"] = all(np.array_equal(a[k], b[k]) for k in b)
    emit(out)


def phase_layer_sharded(device, ranks):
    """solve_column_layer_sharded on a ('data',) mesh of a world-size-1 NCCL
    group against solve_column on the card, and the gloo ranks' result of
    phase ``mesh``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from sos_rt_tpu_torch.config import SolverOptions
    from sos_rt_tpu_torch.parallel import make_mesh
    from sos_rt_tpu_torch.parallel.layer_sharded import solve_column_layer_sharded
    from sos_rt_tpu_torch.solver import solve_column

    mesh = make_mesh((1,), ("data",))
    out = {"phase": "layer_sharded", "world_size": dist.get_world_size(),
           "grid": list(LAYER_GRID), "cases": {}}

    def close(a, b, what):
        """Equal order counts, within 1e-12 of scale; the difference."""
        scale = float(b.i_total.abs().max())
        diff = float((a.i_total.cpu() - b.i_total.cpu()).abs().max()) / scale
        if int(a.n_orders) != int(b.n_orders) or not diff <= 1e-12 or not bool(a.converged):
            fail(f"layer_sharded {what}: orders {int(a.n_orders)} vs {int(b.n_orders)}, "
                 f"{diff:.3e} of scale")
        return diff

    for surface in ("lambertian", "specular"):
        opts = SolverOptions(surface=surface, dtype="float64")
        scene, t64, grid = layer_problem(device, torch.float64)
        w_ref, ref, launches = timed_solve(lambda: solve_column(scene, t64, grid, opts,
                                                                device=device))
        w_ls, ls, launches_ls = timed_solve(lambda: solve_column_layer_sharded(
            scene, t64, grid, opts, mesh))
        no_launches({**launches, **{k + "_ls": v for k, v in launches_ls.items()}},
                    f"layer_sharded {surface}")
        case = {"n_orders": int(ls.n_orders), "wall_s": w_ls, "solve_column_wall_s": w_ref,
                "vs_solve_column": close(ls, ref, surface)}
        _, t32, _ = layer_problem(device, torch.float32)
        ls32 = solve_column_layer_sharded(scene, t32, grid,
                                          dataclasses.replace(opts, dtype="float32"), mesh)
        got, want = ls32.i_total.cpu().double(), ls.i_total.cpu()
        keep = want.abs() > 1e-12 * want.abs().max()
        case["f32_p50_rel_vs_f64"] = float(((got - want).abs()[keep] / want.abs()[keep]).median())
        if int(ls32.n_orders) != int(ls.n_orders) or not case["f32_p50_rel_vs_f64"] < F64_P50_TOL:
            fail(f"layer_sharded {surface} float32: {int(ls32.n_orders)} orders, "
                 f"p50 {case['f32_p50_rel_vs_f64']:.3e}")
        if surface == "lambertian":
            g = ranks[0]
            case[f"gloo_{MESH_RANKS}_ranks_vs_solve_column"] = close(
                dataclasses.replace(ref, n_orders=torch.as_tensor(g["ls_n_orders"]),
                                    i_total=torch.as_tensor(g["ls_i_total"])), ref,
                f"gloo {MESH_RANKS} ranks")
        out["cases"][surface] = case

    # one long column, float64: wall, orders and peak memory of both solves
    opts = SolverOptions(dtype="float64")
    scene, t64, grid = layer_problem(device, torch.float64, LONG_LAYERS)
    long = {"grid": [LAYER_GRID[0], LONG_LAYERS]}
    sols = {}
    for name, fn in (("layer_sharded", lambda: solve_column_layer_sharded(
            scene, t64, grid, opts, mesh)),
                     ("solve_column", lambda: solve_column(scene, t64, grid, opts,
                                                           device=device))):
        torch.cuda.reset_peak_memory_stats()
        wall, sols[name], _ = timed_solve(fn)
        long[name] = {"wall_s": wall, "n_orders": int(sols[name].n_orders),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    long["vs_solve_column"] = close(sols["layer_sharded"], sols["solve_column"], "long column")
    out["long_column"] = long
    dist.destroy_process_group()
    emit(out)


def run_tool(main, argv):
    """A tool's main(argv) with its printed lines captured: (result, lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    return res, buf.getvalue().splitlines()


def same_bits(a, b) -> bool:
    """Equal values, NaN where the other has NaN."""
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def micro_library_calls(xs, pk, a2):
    """{pattern: one torch call that computes one rep, or None}.  float32
    products with TF32 off; matmul_high's yardstick is that float32 product
    (the function it approximates to 1e-7), matmul_def's a product of the
    bf16 operands."""
    import torch

    from sos_rt_tpu_torch.ops import micro

    v = xs[0]
    half = torch.tensor(0.5, device=v.device)
    c = torch.tensor(1.0001, device=v.device)
    lanes = torch.arange(micro.M2, device=v.device)
    maskc = torch.where(lanes < micro.M, c, 0.0)
    nan = torch.full_like(v, float("nan"))
    vb, ab = v.to(torch.bfloat16), a2.to(torch.bfloat16)
    return {"fma": lambda: torch.addcmul(half, v, c),
            "rowscalar": lambda: torch.addcmul(half, pk[..., 3:4], v),
            "rowscalar_slice": lambda: torch.addcmul(half, pk[..., 3:4], v),
            "lanemask": lambda: torch.mul(v, maskc),
            "tworefs": lambda: torch.addcmul(nan, v, c),
            "exp": None, "lanebrd": lambda: torch.addcmul(half, v, a2[0]),
            "reduce": None, "roll": None, "smooth": None,
            "matmul": lambda: v @ a2, "matmul_high": lambda: v @ a2,
            "matmul_def": lambda: vb @ ab}


def micro_rep_loops(kind: str) -> dict:
    """{pattern or pair: the shared loads, stores, barriers and tensor-core
    instructions of its kernel's rep loop} from the micro library's SASS
    (tools/sass.py); fails where a kernel of ``kind`` ('micro_ops' or
    'micro_pass') has no loop that reads and writes shared memory, or one
    with fewer loads or stores than MICRO_REP_LOOP_LEAST says."""
    import re

    from sos_rt_tpu_torch.ops import cuda_build, micro
    from sos_rt_tpu_torch.tools import sass

    out = {}
    for name, rows in sass.library_loops(cuda_build._lib_path("micro"),
                                         kind + "_kernel").items():
        if kind == "micro_ops":
            label = micro.PATTERNS[int(re.search(r"micro_ops_kernelILi(\d+)E", name).group(1))]
        else:
            mode, g = re.search(r"micro_pass_kernelILi(\d)ELi(\d+)E", name).groups()
            label = micro.MODES[int(mode)] + (f" {g}" if int(g) else "")
        rep = sass.rep_loop(rows)
        if rep is None:
            fail(f"{kind} {label}: no loop of its SASS reads and writes shared memory")
        lds, sts = MICRO_REP_LOOP_LEAST.get(label, (8, 8))
        if rep["lds"] < lds or rep["sts"] < sts:
            fail(f"{kind} {label}: its rep loop issues {rep['lds']} LDS / {rep['sts']} STS, "
                 f"fewer than the {lds} / {sts} of its source")
        out[label] = {k: rep[k] for k in ("lds", "sts", "bar", "mma")}
    want = len(micro.PATTERNS) if kind == "micro_ops" else len(
        {(m, g if m == "static" else 0) for m, g in micro.PASS_PAIRS})
    if len(out) != want:
        fail(f"{kind}: SASS of {sorted(out)}, expected {want} kernels")
    return out


def phase_micro_ops(device):
    """The micro_ops tool on the card.  Returns its kernels-line entry."""
    import torch

    from sos_rt_tpu_torch.config import full_precision_matmul
    from sos_rt_tpu_torch.ops import megastream as ms
    from sos_rt_tpu_torch.ops import micro
    from sos_rt_tpu_torch.tools import micro_ops as tool

    full_precision_matmul()
    ms.reset_launches()
    res, lines = run_tool(tool.main, [])
    torch.cuda.synchronize()
    launches = micro.micro_ops_call.launches
    if launches == 0 or sorted(r["pattern"] for r in res) != sorted(micro.PATTERNS):
        fail(f"micro_ops: the tool launched {launches} kernels over "
             f"{[r['pattern'] for r in res]}")

    xs, pk, a2 = micro.make_inputs(0, device)
    split, mu = micro.split_a2(a2), micro.mu_up(device)
    products = ("matmul", "matmul_high", "matmul_def")
    check, worst_abs = {}, 0.0
    for pat in micro.PATTERNS:
        first = micro.micro_ops_call(pat, 1, xs[0], pk, a2, split=split, mu=mu)
        for k in (1, 2):
            got = micro.micro_ops_call(pat, k, xs[0], pk, a2, split=split, mu=mu)
            torch.cuda.synchronize()
            # each rep on the same input: the second on the kernel's first
            # (a bf16 pass rounds its operand to 8 bits, so a last-bit
            # difference carried from the first rep would move the second
            # by 2**-8 of a term)
            want = micro.micro_ops_plain(pat, 1, xs[0] if k == 1 else first, pk, a2)
            diff = (got - want).abs().nan_to_num(0.0)
            scale = float(want.abs().nan_to_num(0.0).max()) or 1.0
            rel = float(diff.max()) / scale
            worst_abs = max(worst_abs, float(diff.max()))
            check[f"{pat}@{k}"] = rel
            if pat in products:
                if not (bool(torch.isfinite(got).all()) and rel <= MICRO_PRODUCT_TOL):
                    fail(f"micro_ops {pat} k={k}: rel err {rel:.3e} > {MICRO_PRODUCT_TOL}")
            elif not same_bits(got, want):
                fail(f"micro_ops {pat} k={k}: differs from plain ({rel:.3e} of scale)")

    library = {}
    for pat, call in micro_library_calls(xs, pk, a2).items():
        library[pat] = None if call is None else timed(call, 20) * 1e3   # us a rep
    per = {r["pattern"]: r for r in res}
    finite = {pat: bool(torch.isfinite(micro.micro_ops_call(
        pat, micro.K1, xs[0], pk, a2, split=split, mu=mu)).all()) for pat in micro.PATTERNS}
    plain_ms = {pat: timed(lambda: micro.micro_ops_plain(pat, micro.K1, xs[0], pk, a2), 1)
                for pat in micro.PATTERNS}
    bounds = {pat: tool.call_bound_ms(pat, micro.K1) for pat in micro.PATTERNS}
    sass_loops = micro_rep_loops("micro_ops")
    by_ops = sum(b for b, by in bounds.values() if by == "operations")
    emit({"phase": "micro_ops", "field": [micro.L, micro.C, micro.M2], "k1": micro.K1,
          "k2": micro.K2, "tool_lines": lines, "launches": launches,
          "rel_err_vs_plain": check,
          "per_pattern": {pat: {**{k: per[pat].get(k) for k in ("us_per_pass", "bound_us",
                                                           "bound_by", "plain_us_per_pass",
                                                           "k1_ms", "k2_ms")},
                                "share_of_pass_bound": per[pat]["bound_us"]
                                / per[pat]["us_per_pass"],
                                "library_us_per_rep": library[pat],
                                "finite_at_k1": finite[pat],
                                "rep_loop_sass": sass_loops[pat]}
                          for pat in micro.PATTERNS}})
    total_bound = sum(b for b, _ in bounds.values())
    ms_total = sum(per[p]["k1_ms"] for p in micro.PATTERNS)
    # the bound the tool times each pass against: its bytes through shared
    # memory (or its operations), K1 passes a call
    pass_bound = sum(per[p]["bound_us"] for p in micro.PATTERNS) * micro.K1 / 1e3
    return {"name": "micro_ops", "route": "cuda", "source": MICRO_SOURCE,
            "replaces": REPLACES["micro_ops"], "launches": launches,
            "max_abs_err": worst_abs, "max_rel_err": max(check.values()),
            "ms": ms_total, "plain_ms": sum(plain_ms.values()), "bound_ms": total_bound,
            "bound_by": "operations" if by_ops >= total_bound / 2 else "bytes",
            "share_of_bound": total_bound / ms_total, "pass_bound_ms": pass_bound,
            "pass_bound_share": pass_bound / ms_total, "library_ms": None}


def phase_micro_pass(device):
    """The micro_pass tool on the card.  Returns its kernels-line entry."""
    import torch

    from sos_rt_tpu_torch.ops import megastream as ms
    from sos_rt_tpu_torch.ops import micro
    from sos_rt_tpu_torch.tools import micro_pass as tool

    ms.reset_launches()
    res, lines = run_tool(tool.main, [])
    torch.cuda.synchronize()
    launches = micro.micro_pass_call.launches
    if launches == 0 or len(res) != len(micro.PASS_PAIRS):
        fail(f"micro_pass: the tool launched {launches} kernels over {len(res)} pairs")
    ones = torch.ones((micro.L, micro.C, micro.M2), dtype=torch.float32, device=device)
    rand = micro.make_inputs(0, device)[0][1]
    for mode, g in micro.PASS_PAIRS:
        for x in (ones, rand):
            got = micro.micro_pass_call(mode, g, x)
            torch.cuda.synchronize()
            if not torch.equal(got, micro.micro_pass_plain(mode, g, x)):
                fail(f"micro_pass {mode} g={g}: differs from plain")
    field = micro.L * micro.C * micro.M2
    t_bytes = 2 * field * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = micro.K * 2 * field / PEAK_OPS["float32"] * 1e3
    # the tool's ms is one call's, the host's dispatch of it included (the
    # yardstick of the pass bound); queued_ms is the card's own a call
    for r in res:
        r["share_of_pass_bound"] = r["bound_us"] / r["us_per_pass"]
        r["queued_share_of_pass_bound"] = r["bound_us"] * micro.K / 1e3 / r["queued_ms"]
    emit({"phase": "micro_pass", "field": [micro.L, micro.C, micro.M2], "passes": micro.K,
          "tool_lines": lines, "launches": launches, "pairs": res,
          "rep_loop_sass": micro_rep_loops("micro_pass")})
    ms_total, bound = sum(r["ms"] for r in res), len(res) * max(t_bytes, t_ops)
    queued_total = sum(r["queued_ms"] for r in res)
    # the tool's own bound: each pass's bytes through shared memory
    pass_bound = sum(r["bound_us"] for r in res) * micro.K / 1e3
    return {"name": "micro_pass", "route": "cuda", "source": MICRO_SOURCE,
            "replaces": REPLACES["micro_pass"], "launches": launches,
            "max_abs_err": 0.0, "max_rel_err": 0.0,
            "ms": ms_total, "plain_ms": sum(r["plain_ms"] for r in res),
            "bound_ms": bound, "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "share_of_bound": bound / ms_total, "pass_bound_ms": pass_bound,
            "pass_bound_share": pass_bound / ms_total, "queued_ms": queued_total,
            "queued_pass_bound_share": pass_bound / queued_total, "library_ms": None}


def phase_ablate(device):
    """The resident kernel's ablated builds and the attribution tool."""
    import torch

    from sos_rt_tpu_torch import fused
    from sos_rt_tpu_torch.fused import prepare_batch, take_columns
    from sos_rt_tpu_torch.ops import megakernel as mk
    from sos_rt_tpu_torch.tools import ablate_kernel as tool

    # no flag: the ablated library's build of the solve equals sos_mega
    preset, scenes, tables = fwc_batch(device)
    key = fused.sort_key(scenes, tables[torch.float32], preset.grid, preset.opts,
                         "predict", device)
    cb = mk.default_cols_per_tile(mk.pad_angles(preset.grid.nb_angles))
    sb = prepare_batch(take_columns(scenes, torch.argsort(key, stable=True)),
                       tables[torch.float32], preset.grid, preset.opts,
                       cols_per_block=cb, device=device)
    kw = dict(tol=float(preset.opts.tol), max_orders=int(preset.opts.max_orders),
              full=False)
    solve = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, **kw)
    again = mk.mega_call(sb.pack, sb.cpar, sb.tiles, sb.ops, ablate_build=True, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(solve, again)):
        fail("ablate: mega_ablate's build of the solve differs from sos_mega")

    # each variant against mega_plain with the same flags, in float32 on the
    # tool's batch; the columns that are off by more than F32_KERNEL_TOL of
    # scale again in float64, where no sum's last bit reaches the smoothing
    # threshold: there kernel and plain version must agree to 1e-12
    import dataclasses

    from sos_rt_tpu_torch.solver import PhaseTables

    orders, batch = ABLATE_ORDERS, ABLATE_CHECK_BATCH
    bscenes, btables, bopts = tool.fwc_batch(batch, orders, device)
    t64 = PhaseTables.from_models(tool.GRID, 0.5, atm=("rayleigh", {}), aer=("fwc", {}),
                                  dtype=torch.float64, device=device)
    o64 = dataclasses.replace(bopts, dtype="float64")
    bsb = prepare_batch(bscenes, btables, tool.GRID, bopts, cols_per_block=cb,
                        device=device)
    bkw = dict(tol=float(bopts.tol), max_orders=orders, full=False)
    vs_plain, bad = {}, []
    for ab in mk.ABLATE_VARIANTS:
        got = mk.mega_call(bsb.pack, bsb.cpar, bsb.tiles, bsb.ops, ablate=ab, **bkw)
        torch.cuda.synchronize()
        want = mk.mega_plain(bsb.pack, bsb.cpar, bsb.tiles, bsb.ops, ablate=ab, **bkw)
        if not (bool((got[-1][mk.ST_N] == orders).all())
                and torch.equal(got[-1][mk.ST_N], want[-1][mk.ST_N])):
            fail(f"ablate {ab}: order counts {got[-1][mk.ST_N].unique().tolist()}")
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"ablate {ab}: non-finite values")
        off = torch.cat([(g - w).abs() > F32_KERNEL_TOL * float(w.abs().max())
                         for g, w in zip(got[:4], want[:4])], 1)
        row = {"rows_off_frac": float(off.float().mean()),
               "rows_max_rel": max(rel_err(g, w) for g, w in zip(got[:4], want[:4]))}
        if ab not in ABLATE_AT_THRESHOLD:
            bad += [f"{ab}: {k} = {v:.3e} > {MEGA_BATCH_LIMITS[k]}"
                    for k, v in row.items() if not v <= MEGA_BATCH_LIMITS[k]]
        cols = torch.nonzero(off.any(1))[:, 0]
        row["columns_off"] = int(cols.numel())
        if cols.numel():
            sb64 = prepare_batch(take_columns(bscenes, cols), t64, tool.GRID, o64,
                                 cols_per_block=cb, device=device)
            g64 = mk.mega_call(sb64.pack, sb64.cpar, sb64.tiles, sb64.ops, ablate=ab, **bkw)
            w64 = mk.mega_plain(sb64.pack, sb64.cpar, sb64.tiles, sb64.ops, ablate=ab,
                                **bkw)
            row["columns_off_f64_rel"] = max(rel_err(g, w) for g, w in zip(g64[:4], w64[:4]))
            if not (torch.equal(g64[-1][mk.ST_N], w64[-1][mk.ST_N])
                    and row["columns_off_f64_rel"] <= 1e-12):
                bad.append(f"{ab}: float64 columns off by {row['columns_off_f64_rel']:.3e}")
        vs_plain[ab] = row

    res, lines = run_tool(tool.main, [str(orders), str(cb), str(ABLATE_BATCH)])
    emit({"phase": "ablate", "solve_equals_sos_mega": True, "check_batch": batch,
          "orders": orders, "vs_plain": vs_plain, "limits": MEGA_BATCH_LIMITS,
          "tool_lines": lines, "attribution": res})
    if bad:
        fail("ablate: " + "; ".join(bad))


def passes_vs_plain(pack, cpar, fdn, fup, ops, tol: float, what: str, orders: int):
    """The ablated builds of passA and passB (csrc/megastream_ablate.cu)
    against their plain versions with the same flag, on the fields of
    ``orders`` orders of the plain chain from (fdn, fup): passA within
    ``tol`` of scale (its product sums in another order; nosrc's jₙ↑ to
    the bit), passB to the bit (same_bits: the same separately rounded
    operations); the empty mask of each ablated build equal to the solve's
    build to the bit; 'nofin' equal to 'nosmooth' (same_bits).  Returns
    ({variant: max relative error}, {variant: max absolute error})."""
    import torch

    from sos_rt_tpu_torch.ops import megastream as ms

    rel, absd = {}, {}

    def held(key, got, want, bits):
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"ablate_stream {what} {key}: non-finite values")
        r = max(rel_err(g, w) for g, w in zip(got, want))
        rel[key] = max(rel.get(key, 0.0), r)
        absd[key] = max(absd.get(key, 0.0),
                        max(float((g - w).abs().max()) for g, w in zip(got, want)))
        if bits and not all(same_bits(g, w) for g, w in zip(got, want)):
            fail(f"ablate_stream {what} {key}: not equal to the bit (rel err {r:.3e})")
        if not r <= tol:
            fail(f"ablate_stream {what} {key}: rel err {r:.3e} > {tol}")

    for _ in range(orders):
        if not all(same_bits(a, b) for a, b in zip(
                ms.passA(pack, fdn, fup, ops),
                ms.passA(pack, fdn, fup, ops, ablate_build=True))):
            fail(f"ablate_stream {what}: sos_passA_ablate's empty mask differs from sos_passA")
        for f in ms.PASS_A_FLAGS:
            got = ms.passA(pack, fdn, fup, ops, ab={f})
            want = ms.passA_plain(pack, fdn, fup, ops, {f})
            held(f"passA {f}", got, want, False)
            if f == "nosrc" and not same_bits(got[1], want[1]):
                fail(f"ablate_stream {what}: passA nosrc's jn_up is not I_up + 1 to the bit")
        sdn, jn = ms.passA_plain(pack, fdn, fup, ops)
        if not all(same_bits(a, b) for a, b in zip(
                ms.passB(pack, sdn, jn, cpar, ops),
                ms.passB(pack, sdn, jn, cpar, ops, ablate_build=True))):
            fail(f"ablate_stream {what}: sos_passB_ablate's empty mask differs from "
                 "the passB stages")
        outs = {}
        for f in ms.PASS_B_FLAGS:
            outs[f] = ms.passB(pack, sdn, jn, cpar, ops, ab={f})
            held(f"passB {f}", outs[f], ms.passB_plain(pack, sdn, jn, cpar, ops, {f}), True)
        if not all(same_bits(a, b) for a, b in zip(outs["nofin"], outs["nosmooth"])):
            fail(f"ablate_stream {what}: passB nofin and nosmooth differ")
        fdn, fup = ms.passB_plain(pack, sdn, jn, cpar, ops)
    return rel, absd


def stream_loop_launches(launches: dict, ab: str, orders: int, blocks: int):
    """Fail unless a streamed loop with the flags ``ab`` and a fixed order
    count launched what its flags say: passI once a block; passA and passB
    ``orders`` times a block each, from the ablated build where a flag of
    theirs is set, not at all under 'nopassA' / 'nopassB'."""
    from sos_rt_tpu_torch.ops import megastream as ms

    flags = set(ab.split(","))
    want = {"passI": blocks}
    for name, own in (("passA", ms.PASS_A_FLAGS), ("passB", ms.PASS_B_FLAGS)):
        n = 0 if "no" + name in flags else orders * blocks
        ablated = bool(flags & set(own))
        want[name], want[name + "_ablate"] = (0, n) if ablated else (n, 0)
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"ablate_stream {ab}: launches {got}, expected {want}")


def phase_ablate_stream(device):
    """The streamed passes' ablated builds and the streamed attribution
    tool.  Returns {'passA': entry, 'passB': entry}: the ablated build of
    each for the kernels line."""
    import numpy as np
    import torch

    from sos_rt_tpu_torch.config import GridSpec, SolverOptions
    from sos_rt_tpu_torch.fused import solve_batch_mega
    from sos_rt_tpu_torch.ops import megastream as ms
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables
    from sos_rt_tpu_torch.tools import ablate_stream as tool

    hg = get_preset("hg")
    # 1. each variant against its plain version on the kernels phase's block
    grid = GridSpec(56, 64)
    scenes = random_scenes(hg, 8, device, np.random.default_rng(SEED))
    small = {}
    for dtype, mm, tol in (("float64", "highest", 1e-12),
                           ("float32", "bf16x3", F32_KERNEL_TOL)):
        opts = SolverOptions(surface="lambertian", dtype=dtype, mm=mm)
        (pack, cpar, tiles), ops = block_inputs(
            scenes, test_tables(grid, device, getattr(torch, dtype)), grid, opts, device)
        fdn, fup = ms.passI_plain(pack, tiles, cpar, ops)
        small[f"{dtype} {mm}"] = passes_vs_plain(pack, cpar, fdn, fup, ops, tol,
                                                 f"{dtype} {mm}", 2)[0]

    # 2. on one canonical 128-column block, 2 orders, float32 bf16x3; each
    # variant timed there beside the solve's build
    opts = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3")
    ctables = PhaseTables.from_models(hg.grid, 0.5, atm=hg.atm, aer=hg.aer,
                                      dtype=torch.float32, device=device)
    (pack, cpar, tiles), ops = block_inputs(
        random_scenes(hg, 128, device, np.random.default_rng(SEED)), ctables, hg.grid,
        opts, device, cols_per_block=128)
    fdn, fup = ms.passI_plain(pack, tiles, cpar, ops)
    big_rel, big_abs = passes_vs_plain(pack, cpar, fdn, fup, ops, F32_KERNEL_TOL,
                                       "canonical block", 2)
    sdn, jn = ms.passA_plain(pack, fdn, fup, ops)
    block_ms = {"passA": timed(lambda: ms.passA(pack, fdn, fup, ops), 5),
                "passB": timed(lambda: ms.passB(pack, sdn, jn, cpar, ops), 5)}
    for f in ms.PASS_A_FLAGS:
        block_ms[f"passA {f}"] = timed(lambda: ms.passA(pack, fdn, fup, ops, ab={f}), 5)
    for f in ms.PASS_B_FLAGS:
        block_ms[f"passB {f}"] = timed(lambda: ms.passB(pack, sdn, jn, cpar, ops, ab={f}), 5)

    # 3. the whole streamed loop, card against CPU (the plain versions): the
    # tool's variants and each loop flag, with the launches each variant makes
    loops = {}
    for dtype in ("float64", "float32"):
        opts = SolverOptions(surface="lambertian", dtype=dtype, max_orders=STREAM_LOOP_ORDERS)
        per = {}
        names = tool.variants() + STREAM_LOOP_FLAGS
        for ab in (names if dtype == "float64" else ("noconv",) + STREAM_LOOP_FLAGS):
            sols = []
            for dev in (device, torch.device("cpu")):
                sc = random_scenes(hg, 8, dev, np.random.default_rng(SEED))
                tb = test_tables(grid, dev, getattr(torch, dtype))
                _, sol, launches = timed_solve(lambda: solve_batch_mega(
                    sc, tb, grid, opts, outputs="summary", stream=True, sort=False,
                    device=dev, ablate=ab))
                sols.append(sol)
                if dev == device and "noconv" in ab:
                    stream_loop_launches(launches, ab, STREAM_LOOP_ORDERS - 1, 1)
            gpu, cpu = (torch.cat([x.i_toa, x.i_surface], 1).cpu() for x in sols)
            if dtype == "float64":
                if not torch.equal(sols[0].n_orders.cpu(), sols[1].n_orders):
                    fail(f"ablate_stream loop {ab} float64: order counts differ")
                per[ab] = rel_err(gpu, cpu)
                if not per[ab] <= 1e-12:
                    fail(f"ablate_stream loop {ab} float64: rel err {per[ab]:.3e}")
            else:
                per[ab] = loops_within_limits(sols[0].n_orders.cpu(), sols[1].n_orders,
                                              [gpu], [cpu], f"ablate_stream loop {ab}")[0]
        loops[dtype] = per

    # 4. the tool at its shapes: every count 0 just before, read just after
    ms.reset_launches()
    res, lines = run_tool(tool.main, [str(STREAM_ABLATE_ORDERS), str(STREAM_ABLATE_BATCH)])
    torch.cuda.synchronize()
    launches = launch_counts()
    if not (launches["passA_ablate"] and launches["passB_ablate"] and launches["passA"]
            and launches["passB"]):
        fail(f"ablate_stream: the tool's launches {launches}")
    if any(v is None for v in res["kernels_ms"].values()):
        fail(f"ablate_stream: no device time for a variant: {res['kernels_ms']}")
    # each variant's trace holds every product launch: passI's and, where
    # passA keeps its product, passA's
    for ab, by_kernel in res["by_kernel"].items():
        products = sum(k["calls"] for name, k in by_kernel.items() if "quad_mma" in name)
        want = 1 + (0 if {"nosrc", "nopassA"} & set(ab.split(",")) else STREAM_ABLATE_ORDERS - 1)
        if products != want:
            fail(f"ablate_stream {ab}: the profiler saw {products} product launches, not "
                 f"{want} (passI and each passA with its product; launches without a "
                 f"device record: {res['lost_launches'][ab]})")
    emit({"phase": "ablate_stream", "small_block_rel_err": small,
          "canonical_block_rel_err": big_rel, "canonical_block_ms": block_ms,
          "loops": loops, "loop_orders": STREAM_LOOP_ORDERS, "limits": MEGA_BATCH_LIMITS,
          "empty_mask_equals_solve": True, "nofin_equals_nosmooth": True,
          "tool_launches": launches, "tool_lines": lines, "attribution": res})
    entry = lambda name: {"source": STREAM_ABLATE_SOURCE,
                          "launches": launches[f"{name}_ablate"],
                          "max_abs_err": max(v for k, v in big_abs.items()
                                             if k.startswith(name)),
                          "ms": {k: v for k, v in block_ms.items() if k.startswith(name)}}
    return {"passA": entry("passA"), "passB": entry("passB")}


def phase_trace(device):
    """tools/profile.py on the card: where the time of each path goes."""
    import dataclasses

    import numpy as np
    import torch

    from sos_rt_tpu_torch import cli, fused
    from sos_rt_tpu_torch.config import SolverOptions
    from sos_rt_tpu_torch.parallel import solve_batch
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables
    from sos_rt_tpu_torch.sweep import build_sweep_batch
    from sos_rt_tpu_torch.tools import profile

    out = os.path.join(HERE, "build", "sos_rt_tpu_torch", "trace")
    keep = lambda t: {**t, "kernels": dict(list(t["kernels"].items())[:12])}
    paths = {}
    # the reference engine's canonical single column, as the JAX tool runs it
    t, _ = run_tool(profile.main, ["--canonical", "--out", out])
    paths["reference_canonical"] = keep(t)
    hg = get_preset("hg")
    opts = SolverOptions(surface="lambertian", dtype="float32", mm="bf16x3")
    t32 = PhaseTables.from_models(hg.grid, 0.5, atm=hg.atm, aer=hg.aer,
                                  dtype=torch.float32, device=device)
    # the fused_canonical batch, through engine='mega'
    fscenes = dataclasses.replace(
        random_scenes(hg, 64, device, np.random.default_rng(SEED)),
        tau_star_atm=torch.full((64,), 0.044, dtype=torch.float64, device=device))
    paths["fused_canonical"] = keep(profile.trace(lambda: solve_batch(
        fscenes, t32, hg.grid, opts, engine="mega", outputs="summary", device=device),
        out, "fused_canonical", device))
    # the reference engine on 8 of the canonical columns in bf16x3
    rscenes = random_scenes(hg, 8, device, np.random.default_rng(SEED))
    paths["reference_bf16x3"] = keep(profile.trace(lambda: solve_batch(
        rscenes, t32, hg.grid, opts, engine="reference", device=device), out,
        "reference_bf16x3", device))
    # the canonical batch (mega, streamed)
    cscenes = random_scenes(hg, 256, device, np.random.default_rng(SEED))
    paths["canonical"] = keep(profile.trace(lambda: solve_batch(
        cscenes, t32, hg.grid, opts, engine="mega", outputs="summary",
        cols_per_block=128, device=device), out, "canonical", device))
    # the 64x128 sweep batch (mega, resident)
    preset, sscenes, stables = fwc_batch(device)
    paths["fwc_sweep"] = keep(profile.trace(lambda: solve_batch(
        sscenes, stables[torch.float32], preset.grid, preset.opts, engine="mega",
        outputs="summary", sort="predict", device=device), out, "fwc_sweep", device))
    for name, scopes in (("reference_canonical", profile.SCOPES),
                         ("fused_canonical", profile.SCOPES[1:])):
        missing = [s for s in scopes
                   if paths[name]["scopes"].get(s, {}).get("device_ms") is None]
        if missing:
            fail(f"trace {name}: no device time for the scopes {missing}")
    for name, kern in (("canonical", "tc::quad_mma"), ("fwc_sweep", "mega_kernel")):
        if not any(kern in k for k in paths[name]["kernels"]):
            fail(f"trace {name}: no {kern} kernel in {list(paths[name]['kernels'])}")
    # in the split modes the source scope runs the source kernel and no
    # cuBLAS product
    for name in ("fused_canonical", "reference_bf16x3"):
        src = paths[name]["scopes"]["sos.source_jn"]
        if set(src["kernels"]) != {"sos::tc::quad_mma"}:
            fail(f"trace {name}: sos.source_jn ran {src['kernels']}, not the source "
                 "kernel alone")
    # the sweep command once (its phase ran it before), and beside it the
    # route's layer_reaches_ground on one chunk's scenes (one sync a solve)
    sweep_dir = os.path.join(out, "sweep_cli")
    argv = ["sweep", "--preset", "fwc_sweep", "--batch", "16384", "--chunk", "4096",
            "-o", sweep_dir]
    import shutil

    shutil.rmtree(sweep_dir, ignore_errors=True)
    paths["sweep_cli"] = keep(profile.trace(lambda: run_tool(cli.main, argv), out,
                                            "sweep_cli", device, warm=False))
    chunk, _ = build_sweep_batch(preset, 4096, seed=0, device=device)
    ground_ms = min(1e3 * timed_solve(lambda: fused.layer_reaches_ground(
        chunk, preset.grid))[0] for _ in range(5))
    emit({"phase": "trace", "nvidia_smi": nvidia_smi(), "paths": paths,
          "layer_reaches_ground_ms": ground_ms})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", action="store_true",
                    help="run only phase mesh_gpus: the sweep command over every "
                         "visible card against one card")
    args = ap.parse_args(argv)
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
    if args.gpus:
        phase_mesh_gpus()
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    phase_card()
    sweep_abs = phase_kernels(device)
    phase_slice_f64(device)
    kernels = phase_canonical(device)
    fwc_abs = phase_fwc_sweep(device)
    for k in kernels:        # the largest difference over both paths' blocks
        k["max_abs_err"] = max(k["max_abs_err"], fwc_abs[k["name"]])
    mega = phase_resident(device)
    mega["launches"] = phase_sweep_cli(device)
    mega_i1in = phase_i1_host(device)
    phase_reference_f64(device)
    phase_reference(device)
    phase_mie_tables()
    phase_run_cli(device)
    phase_critical_albedo(device)
    phase_sweep_orders(device)
    phase_single_layer(device)
    phase_edge_layers(device)
    phase_layer_sharded(device, phase_mesh(device))
    phase_fused_f64(device)
    sweeps = phase_fused_canonical(device, sweep_abs)
    fused_abs = phase_fused_sweep(device)
    for k in sweeps:         # the largest difference over every block tried
        k["max_abs_err"] = max(k["max_abs_err"], fused_abs.get(k["name"], 0.0))
    micro_entries = [phase_micro_ops(device), phase_micro_pass(device)]
    phase_ablate(device)
    ablated = phase_ablate_stream(device)
    for k in kernels:        # passA and passB name their ablated build
        if k["name"] in ablated:
            k["ablated"] = ablated[k["name"]]
    phase_trace(device)
    emit({"kernels": kernels + [mega, mega_i1in] + sweeps + micro_entries})
    print(nvidia_smi(), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
