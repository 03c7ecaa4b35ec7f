"""Write a torch.profiler trace of a solve and say where its time goes.

Counterpart of the JAX package's ``tools/profile.py``.

usage: python -m sos_rt_tpu_torch.tools.profile [--out DIR] [--batch 1024]
           [--engine mega|fused|reference] [--canonical] [--device cpu]
           [--grid NA NL]

Runs the solve once in the profiler's warm-up step, then once more in its
recorded step (``torch.profiler.profile(activities=[CPU, CUDA])``); writes
that window's Chrome trace under ``--out`` (default ``build/sos_rt_tpu_torch/
trace`` at the root of the checkout) and prints a table: device ms by the
solver's scopes (``sos.first_order``, ``sos.source_jn``, ``sos.down_sweep``,
``sos.up_sweep_bc``, the JAX package's named scopes, on the reference and
fused engines; the mega engine's kernels show by name), device ms by
kernel, the host's ms of the window and the device's busy share of it (the
union of the intervals of its kernels and copies over the window, from the
recorded call's start to the trace's last event).  ``--canonical``
profiles the 501×800 single-column reference solve (float32, at most 40
orders), as the JAX tool does; otherwise ``--batch`` columns of the
``fwc_sweep`` preset through ``run_sweep(mu0_pool=8)`` on ``--engine``.
``--grid`` replaces either grid (for the tests).  ``--device cpu`` runs on
the CPU, for the tests: the scopes' host time only, no device time.  On a
card a trace that shows no device time raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from sos_rt_tpu_torch import spans

SCOPES = (spans.FIRST_ORDER, spans.SOURCE_JN, spans.DOWN_SWEEP, spans.UP_SWEEP_BC)
# the span of the recorded call in :func:`trace`'s window; :func:`read_trace`
# reads only what the host starts inside it and the device work it launched
RECORDED = spans.RECORDED_CALL
# seconds between the recorded step's opening launch and the recorded call:
# the profiler drops, at times, the device records of the kernels that run
# in the first milliseconds of a window (``tools/trace_windows.py`` counts
# the windows that lose one)
OPENING_S = 0.05
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "sos_rt_tpu_torch", "trace")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_name(name: str) -> str:
    """A device kernel's name without its return type, template arguments
    and parameters ('sos::pb::pass_b_up' for 'void sos::pb::pass_b_up<float,
    1, 0>(sos::PassBArgs<float>)')."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


def busy_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _device_us(ev) -> float:
    v = getattr(ev, "device_time_total", None)
    return float(v if v is not None else getattr(ev, "cuda_time_total", 0.0))


def _launched_us(events, dev, cpu):
    """({scope: µs of the device work launched inside it}, {scope: {kernel:
    {calls, ms}}}): each kernel or copy is matched to the host's launch call
    with its correlation id (``cudaLaunchKernel`` and the like), and counts
    in the scope whose host interval holds that call.  This also counts the
    port's own kernels, which ctypes launches outside any PyTorch op."""
    launch_at = {e.id: e.time_range.start for e in events
                 if e.device_type == cpu and "Launch" in e.name}
    spans = {name: [(e.time_range.start, e.time_range.end) for e in events
                    if e.name == name and e.device_type == cpu] for name in SCOPES}
    out = dict.fromkeys(SCOPES, 0.0)
    by_kernel = {name: {} for name in SCOPES}
    for k in dev:
        t = launch_at.get(k.id)
        for name, iv in spans.items():
            if t is not None and any(a <= t <= b for a, b in iv):
                us = k.time_range.end - k.time_range.start
                out[name] += us
                kn = by_kernel[name].setdefault(kernel_name(k.name),
                                                {"calls": 0, "ms": 0.0})
                kn["calls"] += 1
                kn["ms"] += us / 1e3
                break
    return out, by_kernel


def read_trace(events, wall_ms: float, device) -> dict:
    """The table of a profiler window's ``events`` (``prof.events()``):
    {wall_ms, window_ms, busy_ms, busy_share, idle_ms, scopes: {name:
    {calls, host_ms, device_ms, kernels}}, kernels: {name: {calls, ms}},
    lost_launches}.  Where the events hold :data:`RECORDED`'s span, only
    the host events that start inside it count, and the device work that
    the host's runtime calls among them launched (matched by correlation
    id, not by time: the device's clock, as the trace maps it, can run ahead
    of the host's).  A scope's device ms is the time of the
    device work launched inside it (the larger of the profiler's own sum
    over its ops and :func:`_launched_us`; None where it launched none, and
    on the CPU), its kernels that work by kernel name ({name: {calls, ms}},
    matched as :func:`_launched_us` matches it); its host ms the host time
    inside it.  ``lost_launches`` counts the host's launch calls whose
    device record the trace lacks."""
    from torch.autograd import DeviceType

    opened = [e.time_range.start for e in events
              if e.name == RECORDED and e.device_type == DeviceType.CPU]
    if opened:
        host = [e for e in events
                if e.device_type == DeviceType.CPU and e.time_range.start >= min(opened)]
        runtime = {e.id for e in host if e.name.startswith("cu")}
        events = host + [e for e in events if e.device_type != DeviceType.CPU
                         and e.id in runtime and not getattr(e, "is_user_annotation", False)]
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and not getattr(e, "is_user_annotation", False)]
    recorded = {e.id for e in dev}
    lost = sum(1 for e in events if e.device_type == DeviceType.CPU
               and "Launch" in e.name and e.id not in recorded)
    launched, launched_kernels = _launched_us(events, dev, DeviceType.CPU)
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    window_us = (max(s[1] for s in spans) - min(s[0] for s in spans)) if spans else 0.0
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    kernels = {}
    for e in dev:
        k = kernels.setdefault(kernel_name(e.name), {"calls": 0, "ms": 0.0})
        k["calls"] += 1
        k["ms"] += (e.time_range.end - e.time_range.start) / 1e3
    scopes = {}
    for name in SCOPES:
        evs = [e for e in events if e.name == name and e.device_type == DeviceType.CPU]
        if not evs:
            continue
        d_us = max(sum(_device_us(e) for e in evs), launched[name])
        scopes[name] = {"calls": len(evs),
                        "host_ms": sum(e.time_range.end - e.time_range.start
                                       for e in evs) / 1e3,
                        "device_ms": d_us / 1e3 if device.type == "cuda" and d_us > 0
                        else None,
                        "kernels": launched_kernels[name]}
    return {"device": str(device), "wall_ms": wall_ms, "window_ms": window_us / 1e3,
            "busy_ms": busy / 1e3,
            "busy_share": busy / window_us if device.type == "cuda" and window_us > 0
            else None,
            "idle_ms": (window_us - busy) / 1e3, "scopes": scopes,
            "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])),
            "lost_launches": lost}


def trace(fn, out: str | None, label: str, device, warm: bool = True,
          opening: float = OPENING_S) -> dict:
    """Call ``fn`` inside the profiler's warm-up step (a no-op there where
    ``warm`` is False), then once more inside its recorded step; write
    ``<out>/<label>.json`` (Chrome trace of the recorded step; none where
    ``out`` is None) and return :func:`read_trace`'s table with the trace's
    path.  The warm-up step takes the start-up of the device tracing.  On a
    card the recorded step opens with a one-element launch and waits
    ``opening`` seconds before the recorded call, whose span
    (:data:`RECORDED`) bounds the table's window; raises RuntimeError where
    the recorded call shows no device time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    path = os.path.join(out, f"{label}.json") if out is not None else None
    steps = []

    def ready(prof):
        if path is not None:
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(path)
        steps.append(prof.events())

    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        if warm:
            fn()
        elif device.type == "cuda":
            torch.ones(1, device=device).add_(1.0)
        _sync(device)
        prof.step()
        if device.type == "cuda":
            torch.ones(1, device=device).add_(1.0)
            _sync(device)
            time.sleep(opening)
        with spans.span(RECORDED):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    table = read_trace(steps[0], wall_ms, device)
    if device.type == "cuda" and not table["busy_ms"] > 0:
        raise RuntimeError(f"trace {label}: the profiler shows no device time")
    table["trace"] = path
    return table


def print_table(label: str, t: dict, top: int = 12) -> None:
    share = f"{100 * t['busy_share']:.1f}%" if t["busy_share"] is not None else "n/a"
    print(f"{label} ({t['device']}): host {t['wall_ms']:.2f} ms, window "
          f"{t['window_ms']:.2f} ms, device busy {t['busy_ms']:.2f} ms ({share}), "
          f"idle {t['idle_ms']:.2f} ms", flush=True)
    for name, s in t["scopes"].items():
        d = f"{s['device_ms']:.3f}" if s["device_ms"] is not None else "none"
        print(f"  scope  {name:22s}: device {d:>10} ms  host {s['host_ms']:9.3f} ms  "
              f"({s['calls']} calls)", flush=True)
    for name, k in list(t["kernels"].items())[:top]:
        print(f"  kernel {name[:48]:48s}: {k['ms']:9.3f} ms ({k['calls']} calls)",
              flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--engine", default="mega", choices=["mega", "fused", "reference"])
    ap.add_argument("--canonical", action="store_true",
                    help="profile the 501x800 single-column solve instead")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=2, metavar=("NA", "NL"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import PhaseTables, solve_column
    from sos_rt_tpu_torch.sweep import run_sweep

    if args.canonical:
        grid = GridSpec(*(args.grid or (501, 800)))
        opts = SolverOptions(surface="lambertian", dtype="float32", max_orders=40)
        tables = PhaseTables.from_models(grid, 0.5, atm=("rayleigh", {}),
                                         aer=("hg", {"g": 0.7}), dtype=torch.float32,
                                         device=device)
        scene = Scene(mu0=0.5, grd_alb=0.15)
        label = "canonical_reference"
        fn = lambda: solve_column(scene, tables, grid, opts, device=device)
    else:
        p = get_preset("fwc_sweep")
        if args.grid:
            p = dataclasses.replace(p, grid=GridSpec(*args.grid))
        outputs = "summary" if args.engine == "mega" else "full"
        label = f"sweep_{args.engine}"
        fn = lambda: run_sweep(p, args.batch, mu0_pool=8, engine=args.engine,
                               outputs=outputs, device=device)
    t = trace(fn, args.out, label, device)
    print_table(label, t)
    print(f"trace written to {t['trace']} (chrome://tracing or Perfetto)")
    return t


if __name__ == "__main__":
    main()
