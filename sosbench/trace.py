"""The traced window: ``torch.profiler`` around the measured requests, and
the reading of its events.

The profiler's first step runs one request untraced (it takes the start-up
of the device tracing); the recorded step opens with a one-element launch,
waits :data:`OPENING_S` (the profiler drops, at times, the device records
of a window's first milliseconds), then runs the window's requests inside
the span :data:`RECORDED`.  Only host events that start inside that span
count, and the device work their runtime calls launched, matched by
correlation id (the device clock, as the trace maps it, can run ahead of
the host's).  A launch call whose device record the trace lacks counts in
``lost_launches``.
"""
from __future__ import annotations

import time

import numpy as np

from sosbench.stats import busy_us

RECORDED = "sosbench.window"
COLLECTIVE = "nccl"           # kernels whose name holds this (any case) are collectives
SPAN_PREFIX = "sosbench."
OPENING_S = 0.05
LABELLED_GAPS = 400          # the longest gaps that get the host's activity as a label


def kernel_name(name: str) -> str:
    """A device kernel's name without its return type, template arguments
    and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


def traced(torch, device, warm, body):
    """Run ``warm()`` (the cell's warm request) in the profiler's warm-up step and ``body()`` in its
    recorded step; returns (body's result, :func:`read` of the window)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    steps = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: steps.append(p.events())) as prof:
        warm()
        torch.cuda.synchronize(device)
        prof.step()
        torch.ones(1, device=device).add_(1.0)
        torch.cuda.synchronize(device)
        time.sleep(OPENING_S)
        with record_function(RECORDED):
            out = body()
            torch.cuda.synchronize(device)
        prof.step()
    return out, read(steps[0])


def _add(table, name, us):
    k = table.setdefault(name, {"calls": 0, "s": 0.0})
    k["calls"] += 1
    k["s"] += us / 1e6


def read(events) -> dict:
    """The reading of one window's events: {window_s, busy_s (the union of
    every kernel's and copy's interval), compute_busy_s (the same without
    the collectives, whose kernels spin while they wait for the slowest
    rank), lost_launches, launches, kernels {name: {calls, s}}, by_span {span:
    {kernel: {calls, s}}} (device work by the innermost benchmark span
    whose host interval holds its launch; '' outside any), spans {name:
    {calls, s}} (host time), gaps [[host activity, s], ...]}."""
    from torch.autograd import DeviceType

    cpu = DeviceType.CPU
    opened = [e for e in events if e.name == RECORDED and e.device_type == cpu]
    if not opened:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = opened[0].time_range.start, opened[0].time_range.end
    host = [e for e in events if e.device_type == cpu and e.time_range.start >= w0]
    runtime = {e.id for e in host if e.name.startswith("cu")}
    dev = [e for e in events if e.device_type != cpu and e.id in runtime
           and not getattr(e, "is_user_annotation", False)]
    recorded = {e.id for e in dev}
    launch_calls = [e for e in host if "Launch" in e.name]
    lost = sum(1 for e in launch_calls if e.id not in recorded)
    launch_at = {e.id: e.time_range.start for e in launch_calls}
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in host
             if e.name.startswith(SPAN_PREFIX) and e.name != RECORDED]
    span_table = {}
    for s, e, name in spans:
        _add(span_table, name, e - s)

    def span_of(t):
        best = ("", float("inf"))
        for s, e, name in spans:
            if s <= t <= e and e - s < best[1]:
                best = (name, e - s)
        return best[0]

    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    compute = [(e.time_range.start, e.time_range.end) for e in dev
               if COLLECTIVE not in e.name.lower()]
    end = max([w1] + [b for _, b in intervals])
    kernels, by_span = {}, {}
    for e in dev:
        us = e.time_range.end - e.time_range.start
        name = kernel_name(e.name)
        _add(kernels, name, us)
        t = launch_at.get(e.id)
        _add(by_span.setdefault(span_of(t) if t is not None else "", {}), name, us)
    return {"window_s": (end - w0) / 1e6, "busy_s": busy_us(intervals) / 1e6,
            "compute_busy_s": busy_us(compute) / 1e6,
            "lost_launches": lost, "launches": len(launch_calls), "kernels": kernels,
            "by_span": by_span, "spans": span_table,
            "gaps": _gaps(intervals, host, w0, end)}


def idle_pct(ranks) -> float | None:
    """100 − the share of each rank's traced window in which a kernel other
    than a collective, or a copy, ran; the mean over ranks."""
    shares = [100.0 * (1.0 - r["compute_busy_s"] / r["window_s"])
              for r in ranks if r["window_s"] > 0]
    return sum(shares) / len(shares) if shares else None


def _gaps(intervals, host, w0, w1):
    """The device's idle gaps in [w0, w1], the longest labelled with the
    innermost host event that spans the gap's middle, summed by label."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    names = [e.name for e in host]
    keep = np.array([not n.startswith(RECORDED) for n in names], dtype=bool)
    out = {}
    for a, b in gaps[:LABELLED_GAPS]:
        mid = 0.5 * (a + b)
        hit = np.nonzero(keep & (starts <= mid) & (ends >= mid))[0]
        label = names[hit[np.argmin(ends[hit] - starts[hit])]] if hit.size else "host (no op)"
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    rest = sum(b - a for a, b in gaps[LABELLED_GAPS:]) / 1e6
    if rest:
        out["shorter gaps"] = rest
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])
