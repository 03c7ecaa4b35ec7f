"""Run one cell of BENCHMARK.json on the card(s) and print one JSON result line.

usage: python3 sosbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each run is one process per card: set-up (the program's imports, its
kernels' build on a checkout's first run, its tables), one warm request of
the cell's own shapes, then the measured window, then the check of what the
window produced against the plain reference (``check.py``).  With
``--trace 1`` the window is a fixed number of requests under the profiler
(``trace.py``) and the result holds the cell's per-layer metrics; with
``--trace 0`` it lasts ``--seconds`` (whole requests) and holds the
end-to-end metrics.  A cell on several cards starts one process per card
(ranks 1.. as children of this one, rank 0 here), each with its process
group on a free local TCP port before the program's ``make_mesh()``.

It fails, and prints no result, without a card (or with fewer than the
cell asks for), when the window's calls took another route than the cell
names (by the program's launch counters), or when a module of the JAX
package is loaded once the window has closed (``guard.py``).
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import datetime  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the program's phase-table cache at a fixed path inside the checkout
os.environ["SOS_RT_CACHE_DIR"] = os.path.join(ROOT, "build", "sosbench", "phase_tables")

from sosbench import card, check, guard, spec, stats, trace  # noqa: E402

TOP = 10   # entries of each breakdown list


def log(msg: str) -> None:
    print(f"sosbench: {msg}", file=sys.stderr, flush=True)


def counters() -> dict:
    """The program's launch counters: {kernel: launches, kernel.tc:
    tensor-core launches}."""
    from sos_rt_tpu_torch.ops.megastream import COUNTED_KERNELS

    out = {}
    for k in COUNTED_KERNELS:
        out[k.__name__] = k.launches
        if hasattr(k, "tc_launches"):
            out[k.__name__ + ".tc"] = k.tc_launches
    return out


def route_faults(route: dict, delta: dict) -> list:
    """How the window's launches ``delta`` break the cell's ``route``
    ({zero: [...], nonzero: [...], all_tc: [...]})."""
    bad = [f"{k} = {delta[k]}, not 0" for k in route.get("zero", []) if delta[k] != 0]
    bad += [f"{k} = 0" for k in route.get("nonzero", []) if delta[k] == 0]
    bad += [f"{k}: {delta[k + '.tc']} of {delta[k]} on the tensor cores"
            for k in route.get("all_tc", []) if delta[k + ".tc"] != delta[k]]
    return bad


class TracedRun:
    """What a per-layer metric reads: the ranks' trace readings, rank 0's
    request records, the ranks' launch-counter deltas, the window's peak
    memory and its seconds on the host's clock, and the cell's
    configuration."""

    def __init__(self, cell, ranks, records, deltas, window_peak_bytes, wall=0.0):
        self.config = cell.config
        self.ranks, self.records, self.deltas = ranks, records, deltas
        self.window_peak_bytes, self.wall = window_peak_bytes, wall

    def kernel_calls(self, name: str) -> int:
        return sum(k["calls"] for r in self.ranks for n, k in r["kernels"].items() if n.endswith(name))

    def kernel_s(self, name: str, span: str | None = None) -> float:
        tables = [r["kernels"] if span is None else r["by_span"].get(span, {}) for r in self.ranks]
        return sum(k["s"] for t in tables for n, k in t.items() if n.endswith(name))

    def counter_sum(self, names) -> int:
        return sum(d[n] for d in self.deltas for n in names)

    def orders(self):
        import numpy as np
        return np.concatenate([r["n_orders"] for r in self.records])


SOLVE_TIMED = {"sweep_solve_columns_per_s"}   # end-to-end metrics that read SOLVE_S
SOLVE_S = [0.0]   # this rank's seconds inside the program's parallel.solve_batch calls


def wrap_spans(torch_mod):
    """Record the benchmark's spans around the program's layer calls:
    ``sosbench.solve_batch`` around ``sos_rt_tpu_torch.parallel.solve_batch``
    (closed when the device has finished, its seconds added to
    ``SOLVE_S``) and ``sosbench.predictor`` around
    ``fused.predict_order_count``.  A second call wraps nothing again."""
    import sos_rt_tpu_torch.parallel as par
    from sos_rt_tpu_torch import fused
    from torch.profiler import record_function

    if getattr(par.solve_batch, "sosbench_span", False):
        return
    solve, predict = par.solve_batch, fused.predict_order_count

    def solve_batch(*a, **kw):
        t0 = time.perf_counter()
        with record_function("sosbench.solve_batch"):
            out = solve(*a, **kw)
            if torch_mod.cuda.is_available():
                torch_mod.cuda.synchronize()
        SOLVE_S[0] += time.perf_counter() - t0
        return out

    def predict_order_count(*a, **kw):
        with record_function("sosbench.predictor"):
            return predict(*a, **kw)

    solve_batch.sosbench_span = True
    par.solve_batch, fused.predict_order_count = solve_batch, predict_order_count


def window(entry, seconds: float, requests: int, mesh, dist):
    """Requests back to back until ``seconds`` have passed (or, with
    ``requests`` > 0, that many units have run), whole requests only; rank
    0 decides when to stop.  Returns (records, seconds)."""
    records, units = [], 0
    t0 = time.perf_counter()
    while True:
        records += entry.step()
        units += 1
        stop = units >= requests if requests else time.perf_counter() - t0 >= seconds
        if mesh is not None:
            box = [stop]
            dist.broadcast_object_list(box, src=0)
            stop = box[0]
        if stop:
            return records, time.perf_counter() - t0


def execute(cell, seed: int, seconds: float, traced: bool, device, rank: int = 0,
            world: int = 1, port: int = 0) -> dict | None:
    """One rank's run of ``cell``; rank 0 returns the result line's dict
    (other ranks None).  ``device`` may be the CPU (tests): then nothing of
    the card is read, no route is checked (the plain versions count no
    launch) and no trace is taken."""
    import torch
    import torch.distributed as dist

    on_card = device.type == "cuda"
    mesh = None
    stages = [("imports", time.monotonic())]
    if world > 1:
        if on_card:
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if on_card else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300),
                                device_id=device if on_card else None)
        from sos_rt_tpu_torch.parallel import make_mesh
        mesh = make_mesh(device=device.type)
        stages.append(("process group", time.monotonic()))
    wl = cell.workload
    if traced or SOLVE_TIMED & {m["name"] for m in cell.end_to_end}:
        wrap_spans(torch)
    entry = cell.entry().Entry(cell, seed, device, mesh)
    stages.append(("entry", time.monotonic()))
    try:
        entry.warm()
        if on_card:
            torch.cuda.synchronize(device)
            setup_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        stages.append(("warm request", time.monotonic()))
        if rank == 0:
            marks = [T_START] + [t for _, t in stages]
            log("set-up (s): " + ", ".join(f"{n} {b - a:.2f}" for (n, _), a, b in
                                            zip(stages, marks, marks[1:])))
        n_traced = int(wl["trace"]["requests"]) if traced else 0
        before = {}

        def body():
            before.update(counters())
            SOLVE_S[0] = 0.0
            return window(entry, seconds, n_traced, mesh, dist)

        t_open = time.monotonic()
        reading = None
        if traced and on_card:
            (records, wall), reading = trace.traced(torch, device, entry.warm, body)
        else:
            records, wall = body()
        solve_s = SOLVE_S[0]
        delta = {k: v - before[k] for k, v in counters().items()}
        peak = window_peak = 0
        if on_card:
            torch.cuda.synchronize(device)
            window_peak = torch.cuda.max_memory_allocated(device)
            peak = max(setup_peak, window_peak)
            faults = route_faults(wl["route"], delta)
            if faults:
                raise RuntimeError(f"rank {rank}: the window's calls took another route "
                                   f"than {cell.name}'s: {'; '.join(faults)}")
        mine = {"reading": reading, "delta": delta, "peak": peak, "window_peak": window_peak}
        if mesh is not None:
            gathered = [None] * world if rank == 0 else None
            dist.gather_object(mine, gathered, dst=0)
        else:
            gathered = [mine]
        entry.release()
        if rank != 0:
            return None
        result = {"attempted": len(records), "failed": 0}
        log(f"window: {len(records)} requests, {wall:.4f} s, "
            f"{solve_s:.4f} s in sosbench.solve_batch")
        if traced:
            result["metrics"] = per_layer(cell, gathered, records, on_card, wall)
        else:
            result["metrics"] = end_to_end(cell, records, wall, t_open - T_START, solve_s)
        result["device"] = {"platform": "gpu" if on_card else "cpu",
                            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                            "count": world,
                            "memory_peak_bytes": max(g["peak"] for g in gathered)}
        if traced and on_card:
            rs = [g["reading"] for g in gathered]
            result["device"]["busy_s"] = sum(r["busy_s"] for r in rs) / len(rs)
            result["device"]["window_s"] = sum(r["window_s"] for r in rs) / len(rs)
            result["breakdown"] = breakdown(rs)
            lost = sum(r["lost_launches"] for r in rs)
            log(f"traced window: {sum(r['launches'] for r in rs)} launch calls, "
                f"{lost} without a device record")
        if on_card:
            torch.cuda.empty_cache()
        # the check, once the window has closed and its peak has been read
        scenes, answers, p0_mu0 = entry.sample(int(wl["check"]["columns"]))
        ref = check.reference(cell.config, scenes, p0_mu0, device,
                              block=int(wl["check"].get("block", 64)), base=cell.base)
        found = check.numbers(answers, ref)
        log("compared numbers (all): " + json.dumps(found))
        result["correct"], result["check"] = check.judge(found, wl["check"]["limits"])
        return result
    finally:
        close = getattr(entry, "close", None)
        if close:
            close()
        if mesh is not None:
            dist.barrier()
            dist.destroy_process_group()


def end_to_end(cell, records, wall: float, setup_s: float, solve_s: float = 0.0) -> dict:
    converged = sum(r["converged"] for r in records)
    rate = converged / wall
    values = {"columns_per_s": rate, "sweep_columns_per_s": rate,
              "call_p90_ms": 1e3 * stats.percentile([r["wall_s"] for r in records], 90),
              "setup_s": setup_s}
    if solve_s > 0:
        values["sweep_solve_columns_per_s"] = converged / solve_s
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def per_layer(cell, gathered, records, on_card: bool, wall: float = 0.0) -> dict:
    run = TracedRun(cell, [g["reading"] for g in gathered] if on_card else [], records,
                    [g["delta"] for g in gathered], max(g["window_peak"] for g in gathered),
                    wall)
    out = {}
    for m in cell.per_layer:
        reader = spec.layer_metric(m["name"], cell.base)
        value = reader.read(run) if on_card else None
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(readings) -> dict:
    ops = {}
    for r in readings:
        for name, k in r["kernels"].items():
            ops[name] = ops.get(name, 0.0) + k["s"] / len(readings)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in readings[0]["gaps"][:TOP]]}


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload, spec.benchmark(ROOT))

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}")
        return 2
    children = []
    if args.rank == 0:
        log(f"cards: {card.power_limits()} (name, power.limit); "
            f"{torch.cuda.device_count()} visible, {cell.chips} used")
        if cell.chips > 1:
            args.port = free_port()
            base = [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
                    "--seed", str(args.seed), "--seconds", str(args.seconds),
                    "--trace", str(args.trace), "--port", str(args.port)]
            children = [subprocess.Popen(base + ["--rank", str(r)], stdout=subprocess.DEVNULL)
                        for r in range(1, cell.chips)]
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", args.rank), args.rank, cell.chips, args.port)
    except BaseException:
        for c in children:
            c.kill()
        raise
    finally:
        codes = [c.wait() for c in children]
    bad = guard.forbidden_loaded()
    if bad:
        log(f"modules of the JAX package are loaded: {bad}")
        return 3
    if args.rank != 0:
        return 0
    if any(codes):
        log(f"ranks exited with {codes}")
        return 4
    for name, v in result["check"].items():
        log(f"check {name}: {v['value']!r} (limit {v['limit']!r})")
    result = {"correct": result["correct"], "attempted": result["attempted"],
              "failed": result["failed"], "metrics": result["metrics"],
              "device": result["device"],
              **({"breakdown": result["breakdown"]} if "breakdown" in result else {}),
              "check": result["check"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
