"""The p90 over all requests, the union busy time and the idle share of a
synthetic trace, and the end-to-end arithmetic."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from sosbench import run, stats, trace


def test_p90_over_all_requests():
    walls = list(range(1, 101))                  # 1..100 ms
    assert stats.percentile(walls, 90) == pytest.approx(np.percentile(walls, 90))
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([1, 2, 3, 4, 1000], 90) == pytest.approx(np.percentile([1, 2, 3, 4, 1000], 90))


def test_busy_union():
    assert stats.busy_us([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25


def _ev(name, start, end, dev=False, cid=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if dev else DeviceType.CPU,
                           id=cid, is_user_annotation=False)


def synthetic():
    """A 1000 µs window: two kernels launched inside a benchmark span, one
    copy, one launch whose device record is lost, and a host op in the
    long gap."""
    return [
        _ev("cudaLaunchKernel", 50, 52, cid=99),            # before the window: ignored
        _ev("void sos::tc::quad_mma<1>(x)", 60, 90, dev=True, cid=99),
        _ev(trace.RECORDED, 100, 1100),
        _ev("sosbench.solve_batch", 110, 600),
        _ev("cudaLaunchKernel", 120, 125, cid=1),
        _ev("cudaLaunchKernel", 130, 135, cid=2),
        _ev("cudaMemcpyAsync", 140, 145, cid=3),
        _ev("cudaLaunchKernel", 150, 155, cid=4),           # lost
        _ev("void sos::tc::quad_mma<1>(x)", 200, 300, dev=True, cid=1),
        _ev("void mega_kernel<float, 1, 256, 0>(MegaArgs)", 250, 400, dev=True, cid=2),
        _ev("Memcpy DtoH (Device -> Pageable)", 400, 450, dev=True, cid=3),
        _ev("aten::savez", 700, 1000),
    ]


def test_trace_reading():
    r = trace.read(synthetic())
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx(250e-6)          # [200, 450]
    assert r["lost_launches"] == 1 and r["launches"] == 3
    assert r["kernels"]["sos::tc::quad_mma"] == {"calls": 1, "s": pytest.approx(100e-6)}
    assert r["by_span"]["sosbench.solve_batch"]["mega_kernel"]["calls"] == 1
    assert r["spans"]["sosbench.solve_batch"]["s"] == pytest.approx(490e-6)
    gaps = dict(r["gaps"])
    assert gaps["aten::savez"] == pytest.approx(650e-6)   # the gap [450, 1100]
    assert sum(gaps.values()) == pytest.approx(750e-6)


def test_idle_share_and_host_share_from_the_trace():
    r = trace.read(synthetic())
    cell = SimpleNamespace(config={})
    traced = run.TracedRun(cell, [r], [{"n_orders": np.array([3, 4])}], [{}], 0)
    from sosbench import spec
    assert spec.layer_metric("device_idle_pct").read(traced) == pytest.approx(75.0)
    assert spec.layer_metric("sweep_host_pct").read(traced) == pytest.approx(51.0)
    assert traced.kernel_s("mega_kernel") == pytest.approx(150e-6)
    assert traced.kernel_calls("quad_mma") == 1


def test_collectives_count_as_idle():
    """NCCL's kernels, which spin while a rank waits for the others, count
    in the device's busy time but not in ``device_idle_pct.sweep``'s."""
    events = synthetic() + [_ev("cudaLaunchKernel", 160, 165, cid=5),
                            _ev("ncclDevKernel_AllGather_RING_LL(x)", 500, 900, dev=True, cid=5)]
    r = trace.read(events)
    assert r["busy_s"] == pytest.approx(650e-6)          # [200, 450] and [500, 900]
    assert r["compute_busy_s"] == pytest.approx(250e-6)
    traced = run.TracedRun(SimpleNamespace(config={}), [r], [], [{}], 0)
    from sosbench import spec
    assert spec.layer_metric("device_idle_pct.sweep").read(traced) == pytest.approx(75.0)


def test_end_to_end_arithmetic():
    cell = SimpleNamespace(end_to_end=[{"name": n, "unit": u} for n, u in
                                       (("columns_per_s", "columns/s"), ("call_p90_ms", "ms"),
                                        ("sweep_columns_per_s", "columns/s"), ("setup_s", "s"))])
    records = [{"wall_s": 0.1 * (i + 1), "converged": 10} for i in range(10)]
    m = run.end_to_end(cell, records, 5.0, 12.5)
    assert m["columns_per_s"]["value"] == pytest.approx(20.0)
    assert m["sweep_columns_per_s"]["value"] == pytest.approx(20.0)
    assert m["call_p90_ms"]["value"] == pytest.approx(1e3 * np.percentile([r["wall_s"] for r in records], 90))
    assert m["setup_s"] == {"value": 12.5, "unit": "s"}


def test_solve_rate_and_whole_sweep_rate_of_the_mesh_cell():
    """``sweep_solve_columns_per_s`` counts the window's converged columns
    over the seconds inside ``solve_batch``; ``sweep_columns_per_s.mesh``
    counts them over the traced window's wall."""
    cell = SimpleNamespace(end_to_end=[{"name": "sweep_solve_columns_per_s", "unit": "columns/s"}])
    records = [{"wall_s": 1.0, "converged": 10} for _ in range(4)]
    m = run.end_to_end(cell, records, 5.0, 12.5, solve_s=0.5)
    assert m["sweep_solve_columns_per_s"]["value"] == pytest.approx(80.0)
    with pytest.raises(KeyError):
        run.end_to_end(cell, records, 5.0, 12.5)           # no solve timed: no number
    from sosbench import spec
    traced = run.TracedRun(SimpleNamespace(config={}), [], records, [{}], 0, 8.0)
    assert spec.layer_metric("sweep_columns_per_s.mesh").read(traced) == pytest.approx(5.0)
    assert spec.layer_metric("sweep_columns_per_s.mesh").read(
        run.TracedRun(SimpleNamespace(config={}), [], [], [{}], 0, 8.0)) is None
