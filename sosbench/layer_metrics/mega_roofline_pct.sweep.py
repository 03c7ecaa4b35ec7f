"""mega_roofline_pct.sweep: the least time of the resident solves
(``csrc/megakernel.cu::sos_mega``, kernel ``mega_kernel``) of the traced
chunks, from each column's own order count (``roofline.mega``, per chunk),
over the device time of the fine solve's launches, summed over ranks.  The
predictor's coarse 8×16 launches, which run inside the span that the
benchmark records around ``fused.predict_order_count``, are left out of
both sides.  A trace that lacks a launch that ``mega_call`` counted
fails."""
from sosbench import roofline

UNIT = "%"
KERNEL = "mega_kernel"
PREDICTOR = "sosbench.predictor"
COUNTERS = ("mega_call",)


def read(run):
    cfg = run.config
    n = run.kernel_calls(KERNEL)
    counted = run.counter_sum(COUNTERS)
    if n != counted:
        raise RuntimeError(f"the trace holds {n} {KERNEL} launches, the counters {counted}")
    fine_s = run.kernel_s(KERNEL) - run.kernel_s(KERNEL, span=PREDICTOR)
    if not n or fine_s <= 0:
        return None
    mm = cfg["mm"] or "bf16x3"
    least = sum(roofline.mega(rec["n_orders"], cfg["grid"]["nb_layers"],
                              cfg["grid"]["nb_angles"], mm)[0] for rec in run.records)
    return 100.0 * least / fine_s
