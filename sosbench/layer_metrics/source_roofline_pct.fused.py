"""source_roofline_pct.fused: the least time of the fused engine's
split-mode Jₙ source (``csrc/fused_source.cu``, whose kernel is
``quad_mma``) for every further order of each column, from its own order
count, over the device time of its launches in the traced window.  The
route's counters hold passA and passI at zero, so every ``quad_mma`` launch
is the source kernel's; a trace that lacks one of them fails."""
from sosbench import roofline

UNIT = "%"
KERNEL = "quad_mma"
COUNTERS = ("fused_source",)


def read(run):
    cfg = run.config
    n = run.kernel_calls(KERNEL)
    counted = run.counter_sum(COUNTERS)
    if n != counted:
        raise RuntimeError(f"the trace holds {n} {KERNEL} launches, the counters {counted}")
    if not n:
        return None
    least, _ = roofline.fused_source(run.orders(), cfg["grid"]["nb_layers"],
                                     cfg["grid"]["nb_angles"], cfg["mm"], n)
    return 100.0 * least / run.kernel_s(KERNEL)
