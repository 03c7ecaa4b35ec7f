"""products_roofline_pct.stream: the least time of the streamed route's
tensor-core products (every further order's Jₙ source product and each
column's I₁ product, counted from each column's own order count, in the
configuration's split mode: bf16x3 is three bf16 passes at 989 TFLOP/s)
over the device time of the ``quad_mma`` kernels (``csrc/quad_mma.cuh``,
the mainloop of passA and passI) in the traced window.  A window whose
trace lacks a launch that passA's and passI's counters counted fails."""
from sosbench import roofline

UNIT = "%"
KERNEL = "quad_mma"
COUNTERS = ("passA.tc", "passI.tc")


def read(run):
    cfg = run.config
    n = run.kernel_calls(KERNEL)
    counted = run.counter_sum(COUNTERS)
    if n != counted:
        raise RuntimeError(f"the trace holds {n} {KERNEL} launches, the counters {counted}")
    if not n:
        return None
    orders = run.orders()
    least, _ = roofline.stream_products(orders, cfg["grid"]["nb_layers"],
                                        cfg["grid"]["nb_angles"], cfg["mm"])
    return 100.0 * least / run.kernel_s(KERNEL)
