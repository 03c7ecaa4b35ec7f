"""products_roofline_pct.specular: the least time of the streamed route's
tensor-core products on a specular surface over the device time of every
``quad_mma`` launch (``csrc/quad_mma.cuh``, the mainloop of passA and
passI) in the traced window.

On a specular surface I₁ has no surface product (passI's mainloop runs
with K = 0 and its epilogue evaluates the closed form), so the count is
every further order's Jₙ source product alone, from each column's own
order count, in the configuration's split mode, against reading each
product's field and writing its result (4-byte values), as
``roofline.stream_products`` counts them less I₁'s term.  passI's launches
are still I₁'s kernel and their time counts below the line.  A window
whose trace lacks a launch that passA's and passI's counters counted
fails."""
import numpy as np

from sosbench import roofline
from sosbench.card import SPLIT_PASSES

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
    L, width = cfg["grid"]["nb_layers"], cfg["grid"]["nb_angles"]
    further = int((np.asarray(orders, dtype=np.int64) - 1).sum())
    flops = roofline.source_flops(orders, L, width, SPLIT_PASSES[cfg["mm"]])
    least, _ = roofline.least_s(flops, 2 * L * 2 * width * 4 * further, "bf16")
    return 100.0 * least / run.kernel_s(KERNEL)
