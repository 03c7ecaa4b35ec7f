"""device_idle_pct: 100 − the share of the traced window in which a
kernel or a copy ran on the device (the union of their intervals), in the
cells of library calls (``columns_per_s``)."""
from sosbench import trace

UNIT = "%"


def read(run):
    return trace.idle_pct(run.ranks)
