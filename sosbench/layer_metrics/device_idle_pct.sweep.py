"""device_idle_pct.sweep: 100 − the share of the traced window in which a
kernel other than a collective, or a copy, ran on the device, in the sweep
cells (``sweep_columns_per_s``); on several cards the mean over ranks.
NCCL's kernels spin while ranks wait for the shard writer: that time is
``collective_ms_per_chunk``'s, and counts as idle here."""
from sosbench import trace

UNIT = "%"


def read(run):
    return trace.idle_pct(run.ranks)
