"""sweep_columns_per_s.mesh: the whole sweep command's rate in the traced
window of the four-card sweep: converged columns of its chunks over the
window's seconds on the host's clock (tables, chunks, shards, index,
``load_sweep``).  Its end-to-end form, ``sweep_columns_per_s``, follows
rank 0's host too closely on four cards to hold a bound there."""
UNIT = "columns/s"


def read(run):
    if not run.records or run.wall <= 0:
        return None
    return sum(r["converged"] for r in run.records) / run.wall
