"""sweep_host_pct: the share of the traced window's wall outside the spans
that the benchmark records around the sweep's calls of
``sos_rt_tpu_torch.parallel.solve_batch`` (``sosbench.solve_batch``, each
ending when the device has finished): the sweep layer's own host work
(µ0 tables, shard compression and writing, the index, ``load_sweep``).
On several cards the mean over ranks.  A window with no such span fails
the run."""
UNIT = "%"
SPAN = "sosbench.solve_batch"


def read(run):
    shares = []
    for r in run.ranks:
        span = r["spans"].get(SPAN)
        if not span or span["calls"] == 0:
            raise RuntimeError(f"the traced window recorded no {SPAN} span")
        shares.append(100.0 * (1.0 - span["s"] / r["window_s"]))
    return sum(shares) / len(shares)
