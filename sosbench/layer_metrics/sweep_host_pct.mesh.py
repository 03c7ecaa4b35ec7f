"""sweep_host_pct.mesh: ``sweep_host_pct``, read in the four-card sweep,
whose end-to-end rate is ``sweep_solve_columns_per_s``."""
import os

from sosbench import spec

UNIT = "%"


def read(run):
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return spec.layer_metric("sweep_host_pct", base).read(run)
