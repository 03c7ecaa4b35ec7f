"""peak_mem_gib.mesh: ``peak_mem_gib.sweep``, read in the four-card sweep,
whose end-to-end rate is ``sweep_solve_columns_per_s``."""
import os

from sosbench import spec

UNIT = "GiB"


def read(run):
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return spec.layer_metric("peak_mem_gib.sweep", base).read(run)
