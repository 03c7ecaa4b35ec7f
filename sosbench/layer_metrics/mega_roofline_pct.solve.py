"""mega_roofline_pct.solve: ``mega_roofline_pct.sweep``, read in the cell
of library calls on sweep chunks (``fwc.solve``), whose end-to-end rate is
``columns_per_s``: each traced call's fine resident solve against its
columns' own order counts, the predictor's launches left out."""
import os

from sosbench import spec

UNIT = "%"


def read(run):
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return spec.layer_metric("mega_roofline_pct.sweep", base).read(run)
