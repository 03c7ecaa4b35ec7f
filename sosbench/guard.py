"""The run's guard against the JAX package: no module whose top-level
name (the part before the first dot, compared whole) is one of
:data:`FORBIDDEN` may be loaded in a benchmark process."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sos_rt_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
