"""The port's profiler spans: every name it records, and the one helper
that records them.

A span is a ``torch.profiler.record_function`` range.  Under a profiler it
is a host event on the same clock as the device's records, so a trace can
put device work, and the device's idle time, down to the innermost span
around it; without one it costs a few microseconds.  The solver's stage
scopes keep the JAX package's names (``sos.first_order``,
``sos.source_jn``, ``sos.down_sweep``, ``sos.up_sweep_bc``).

===================  ====================================================
``SWEEP_TABLES``     ``sweep.build_sweep_batch``: the phase tables
``SWEEP_SOLVE``      ``sweep.run_sweep``: one chunk's solve, to the
                     device's end
``SWEEP_SHARD``      ``run_sweep``: one chunk's summary copied to the host,
                     compressed and written, with ``index.json``
``SWEEP_LOAD``       ``sweep.load_sweep``: the shards read back
``SWEEP_BARRIER``    ``run_sweep`` on a mesh: the ranks' closing barrier
``MESH_GATHER``      ``parallel/mesh.py::solve_shards``: the gather of one
                     shard's result
``MEGA_SORT``        ``fused.solve_batch_mega``: the sort key (predictor
                     included) and both argsorts
``MEGA_PREDICT``     ``fused.predict_order_count``: the coarse pre-solve
``MEGA_PREPARE``     ``fused.prepare_batch``: the host preparation
``MEGA_SOLVE``       ``solve_batch_mega``: the order loop (streamed or
                     resident) and the summary's assembly
``ORDER``            one iteration of the host order loops
                     (``ops/megastream.py::solve_block``,
                     ``fused.solve_batch_fused``): one order of one block
``ORDER_COMPACT``    ``solve_block``: one gather of a block's running
                     columns into narrower planes, inside ``sos.order``
``LOOP_COND``        each read of those loops' condition: one host sync
``FIRST_ORDER``      the reference engine's first order, and passI's
                     launch in ``ops/megastream.py::solve_block`` (on a
                     specular surface the closed form with no surface
                     product)
``TABLES_BUILD``     ``models.build_phase_tables``: a build that the cache
                     did not answer (the Mie series runs here)
===================  ====================================================
"""
from __future__ import annotations

import contextlib
import time

from torch.profiler import record_function

FIRST_ORDER = "sos.first_order"
SOURCE_JN = "sos.source_jn"
DOWN_SWEEP = "sos.down_sweep"
UP_SWEEP_BC = "sos.up_sweep_bc"

SWEEP_TABLES = "sos.sweep.tables"
SWEEP_SOLVE = "sos.sweep.solve"
SWEEP_SHARD = "sos.sweep.shard"
SWEEP_LOAD = "sos.sweep.load"
SWEEP_BARRIER = "sos.sweep.barrier"
MESH_GATHER = "sos.mesh.gather"
MEGA_SORT = "sos.mega.sort"
MEGA_PREDICT = "sos.mega.predict"
MEGA_PREPARE = "sos.mega.prepare"
MEGA_SOLVE = "sos.mega.solve"
ORDER = "sos.order"
ORDER_COMPACT = "sos.order.compact"
LOOP_COND = "sos.loop_cond"
TABLES_BUILD = "sos.tables.build"

RECORDED_CALL = "sos.recorded_call"     # the window of tools/profile.py's trace


@contextlib.contextmanager
def span(name: str, into: dict | None = None):
    """Record the span ``name`` around the block; where ``into`` is given,
    also add the block's ``time.perf_counter`` seconds to ``into[name]``.
    Usable as a decorator."""
    with record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if into is not None:
                into[name] = into.get(name, 0.0) + time.perf_counter() - t0
