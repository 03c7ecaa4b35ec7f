"""The benchmark of the PyTorch and CUDA port (``sos_rt_tpu_torch``).

``python3 sosbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card(s) and
prints one JSON result line.  Everything that belongs to one configuration,
traffic mix, cell, entry or per-layer metric is a file of its own, found by
its name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``entries/<entry>.py``,
``layer_metrics/<metric>.py``.  ``reference/`` is the plain solver that
decides ``correct``; it imports nothing of the program.
"""
