"""Shared by the benchmark's tests: a copy of the benchmark's files in a
temporary directory with a cell cut to a test size."""
from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sosbench import spec  # noqa: E402

TINY_GRID = {"nb_angles": 16, "nb_layers": 32}


def edit_json(path: str, **changes) -> None:
    with open(path) as fh:
        data = json.load(fh)
    for key, value in changes.items():
        data[key] = value
    with open(path, "w") as fh:
        json.dump(data, fh)


def small_cell(tmp_path, name: str, grid=TINY_GRID, batch: int = 8, sweep: int = 40,
               chunk: int = 16, columns: int = 16, limits=None):
    """The cell ``name`` from a copy of the benchmark's files under
    ``tmp_path``, cut to ``grid``, calls of ``batch`` columns or sweeps of
    ``sweep`` columns in chunks of ``chunk``, its check on ``columns``."""
    base = str(tmp_path / "sosbench")
    shutil.copytree(BENCH_DIR, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = spec.benchmark(ROOT)
    line = [w for w in bench["workloads"] if w["name"] == name][0]
    cfg = spec.config(line["config"], base)
    edit_json(os.path.join(base, "configs", line["config"] + ".json"), grid=grid,
              **({"batch": sweep} if "batch" in cfg else {}))
    tr = spec.traffic(line["traffic"], base)
    edit_json(os.path.join(base, "traffic", line["traffic"] + ".json"),
              **({"batch": batch} if "batch" in tr else {"chunk": chunk}))
    wl = spec.workload(name, base)
    check = dict(wl["check"], columns=columns)
    if limits is not None:
        check["limits"] = limits
    edit_json(os.path.join(base, "workloads", name + ".json"), check=check)
    return spec.Cell(name, bench, base)
