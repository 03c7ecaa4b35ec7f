"""Find a cell's files by name: its configuration, traffic, entry,
per-layer metrics and phase models, and the lines of ``BENCHMARK.json``
that name them.

A configuration file is JSON, in which a complex number is written as an
object of exactly the two keys ``re`` and ``im``: ``{"re": 1.7, "im":
0.03}`` is 1.7 + 0.03j.  ``config`` decodes every such object, wherever it
sits, into a Python ``complex`` as it loads the file, so every reader (the
entries, the check's reference, the tests) gets the same value.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def read_json(path: str, object_hook=None) -> dict:
    with open(path) as fh:
        return json.load(fh, object_hook=object_hook)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


COMPLEX_KEYS = {"re", "im"}


def _complex(obj: dict):
    return complex(obj["re"], obj["im"]) if set(obj) == COMPLEX_KEYS else obj


def config(name: str, base: str = HERE) -> dict:
    """The configuration ``name``, its complex numbers decoded (see the module)."""
    return read_json(os.path.join(base, "configs", f"{name}.json"), _complex)


def traffic(name: str, base: str = HERE) -> dict:
    return read_json(os.path.join(base, "traffic", f"{name}.json"))


def workload(name: str, base: str = HERE) -> dict:
    return read_json(os.path.join(base, "workloads", f"{name}.json"))


def _module(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, base: str = HERE):
    """The module that drives the program's entry ``name``."""
    return _module(os.path.join(base, "entries", f"{name}.py"), f"sosbench_entry_{name}")


def layer_metric(name: str, base: str = HERE):
    """The reader of the per-layer metric ``name``."""
    return _module(os.path.join(base, "layer_metrics", f"{name}.py"),
                   "sosbench_metric_" + name.replace(".", "_"))


def phase_model(kind: str, base: str = HERE):
    """The reference's phase model ``kind``: the file
    ``reference/models/<kind>.py``, which exposes ``kernel(params)``."""
    models = os.path.join(base, "reference", "models")
    path = os.path.join(models, f"{kind}.py")
    if os.path.dirname(kind) or not os.path.isfile(path):
        have = sorted(f for f in os.listdir(models) if f.endswith(".py"))
        raise ValueError(f"the reference has no phase model {kind!r}: {models} holds {have}")
    return _module(path, f"sosbench_phase_model_{kind}")


WORKLOAD_KEYS = {"route", "trace", "check"}


class Cell:
    """One cell: its line of ``BENCHMARK.json`` (configuration, traffic,
    chips, why) with the files it names.  The cell's own file holds only
    what the line does not: its route, traced request count and check."""

    def __init__(self, name: str, bench: dict, base: str = HERE):
        lines = [w for w in bench["workloads"] if w["name"] == name]
        if not lines:
            raise KeyError(f"BENCHMARK.json has no cell {name!r}")
        self.line = lines[0]
        self.name = name
        self.chips = int(self.line["chips"])
        self.config = config(self.line["config"], base)
        self.traffic = traffic(self.line["traffic"], base)
        self.workload = workload(name, base)
        if set(self.workload) != WORKLOAD_KEYS:
            raise ValueError(f"workloads/{name}.json holds {sorted(self.workload)}, "
                             f"not {sorted(WORKLOAD_KEYS)}")
        if self.config["name"] != self.line["config"]:
            raise ValueError(f"configs/{self.line['config']}.json names itself "
                             f"{self.config['name']!r}")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
        self.base = base

    def entry(self):
        return entry(self.traffic["entry"], self.base)
