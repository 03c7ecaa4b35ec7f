"""Find a cell's files by name: its configuration, traffic, entry and
per-layer metrics, and the lines of ``BENCHMARK.json`` that name them."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def config(name: str, base: str = HERE) -> dict:
    return read_json(os.path.join(base, "configs", f"{name}.json"))


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
