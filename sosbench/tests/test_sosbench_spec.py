"""Every file that BENCHMARK.json names loads by its name; a new cell is
files and one entry, with no edit to a file that is there."""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import pytest

from sosbench import check, spec, traffic_gen
from sosbench.tests.helpers import BENCH_DIR, ROOT

BENCH = spec.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = spec.Cell(cell, BENCH)
    assert set(c.workload) == spec.WORKLOAD_KEYS
    assert c.config["name"] == c.line["config"]
    assert callable(c.entry().Entry)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert {m["moves"] for m in c.per_layer} <= names and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_loads_by_name(metric):
    reader = spec.layer_metric(metric)
    assert callable(reader.read)
    line = [m for m in BENCH["per_layer"] if m["name"] == metric][0]
    assert reader.UNIT == line["unit"]
    assert line["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["sosbench"] and BENCH["command"][1] == "sosbench/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert set(c["reduced"]) == set(spec.read_json(os.path.join(ROOT, c["file"]))["reduced"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_are_the_presets():
    """The configurations are the port's presets as they are run."""
    from sos_rt_tpu_torch.presets import get_preset

    for cfg_name, preset, over in (("fwc_sweep", "fwc_sweep", {}),
                                   ("hg_canonical", "hg", {"dtype": "float32", "mm": "bf16x3"})):
        cfg, p = spec.config(cfg_name), get_preset(preset)
        assert cfg["grid"] == {"nb_angles": p.grid.nb_angles, "nb_layers": p.grid.nb_layers}
        assert tuple(cfg["atm"]) == p.atm and tuple(cfg["aer"]) == p.aer
        assert cfg["surface"] == p.opts.surface
        assert cfg["dtype"] == over.get("dtype", p.opts.dtype)
        assert cfg["mm"] == over.get("mm", p.opts.mm)
        assert cfg["tol"] == p.opts.tol and cfg["max_orders"] == p.opts.max_orders
        for k, v in cfg["scene"].items():
            if k != "grd_alb":
                assert getattr(p.scene, k) == v, k
    assert spec.config("fwc_sweep")["batch"] == get_preset("fwc_sweep").batch


@pytest.mark.parametrize("fault", ["workload key", "config name"])
def test_cell_refuses_a_second_copy(tmp_path, fault):
    """What BENCHMARK.json's line says (configuration, traffic, chips, why)
    is not written again in the cell's file, and a configuration's file
    names itself as the line does."""
    base = tmp_path / "sosbench"
    shutil.copytree(BENCH_DIR, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    if fault == "workload key":
        path = base / "workloads" / "canonical.stream.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), chips=1)))
    else:
        path = base / "configs" / "hg_canonical.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), name="hg_other")))
    with pytest.raises(ValueError):
        spec.Cell("canonical.stream", BENCH, str(base))


ISOTROPIC = '''"""Isotropic scattering, K = 1; reads back its one complex parameter."""
import numpy as np


def kernel(params):
    if params["n"] != complex(1.7, 0.03):
        raise ValueError(f"n = {params['n']!r}")
    return np.ones_like
'''


@pytest.mark.parametrize("model", [None, "isotropic"])
def test_new_cell_is_files_only(tmp_path, model):
    """A throwaway configuration, traffic, cell and per-layer metric, added
    as new files and entries beside copies of the existing ones, load by
    their names; no existing file changes.  With ``model``, the
    configuration's aerosol is a phase model of its own, a new file under
    ``reference/models/`` with a complex parameter, and the check's
    reference runs it at a tiny grid."""
    base = tmp_path / "sosbench"
    shutil.copytree(BENCH_DIR, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: open(os.path.join(base, p), "rb").read()
              for d in ("configs", "traffic", "workloads", "layer_metrics", "reference",
                        "reference/models")
              for p in [os.path.join(d, f) for f in os.listdir(base / d)]
              if os.path.isfile(os.path.join(base, p))}
    cfg = dict(spec.config("hg_canonical", str(base)), name="hg_small", grid={"nb_angles": 64, "nb_layers": 128})
    if model:
        (base / "reference" / "models" / f"{model}.py").write_text(ISOTROPIC)
        cfg.update(grid={"nb_angles": 8, "nb_layers": 16}, aer=[model, {"n": {"re": 1.7, "im": 0.03}}])
    (base / "configs" / "hg_small.json").write_text(json.dumps(cfg))
    tr = dict(spec.traffic("closed_b256", str(base)), batch=64)
    (base / "traffic" / "closed_b64.json").write_text(json.dumps(tr))
    wl = spec.workload("canonical.stream", str(base))
    (base / "workloads" / "small.stream.json").write_text(json.dumps(wl))
    (base / "layer_metrics" / "calls_traced.py").write_text(
        'UNIT = "calls"\n\n\ndef read(run):\n    return len(run.records) or None\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "hg_small", "source": "test", "file": "x", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small.stream", "config": "hg_small", "traffic": "closed_b64",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "columns_per_s",
                               "workloads": ["small.stream"]})
    cell = spec.Cell("small.stream", bench, str(base))
    assert cell.traffic["batch"] == 64
    if model:
        import torch

        assert cell.config["aer"][1]["n"] == complex(1.7, 0.03)
        rng = np.random.default_rng(5)
        scenes = traffic_gen.scenes(cell.config, cell.traffic, rng, 4)
        ref = check.reference(cell.config, scenes, scenes["mu0"], torch.device("cpu"),
                              base=cell.base)
        for k in check.ROWS:
            assert ref[k].shape == (4, 16) and np.isfinite(ref[k]).all() and np.abs(ref[k]).max() > 0
    else:
        assert cell.config["grid"]["nb_angles"] == 64
    assert "calls_traced" in [m["name"] for m in cell.per_layer]
    assert spec.layer_metric("calls_traced", str(base)).UNIT == "calls"
    after = {p: open(os.path.join(base, p), "rb").read() for p in before}
    assert after == before


def test_unknown_phase_model_names_the_directory():
    with pytest.raises(ValueError, match=r"no phase model 'nosuch'.*reference/models.*hg\.py"):
        spec.phase_model("nosuch")
    cfg = dict(spec.config("hg_canonical"), grid={"nb_angles": 8, "nb_layers": 16}, aer=["nosuch", {}])
    with pytest.raises(ValueError, match="reference/models"):
        check.reference(cfg, traffic_gen.scenes(cfg, {}, None, 2), [0.5, 0.5], "cpu")


def test_complex_parameter_round_trips(tmp_path):
    """``{"re", "im"}`` objects in a configuration file load as Python
    complex numbers wherever they sit; other objects stay as they are."""
    (tmp_path / "configs").mkdir()
    n = complex(1.7, 0.03)
    data = {"name": "c", "aer": ["lognormal", {"indx": {"re": n.real, "im": n.imag},
                                               "list": [{"re": 0, "im": -1.5}],
                                               "other": {"re": 1.0, "im": 2.0, "x": 3}}]}
    (tmp_path / "configs" / "c.json").write_text(json.dumps(data))
    params = spec.config("c", str(tmp_path))["aer"][1]
    assert type(params["indx"]) is complex and params["indx"] == n
    assert params["list"] == [complex(0, -1.5)]
    assert params["other"] == {"re": 1.0, "im": 2.0, "x": 3}
    for name in ("hg_canonical", "fwc_sweep"):
        assert spec.config(name) == spec.read_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))
