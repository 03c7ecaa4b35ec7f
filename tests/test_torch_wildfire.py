"""The wildfire deployment (``sosbench/configs/wildfire_specular.json``):
log-normal Mie smoke, n = 1.7 + 0.03j, over a specular surface.

- The benchmark's plain Mie series (``sosbench/reference/models/
  lognormal.py``): Bohren & Huffman's published BHMIE example, the
  Rayleigh limit, and ∫ i dΩ = Qsca/Qext (by Gauss–Legendre quadrature,
  exact for the polynomial |S1|² + |S2|²).
- Its log-normal tables against the port's (``build_phase_tables``) at 16
  angles, rtol 1e-10: the two are float64 series of the same recurrences,
  in another summation order.
- The port's float64 ``solve_batch`` on the mega and reference engines
  against the benchmark's frozen reference on the configuration at two
  small grids: equal order counts and flags, rows within rtol 1e-9.
- The configuration is the port's ``wildfire`` preset as it is run.
- The benchmark's cells at a test size on the CPU: ``fwc.solve``'s sound
  run is correct and a stale one is not; ``wildfire.stream``'s is correct.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import sos_rt_tpu_torch.parallel as par  # noqa: E402
from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions  # noqa: E402
from sos_rt_tpu_torch.models import build_phase_tables  # noqa: E402
from sos_rt_tpu_torch.presets import get_preset  # noqa: E402
from sos_rt_tpu_torch.solver import PhaseTables  # noqa: E402
from sosbench import check, spec, traffic_gen  # noqa: E402
from sosbench.reference import grid as ref_grid  # noqa: E402
from sosbench.reference import phase  # noqa: E402
from sosbench.reference.models import lognormal  # noqa: E402
from sosbench.tests.helpers import small_cell  # noqa: E402

CONFIG = spec.config("wildfire_specular")
M_SMOKE = CONFIG["aer"][1]["indx"]
GRIDS = [{"nb_angles": 16, "nb_layers": 32}, {"nb_angles": 24, "nb_layers": 40}]


def test_bhmie_published_example():
    """BH appendix A: m = 1.55, radius 0.525 µm at λ = 0.6328 µm
    (x = 5.2128): Qext = Qsca = 3.10543, Qback = 2.92534."""
    qext, qsca, qback = lognormal.efficiencies(1.55, 2.0 * np.pi * 0.525 / 0.6328)
    assert abs(qext - 3.10543) < 1e-4 and abs(qsca - 3.10543) < 1e-4
    assert abs(qback - 2.92534) < 1e-4


def test_rayleigh_limit():
    x = 1e-3
    _, qsca, _ = lognormal.efficiencies(M_SMOKE, x)
    want = 8.0 / 3.0 * x ** 4 * abs((M_SMOKE ** 2 - 1) / (M_SMOKE ** 2 + 2)) ** 2
    assert qsca == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("x", [0.3, 3.0, 30.0])
def test_intensity_integrates_to_the_albedo(x):
    """∫ i dΩ = 2π ∫ i dµ = Qsca/Qext, and < 1: Im m > 0 absorbs."""
    mu, w = np.polynomial.legendre.leggauss(lognormal.n_stop(x) + 2)
    i, qsca = lognormal.intensity(M_SMOKE, x, mu)
    qext, _, _ = lognormal.efficiencies(M_SMOKE, x)
    assert 2.0 * np.pi * np.dot(w, i) == pytest.approx(qsca / qext, rel=1e-10)
    assert qsca < qext


def test_tables_are_the_ports():
    mu = ref_grid.mu_grid(16)
    p0, p = phase.tables(CONFIG["aer"], mu, [0.37])
    q0, q = build_phase_tables(CONFIG["aer"][0], mu, 0.37, cache=False, **CONFIG["aer"][1])
    np.testing.assert_allclose(p0[0], q0, rtol=1e-10)
    np.testing.assert_allclose(p, q, rtol=1e-10)


def test_configuration_is_the_preset():
    """The preset, but float32 bf16x3 and the three keys the traffic draws."""
    p = get_preset("wildfire")
    assert CONFIG["grid"] == {"nb_angles": p.grid.nb_angles, "nb_layers": p.grid.nb_layers}
    assert tuple(CONFIG["atm"]) == p.atm and tuple(CONFIG["aer"]) == p.aer
    assert CONFIG["surface"] == p.opts.surface == "specular"
    assert (CONFIG["dtype"], CONFIG["mm"]) == ("float32", "bf16x3")
    assert CONFIG["tol"] == p.opts.tol and CONFIG["max_orders"] == p.opts.max_orders
    drawn = set(spec.traffic("closed_b256_wildfire")["draws"])
    assert drawn == {"grd_alb", "tau_star_aer", "alb_aer"}
    for k, v in CONFIG["scene"].items():
        if k not in drawn:
            assert getattr(p.scene, k) == v, k


@pytest.fixture(scope="module", params=GRIDS, ids=["16x32", "24x40"])
def case(request):
    """(configuration at the grid, scenes, the reference's summary, the
    port's float64 tables): each grid's Mie tables built once."""
    cfg = dict(CONFIG, grid=request.param)
    scenes = traffic_gen.scenes(cfg, spec.traffic("closed_b256_wildfire"),
                                np.random.default_rng(21), 6)
    ref = check.reference(cfg, scenes, scenes["mu0"], torch.device("cpu"))
    tables = PhaseTables.from_models(GridSpec(**cfg["grid"]), float(cfg["scene"]["mu0"]),
                                     atm=tuple(cfg["atm"]), aer=tuple(cfg["aer"]),
                                     device="cpu", cache=False)
    return cfg, scenes, ref, tables


@pytest.mark.parametrize("engine", ["mega", "reference"])
def test_reference_is_the_ports_float64_specular_solve(case, engine):
    cfg, scenes, ref, tables = case
    opts = SolverOptions(surface="specular", dtype="float64", tol=cfg["tol"],
                         max_orders=cfg["max_orders"])
    sc = Scene(**{k: torch.as_tensor(v) for k, v in scenes.items()})
    sol = par.solve_batch(sc, tables, GridSpec(**cfg["grid"]), opts, engine=engine,
                          outputs="summary" if engine == "mega" else "full", device="cpu")
    rows = ((sol.i_toa, sol.i_surface) if engine == "mega"
            else (sol.i_total[:, 0], sol.i_total[:, -1]))
    np.testing.assert_array_equal(sol.n_orders.numpy(), ref["n_orders"])
    np.testing.assert_array_equal(sol.converged.numpy(), ref["converged"])
    assert ref["n_orders"].max() > 2
    for got, k in zip(rows, check.ROWS):
        scale = np.abs(ref[k]).max()
        np.testing.assert_allclose(got.numpy(), ref[k], rtol=1e-9, atol=1e-11 * scale)


@pytest.fixture
def bench_run(monkeypatch, tmp_path):
    """``sosbench.run``, whose import points the phase-table cache into the
    checkout: here into ``tmp_path``, and back once the test ends."""
    monkeypatch.setenv("SOS_RT_CACHE_DIR", str(tmp_path / "phase_tables"))
    from sosbench import run
    return run


def stale(solve):
    """Every call after the first answers with the first call's result."""
    first = []

    def f(*a, **kw):
        out = solve(*a, **kw)
        if not first:
            first.append(out)
        return dataclasses.replace(out, **{k: getattr(first[0], k) for k in
                                           ("i_toa", "i_surface", "n_orders", "converged")})
    return f


@pytest.mark.parametrize("fault", [None, stale], ids=["sound", "unchanged"])
def test_solve_chunk_cell(tmp_path, monkeypatch, bench_run, fault):
    """``fwc.solve`` cut to 16×32 and calls of 64 columns: the check's
    columns come from the reservoir of kept calls and their re-made
    scenes."""
    if fault:
        monkeypatch.setattr(par, "solve_batch", fault(par.solve_batch))
    cell = small_cell(tmp_path, "fwc.solve", batch=64, columns=64)
    res = bench_run.execute(cell, 2 ** 31 + 21, 0.5, False, torch.device("cpu"))
    assert res["attempted"] >= 1
    assert res["correct"] is (fault is None), res["check"]


def test_wildfire_cell_is_correct(tmp_path, bench_run):
    """``wildfire.stream`` cut to 16×32 and calls of 8 columns, through the
    benchmark's ``solve_batch`` entry, against the Mie reference."""
    cell = small_cell(tmp_path, "wildfire.stream")
    res = bench_run.execute(cell, 2 ** 31 + 22, 0.5, False, torch.device("cpu"))
    assert res["attempted"] >= 1 and res["correct"] is True, res["check"]


def fake_run(cfg, orders, quad_mma=5, counted=5, seconds=1.0):
    from types import SimpleNamespace

    return SimpleNamespace(config=cfg, orders=lambda: orders, records=[{"n_orders": orders}],
                           kernel_calls=lambda name: quad_mma,
                           counter_sum=lambda names: counted,
                           kernel_s=lambda name, span=None: 0.0 if span else seconds)


def test_specular_roofline_counts_no_i1_product():
    """The source products of every further order alone: the Lambertian
    count less I₁'s product and its field, against one second of
    ``quad_mma``."""
    from sosbench import roofline
    from sosbench.card import HBM_BYTES_PER_S, PEAK_OPS

    orders = np.random.default_rng(3).integers(2, 30, 256)
    L, w = CONFIG["grid"]["nb_layers"], CONFIG["grid"]["nb_angles"]
    got = spec.layer_metric("products_roofline_pct.specular").read(fake_run(CONFIG, orders))
    flops = roofline.source_flops(orders, L, w, 3)
    nbytes = 2 * L * 2 * w * 4 * int((orders - 1).sum())
    assert got == pytest.approx(100.0 * max(flops / PEAK_OPS["bf16"], nbytes / HBM_BYTES_PER_S))
    with_i1, _ = roofline.stream_products(orders, L, w, "bf16x3")
    assert got < 100.0 * with_i1
    with pytest.raises(RuntimeError, match="quad_mma"):
        spec.layer_metric("products_roofline_pct.specular").read(fake_run(CONFIG, orders, 4, 5))
    assert spec.layer_metric("products_roofline_pct.specular").read(
        fake_run(CONFIG, orders, 0, 0)) is None


def test_solve_roofline_is_the_sweeps():
    cfg = spec.config("fwc_sweep")
    orders = np.random.default_rng(4).integers(2, 30, 4096)
    run_ = fake_run(cfg, orders, 2, 2)
    got = spec.layer_metric("mega_roofline_pct.solve").read(run_)
    assert got == spec.layer_metric("mega_roofline_pct.sweep").read(run_) > 0
