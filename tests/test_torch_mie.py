"""The port's Mie models against the JAX package's (CPU, float64).

``sos_rt_tpu_torch.models.miecore`` (the Bohren–Huffman series, native
core or NumPy) against ``sos_rt_tpu.models.miecore`` at the (m, x) of
tests/test_mie.py, rtol 1e-12: both compute the same series with the same
operations, on the same C++ source or the same NumPy code.  The physical
identities of tests/test_mie.py are held on the port's core, native
against NumPy too, and the ``mie`` / ``lognormal`` tables (the ``eva`` and
``wildfire`` presets' parameters) against JAX's ``build_phase_tables`` at
56 angles, rtol 1e-12.
"""
import numpy as np
import pytest

from sos_rt_tpu.config import GridSpec as JGrid
from sos_rt_tpu.models import build_phase_tables as j_build
from sos_rt_tpu.models import miecore as j_mie
from sos_rt_tpu_torch.models import _native, build_phase_tables, miecore
from sos_rt_tpu_torch.presets import get_preset

CASES = [(1.5 + 0j, 5.0), (1.44 + 0j, 11.4), (1.7 - 0.03j, 0.9),
         (1.33 + 0j, 2.0), (1.5 - 0.1j, 3.0), (1.7 + 0.03j, 7.3)]
MU = np.linspace(-1.0, 1.0, 101)
RTOL = 1e-12


@pytest.fixture
def numpy_core(monkeypatch):
    """The NumPy series in both packages (SOS_RT_NO_NATIVE), restored
    afterwards."""
    from sos_rt_tpu.models import _native as j_native

    monkeypatch.setenv("SOS_RT_NO_NATIVE", "1")
    for mod in (_native, j_native):
        monkeypatch.setattr(mod, "_TRIED", False)
        monkeypatch.setattr(mod, "_LIB", None)
    yield
    for mod in (_native, j_native):
        monkeypatch.setattr(mod, "_TRIED", False)
        monkeypatch.setattr(mod, "_LIB", None)


def _core_matches_jax(m, x):
    a, b = miecore.mie_ab(m, x)
    ja, jb = j_mie.mie_ab(m, x)
    np.testing.assert_allclose(a, ja, rtol=RTOL)
    np.testing.assert_allclose(b, jb, rtol=RTOL)
    s1, s2 = miecore.s1_s2(m, x, MU)
    j1, j2 = j_mie.s1_s2(m, x, MU)
    np.testing.assert_allclose(s1, j1, rtol=RTOL)
    np.testing.assert_allclose(s2, j2, rtol=RTOL)
    np.testing.assert_allclose(miecore.efficiencies_single(m, x),
                               j_mie.efficiencies_single(m, x), rtol=RTOL)
    np.testing.assert_allclose(miecore.i_unpolarized(m, x, MU),
                               j_mie.i_unpolarized(m, x, MU), rtol=RTOL)


@pytest.mark.parametrize("m,x", CASES)
def test_core_matches_jax(m, x):
    _core_matches_jax(m, x)


@pytest.mark.parametrize("m,x", CASES[:3])
def test_numpy_core_matches_jax(m, x, numpy_core):
    assert _native.get_lib() is None
    _core_matches_jax(m, x)


def test_native_core_is_built():
    """g++ is here: the core builds into build/sos_rt_tpu_torch/ and loads."""
    assert _native.get_lib() is not None
    assert _native.lib_path().startswith(_native.BUILD_DIR)


def test_native_matches_numpy(monkeypatch):
    m, x = 1.7 + 0.03j, 7.3
    s1n, s2n = miecore.s1_s2(m, x, MU)
    qn = miecore.efficiencies_single(m, x)
    an, bn = miecore.mie_ab(m, x)
    monkeypatch.setenv("SOS_RT_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_TRIED", False)
    monkeypatch.setattr(_native, "_LIB", None)
    s1p, s2p = miecore.s1_s2(m, x, MU)
    qp = miecore.efficiencies_single(m, x)
    ap, bp = miecore.mie_ab(m, x)
    monkeypatch.setattr(_native, "_TRIED", False)
    monkeypatch.setattr(_native, "_LIB", None)
    for got, want in ((s1n, s1p), (s2n, s2p), (qn, qp), (an, ap), (bn, bp)):
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("m,x", [(1.5 + 0j, 5.0), (1.44 + 0j, 11.4),
                                 (1.7 - 0.03j, 0.9)])
def test_optical_theorem(m, x):
    qext, _, _, _ = miecore.efficiencies_single(m, x)
    s1, _ = miecore.s1_s2(m, x, [1.0])
    assert np.isclose(qext, 4.0 * s1[0].real / x**2, rtol=1e-12)


@pytest.mark.parametrize("m,x", [(1.5 + 0j, 5.0), (1.33 + 0j, 2.0)])
def test_qsca_angular_quadrature(m, x):
    _, qsca, _, _ = miecore.efficiencies_single(m, x)
    th = np.linspace(0, np.pi, 40001)
    s1, s2 = miecore.s1_s2(m, x, np.cos(th))
    q = np.trapezoid((np.abs(s1) ** 2 + np.abs(s2) ** 2) * np.sin(th), th) / x**2
    assert np.isclose(qsca, q, rtol=1e-6)


def test_albedo_normalization():
    """∫ i dΩ = Qsca/Qext (miepython's default normalization)."""
    m, x = 1.5 - 0.1j, 3.0
    qext, qsca, _, _ = miecore.efficiencies_single(m, x)
    th = np.linspace(0, np.pi, 40001)
    total = 2 * np.pi * np.trapezoid(miecore.i_unpolarized(m, x, np.cos(th))
                                     * np.sin(th), th)
    assert np.isclose(total, qsca / qext, rtol=1e-6)


def test_rayleigh_limit():
    """x → 0 nonabsorbing sphere: i(µ) ∝ (1+µ²), Qsca ∝ x⁴."""
    m = 1.33 + 0j
    mu = np.linspace(-1, 1, 41)
    ratio = miecore.i_unpolarized(m, 0.01, mu) / (1.0 + mu**2)
    assert np.allclose(ratio, ratio[0], rtol=1e-3)
    _, qs1, _, _ = miecore.efficiencies_single(m, 0.01)
    _, qs2, _, _ = miecore.efficiencies_single(m, 0.02)
    assert np.isclose(qs2 / qs1, 16.0, rtol=1e-2)


def test_asymmetry_bounds_and_x_guard():
    for x in (0.5, 2.0, 10.0):
        _, _, _, g = miecore.efficiencies_single(1.44 + 0j, x)
        assert -1.0 < g < 1.0
    with pytest.raises(ValueError, match="x must be > 0"):
        miecore.mie_ab(1.5, 0.0)


TABLE_GRID = JGrid(nb_angles=56, nb_layers=16)


def _tables_match(kind, params):
    mu = TABLE_GRID.mu()
    got = build_phase_tables(kind, mu, 0.5, cache=False, **params)
    want = j_build(kind, mu, 0.5, cache=False, **params)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0.0)
    return got


@pytest.mark.parametrize("preset", ["eva", "wildfire"])
def test_lognormal_tables_match_jax(preset):
    kind, params = get_preset(preset).aer
    p0, p = _tables_match(kind, params)
    w = TABLE_GRID.trapz_weights()
    assert np.isclose(np.sum(p0 * w), 2.0, rtol=1e-12)    # ∫P0 dµ = 2
    np.testing.assert_allclose(p.T @ w, 4.0, rtol=1e-12)  # ∫P(:,n) dµ = 4


@pytest.mark.parametrize("params", [
    dict(indx=1.5 + 0j, r=0.1, lambda0=0.55),
    dict(indx=1.7 + 0.03j, r=0.3, lambda0=0.55),
])
def test_monodisperse_tables_match_jax(params):
    _tables_match("mie", params)


def test_lognormal_aliases_and_cache(tmp_path, monkeypatch):
    """'eva' resolves to 'lognormal'; a cached table is read back as built."""
    monkeypatch.setenv("SOS_RT_CACHE_DIR", str(tmp_path))
    _, params = get_preset("eva").aer
    mu = TABLE_GRID.mu()
    first = build_phase_tables("eva", mu, 0.5, **params)
    again = build_phase_tables("lognormal", mu, 0.5, **params)
    assert len(list(tmp_path.glob("lognormal_*.npz"))) == 1
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="requires parameters"):
        build_phase_tables("mie", mu, 0.5, cache=False, indx=1.5)
