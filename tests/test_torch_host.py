"""The port's host-side modules against the JAX package, on the CPU.

Grids, τ profiles, stencils, phase tables, the bf16 splits, the source
and static operators and the in-kernel I₁ inputs of
``sos_rt_tpu_torch`` must equal their ``sos_rt_tpu`` counterparts (bit for
bit where the arithmetic is the same, to 1e-13 in float64 where the
products are summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu import grids as jgrids
from sos_rt_tpu.config import GridSpec as JGrid
from sos_rt_tpu.models import build_phase_tables as j_build_tables
from sos_rt_tpu.ops import first_order as jfo
from sos_rt_tpu.ops import megakernel as jmk
from sos_rt_tpu.ops import precision as jprec
from sos_rt_tpu.ops.source import source_operator as j_source_operator
from sos_rt_tpu.ops.sweeps import build_stencils as j_build_stencils
from sos_rt_tpu_torch import grids as tgrids
from sos_rt_tpu_torch.config import GridSpec
from sos_rt_tpu_torch.models import build_phase_tables as t_build_tables
from sos_rt_tpu_torch.ops import first_order as tfo
from sos_rt_tpu_torch.ops import megakernel as tmk
from sos_rt_tpu_torch.ops import precision as tprec
from sos_rt_tpu_torch.ops.source import source_operator as t_source_operator
from sos_rt_tpu_torch.ops.sweeps import build_stencils as t_build_stencils

from torch_cases import jax_tables


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("spacing", ["uniform", "gauss"])
@pytest.mark.parametrize("m", [8, 53, 64])
def test_grid_mu_and_weights(spacing, m):
    j, t = JGrid(m, 16, spacing), GridSpec(m, 16, spacing)
    np.testing.assert_array_equal(t.mu(), j.mu())
    np.testing.assert_array_equal(t.trapz_weights(), j.trapz_weights())


def test_grid_validation():
    with pytest.raises(ValueError):
        GridSpec(4, 16)
    with pytest.raises(ValueError):
        GridSpec(16, 16, "chebyshev")


def test_tau_profile_bitwise():
    rng = np.random.default_rng(0)
    n = 16
    args = [rng.uniform(0.05, 0.5, n), rng.uniform(0.0, 0.6, n),
            np.full(n, 120.0), rng.uniform(18.0, 40.0, n), rng.uniform(2.0, 17.0, n)]
    args[2][3] = 100.0      # one column with another top altitude
    L = 97
    j_tau, j_iu, j_id = jax.vmap(
        lambda a, b, c, d, e: jgrids.tau_profile(a, b, c, d, e, L))(
        *[jnp.asarray(a) for a in args])
    t_tau, t_iu, t_id = tgrids.tau_profile(*[torch.as_tensor(a) for a in args], L)
    np.testing.assert_array_equal(_np(t_tau), np.asarray(j_tau))
    np.testing.assert_array_equal(_np(t_iu), np.asarray(j_iu))
    np.testing.assert_array_equal(_np(t_id), np.asarray(j_id))
    for k in range(n):
        tau_np, iu, idn = tgrids.tau_profile_np(*[a[k] for a in args], L)
        ref = jgrids.tau_profile_np(*[a[k] for a in args], L)
        np.testing.assert_array_equal(tau_np, ref[0])
        assert (iu, idn) == ref[1:]


def test_layer_indices_ties_take_first():
    # z grid 0, 10, 20 (L=3, z0=20): z_up = 15 is equidistant from 20 and 10
    iu, idn = tgrids.layer_indices(torch.tensor(20.0, dtype=torch.float64),
                                   15.0, 5.0, 3)
    j_iu, j_idn = jgrids.layer_indices(20.0, 15.0, 5.0, 3)
    assert (int(iu), int(idn)) == (int(j_iu), int(j_idn)) == (0, 1)


@pytest.mark.parametrize("m", [8, 56, 64, 201, 501])
def test_build_stencils_equal(m):
    mu = JGrid(m, 16).mu()
    j, t = j_build_stencils(mu, m), t_build_stencils(mu, m)
    assert (t.nb_angles, t.band_max, t.bands) == (j.nb_angles, j.band_max, j.bands)
    for f in ("poly_w", "poly_src", "poly_mask", "small_cols", "taylor_mask"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


@pytest.mark.parametrize("kind,params", [("iso", {}), ("rayleigh", {}),
                                         ("hg", {"g": 0.7}), ("fwc", {})])
def test_phase_tables_equal(kind, params):
    mu = JGrid(24, 16).mu()
    jp0, jp = j_build_tables(kind, mu, 0.6, cache=False, **params)
    tp0, tp = t_build_tables(kind, mu, 0.6, cache=False, **params)
    np.testing.assert_array_equal(tp0, jp0)
    np.testing.assert_array_equal(tp, jp)


def test_phase_tables_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("SOS_RT_CACHE_DIR", str(tmp_path))
    mu = GridSpec(16, 8).mu()
    first = t_build_tables("hg", mu, 0.5, g=0.3)
    second = t_build_tables("hg", mu, 0.5, g=0.3)
    assert len(list(tmp_path.iterdir())) == 1
    np.testing.assert_array_equal(first[1], second[1])


def _bf16_cases():
    """float32 values including exact bf16 ties (low 16 bits 0x8000),
    negatives, zeros and values just off a tie."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0x30000000, 0x50000000, 512, dtype=np.uint32)
    bits[:128] = (bits[:128] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    bits[128:160] = (bits[128:160] & np.uint32(0xFFFF0000)) | np.uint32(0x7FFF)
    bits[160:192] = (bits[160:192] & np.uint32(0xFFFF0000)) | np.uint32(0x8001)
    bits[::3] |= np.uint32(0x80000000)
    x = bits.view(np.float32).copy()
    x[-4:] = [0.0, -0.0, 1.0, -3.5]
    return x


def test_split_bf16_bit_equal():
    x = _bf16_cases()
    j = jprec.split_bf16(jnp.asarray(x))
    t = tprec.split_bf16(torch.as_tensor(x))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))
    # ties round away from zero: the hi part differs from round-half-even
    hi_even = torch.as_tensor(x).to(torch.bfloat16)
    assert not torch.equal(t[0].view(torch.int16), hi_even.view(torch.int16))


def test_split_bf16_3_bit_equal():
    x = _bf16_cases()
    j = jprec.split_bf16_3(jnp.asarray(x))
    t = tprec.split_bf16_3(torch.as_tensor(x))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))
    total = sum(p.to(torch.float64) for p in t)
    np.testing.assert_array_equal(total.numpy(), x.astype(np.float64))


@pytest.mark.parametrize("mm", ["bf16x3", "bf16x5"])
def test_make_split_dot(mm):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((40, 24)).astype(np.float32)
    x = rng.standard_normal((7, 40)).astype(np.float32)
    j = jprec.make_split_dot(jnp.asarray(a), mm, jnp.float32)(jnp.asarray(x))
    t = tprec.make_split_dot(torch.as_tensor(a), mm, torch.float32)(torch.as_tensor(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
@pytest.mark.parametrize("mm", ["highest", "bf16x3"])
def test_static_and_source_operators_padded(surface, mm):
    m = 53                                         # pads to 56
    jg, tg = JGrid(m, 16), GridSpec(m, 16)
    w_mu = jg.trapz_weights()
    dtype_j = jnp.float64 if mm == "highest" else jnp.float32
    dtype_t = torch.float64 if mm == "highest" else torch.float32
    jops = jmk.build_static_operators(jg, j_build_stencils(jg.mu(), m), surface,
                                      w_mu, dtype_j, mm)
    tops = tmk.build_static_operators(tg, t_build_stencils(tg.mu(), m), surface,
                                      w_mu, dtype_t, mm)
    for k in ("wall", "place", "bcmat"):
        for a, b in zip(tops[k], jops[k]):
            np.testing.assert_array_equal(_np(a.to(torch.float64)),
                                          np.asarray(b, np.float64))
    for k in ("pvt", "colc"):
        np.testing.assert_array_equal(_np(tops[k]), np.asarray(jops[k]))

    tables = jax_tables(jg)
    wj = jnp.asarray(w_mu, dtype_j)
    wt = torch.as_tensor(w_mu, dtype=dtype_t)
    aj = [j_source_operator(jnp.asarray(p, dtype_j), wj) for p in (tables.p_atm, tables.p_aer)]
    at = [t_source_operator(torch.as_tensor(np.array(p), dtype=dtype_t), wt)
          for p in (tables.p_atm, tables.p_aer)]
    for a, b in zip(at, aj):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    wsj = jmk.stack_source_operator(*aj, m, mm, dtype_j)
    wst = tmk.stack_source_operator(*at, m, mm, dtype_t)
    assert tuple(wst[0].shape) == tuple(wsj[0].shape) == (4 * 56, 2 * 56)
    for a, b in zip(wst, wsj):
        np.testing.assert_array_equal(_np(a.to(torch.float64)), np.asarray(b, np.float64))


@pytest.mark.parametrize("surface", ["lambertian", "specular"])
def test_first_order_mega_inputs(surface):
    jg = JGrid(53, 40)
    tables = jax_tables(jg, mu0=0.6)
    B, L, M = 5, jg.nb_layers, jg.nb_angles
    rng = np.random.default_rng(3)
    ta, tr = np.full(B, 0.104), rng.uniform(0.02, 0.4, B)
    z0, zu, zd = np.full(B, 120.0), np.full(B, 25.0), rng.uniform(10.0, 17.0, B)
    tau, iu, idn = jax.vmap(lambda *a: jgrids.tau_profile(*a, L))(
        *[jnp.asarray(a) for a in (ta, tr, z0, zu, zd)])
    mu0 = np.full(B, 0.6)
    # one column at the µ0 resonance |µ + µ0| < 1e-4 of a grid node
    mu0[2] = -float(jg.mu()[10]) + 5e-5
    rho, aa, ar = rng.uniform(0, 0.8, B), np.ones(B), rng.uniform(0.7, 1.0, B)
    w_atm, w_aer = rng.uniform(0.1, 0.9, B), rng.uniform(0.1, 0.9, B)
    w_mu = jg.trapz_weights()
    p = [np.asarray(x) for x in (tables.p0_atm, tables.p_atm, tables.p0_aer, tables.p_aer)]
    j = jfo.first_order_mega_inputs(
        surface, tau, jg.mu(), M, jnp.asarray(mu0), jnp.asarray(rho),
        jnp.asarray(aa), jnp.asarray(ar), *[jnp.asarray(x) for x in p],
        iu, idn, jnp.asarray(w_atm), jnp.asarray(w_aer), w_mu, jnp.float64)
    T = lambda x: torch.as_tensor(np.array(x))
    t = tfo.first_order_mega_inputs(
        surface, T(tau), jg.mu(), M, T(mu0), T(rho), T(aa), T(ar),
        *[T(x) for x in p], T(iu), T(idn), T(w_atm), T(w_aer), w_mu, torch.float64)
    assert set(t[0]) == set(j[0])
    for k in j[0]:
        np.testing.assert_allclose(_np(t[0][k]), np.asarray(j[0][k]), rtol=1e-13, atol=1e-15)
    for a, b in zip(t[1:4], j[1:4]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-13,
                                   atol=1e-13 * float(np.max(np.abs(np.asarray(b))) or 1.0))
    if surface == "lambertian":
        np.testing.assert_allclose(_np(t[4]), np.asarray(j[4]), rtol=1e-13, atol=1e-15)
    else:
        assert t[4] is None and j[4] is None
