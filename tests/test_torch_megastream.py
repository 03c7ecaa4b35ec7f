"""The port's streamed kernels module against the JAX streamed engine.

``sos_rt_tpu_torch.fused.solve_batch_mega`` (on the CPU: the plain
versions of passI / passA / passB) against
``sos_rt_tpu.fused.solve_batch_mega(stream=True, interpret=True)`` — the
Pallas kernels in interpreter mode — at GridSpec(56, 64), B=4, float64,
after one order (I₁ only: passI) and two orders (one passA + passB), for
both surfaces.  rtol 1e-12: the two run the same arithmetic, with the
products summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu.ops.sweeps import smooth_up_rows as j_smooth_up_rows
from sos_rt_tpu_torch.fused import solve_batch_mega
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.ops.megakernel import _smooth_up, ratio_rows_tile

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(56, 64)
CASES = [("lambertian", 1), ("lambertian", 2), ("specular", 2)]


@pytest.fixture(scope="module")
def tables():
    return jax_tables(GRID)


@pytest.fixture(scope="module", params=CASES, ids=[f"{s}-{n}" for s, n in CASES])
def pair(request, tables):
    surface, max_orders = request.param
    opts = JOpts(surface=surface, dtype="float64", max_orders=max_orders)
    scenes = jax_scenes(4)
    ref = j_solve_mega(scenes, tables, GRID, opts, cols_per_block=2,
                       interpret=True, stream=True, outputs="full")
    ms.reset_launches()
    got = solve_batch_mega(*port_inputs(scenes, tables, GRID, opts),
                           cols_per_block=2, outputs="full", device="cpu")
    return ref, got, max_orders


def test_stream_matches_jax_stream(pair):
    ref, got, max_orders = pair
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert int(got.n_orders.max()) == max_orders
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert got.i_total.shape == ref.i_total.shape
    assert_close_scaled(got.i_total.numpy(), ref.i_total, rtol=1e-12, atol_scale=1e-14)
    np.testing.assert_array_equal(got.tau.numpy(), np.asarray(ref.tau))


def test_cpu_runs_plain_versions_without_launches(pair):
    """On CPU tensors the wrappers take the plain versions: no kernel
    launch is counted."""
    assert [k.launches for k in ms.KERNELS] == [0, 0, 0]


def test_smooth_up_matches_reference_walk():
    """The tile smoothing walk against the reference engine's
    smooth_up_rows on rows with a sharp µ→0⁺ feature."""
    m = 64
    mu = JGrid(m, 8).mu()
    rng = np.random.default_rng(5)
    amp = rng.uniform(0.2, 2.0, (6, 1))
    width = rng.uniform(0.01, 0.05, (6, 1))
    up = amp * np.exp(-mu[m:][None, :] / width) + 0.01 * mu[m:][None, :]
    rows = np.concatenate([np.zeros_like(up), up], axis=1)
    want = np.asarray(j_smooth_up_rows(jnp.asarray(rows), jnp.asarray(mu), m))[:, m:]
    got = _smooth_up(torch.as_tensor(up), m, torch.as_tensor(mu[m:]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-16)
    assert not np.array_equal(want, up)           # the walk did blend rows


def test_ratio_rows_counts_zero_over_zero_and_pads_as_converged():
    real = torch.arange(8) < 6
    new = torch.ones((2, 8), dtype=torch.float64)
    tot = torch.full((2, 8), 4.0, dtype=torch.float64)
    tot[0, :] = 0.0                   # a degenerate column: 0/0 everywhere
    new[1, 7] = 1e6                   # a pad row is never read
    r = ratio_rows_tile(new, tot, 0.5 * new, tot, real)
    np.testing.assert_array_equal(r.numpy(), [0.0, 0.25])


@pytest.mark.parametrize("m", [56, 201])
def test_band_fix_taps_match_dense_stencil(m):
    """The tap-by-tap band fix against the TPU package's dense stencil
    products (megakernel.band_fix_tile on plain arrays), float64."""
    import functools

    from sos_rt_tpu.ops import megakernel as jmk
    from sos_rt_tpu.ops.sweeps import build_stencils as j_build_stencils
    from sos_rt_tpu_torch.config import GridSpec
    from sos_rt_tpu_torch.ops import megakernel as tmk
    from sos_rt_tpu_torch.ops.sweeps import build_stencils

    jg = JGrid(m, 8)
    jops = jmk.build_static_operators(jg, j_build_stencils(jg.mu(), m), "lambertian",
                                      jg.trapz_weights(), jnp.float64, "highest")
    mp = jmk.pad_angles(m)
    rng = np.random.default_rng(6)
    fv = rng.standard_normal((mp, 12))
    choice = np.arange(12) % 4
    zero = (np.arange(mp) > m - 1.5)[:, None]
    want = jmk.band_fix_tile(
        jnp.asarray(fv), jnp.asarray(choice[None, :], jnp.float64), jnp.asarray(zero),
        wall_hi=jops["wall"][0], wall_lo=jops["wall"][1], place_hi=jops["place"][0],
        place_lo=jops["place"][1], pvt_ref=jops["pvt"],
        dot3=functools.partial(jmk._dot3, mm="highest", dtype=jnp.float64),
        dtype=jnp.float64)
    tg = GridSpec(m, 8)
    stencils = build_stencils(tg.mu(), m)
    taps = tmk.stencil_taps(stencils, "highest", torch.float64)
    pvt = torch.as_tensor(tmk.band_validity(stencils, m))
    got = tmk.band_fix_tile(torch.as_tensor(fv.T), torch.as_tensor(choice),
                            torch.as_tensor(zero[:, 0]), taps=taps, pvt=pvt,
                            mm="highest", nb_angles=m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, rtol=1e-13, atol=1e-13)
    assert not np.allclose(got.numpy(), fv.T)          # some rows were replaced


@pytest.mark.parametrize("mm", ["highest", "bf16x3"])
@pytest.mark.parametrize("m", [53, 201])
def test_stencil_taps_rebuild_dense_wall(m, mm):
    """The taps the passB kernel and its plain version read, scattered back
    into a dense (4·SLOT, Mp) operator, equal the TPU package's ``wall``
    operator bit for bit, hi and lo parts alike."""
    from sos_rt_tpu.ops import megakernel as jmk
    from sos_rt_tpu.ops.sweeps import build_stencils as j_build_stencils
    from sos_rt_tpu_torch.config import GridSpec
    from sos_rt_tpu_torch.ops import megakernel as tmk
    from sos_rt_tpu_torch.ops.sweeps import build_stencils

    jg = JGrid(m, 8)
    jops = jmk.build_static_operators(jg, j_build_stencils(jg.mu(), m), "lambertian",
                                      jg.trapz_weights(), jnp.float32, mm)
    tg = GridSpec(m, 8)
    cols, hi, lo = tmk.stencil_taps(build_stencils(tg.mu(), m), mm, torch.float32)
    rows = torch.arange(cols.shape[0])[:, None].expand_as(cols)
    for part, want in ((hi, jops["wall"][0]), (lo, jops["wall"][1])):
        if mm == "highest" and part is lo:
            assert not lo.any()
            continue
        dense = torch.zeros((cols.shape[0], tmk.pad_angles(m)), dtype=torch.float32)
        dense.index_put_((rows.long(), cols.long()), part, accumulate=True)
        np.testing.assert_array_equal(dense.numpy(),
                                      np.asarray(want, np.float32))
