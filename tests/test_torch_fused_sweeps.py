"""The fused engine's sweep module against the JAX package's Pallas kernels.

``sos_rt_tpu_torch.ops.fused_sweeps`` holds the plain PyTorch versions of
the two sweep kernels; here they meet ``down_sweep_pallas`` and
``up_sweep_smooth_pallas`` in interpreter mode on the same numpy inputs,
float64, rtol 1e-12 (both do the same operations in the same order; only
``exp`` and a reduction's order may differ in the last bit).  The source is
the Jₙ of a real second order, smooth in µ (white noise would make every
smoothing walk run to its end and test nothing), and a synthetic batch
whose walk stops at the first lane, in the middle and never.  Also:
``build_pack`` equal to the JAX one exactly, and the band functions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.ops import pallas_sweeps as jps
from sos_rt_tpu.ops import sweeps as jsw
from sos_rt_tpu_torch.fused import FusedBatch
from sos_rt_tpu_torch.ops import fused_sweeps as fs
from sos_rt_tpu_torch.ops import sweeps as sw

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs
from torch_sweep_cases import down_inputs

# name → (grid, surface); L is a multiple of 8, as the Pallas kernels need
CASES = {"uniform_lambertian": (JGrid(51, 32), "lambertian"),
         "gauss_specular": (JGrid(51, 24, spacing="gauss"), "specular")}


@pytest.fixture(scope="module", params=list(CASES))
def order2(request):
    """A fused batch of the port and the Jₙ of its second order."""
    grid, surface = CASES[request.param]
    opts = JOpts(surface=surface, dtype="float64")
    scenes, tables, pgrid, popts = port_inputs(jax_scenes(3), jax_tables(grid), grid, opts)
    fb = FusedBatch(scenes, tables, pgrid, popts, torch.device("cpu"))
    m = grid.nb_angles
    return fb, fb.source(fb.i1[:, :, :m], fb.i1[:, :, m:]), m


def _j(x):
    return jnp.asarray(x.numpy())


def test_build_pack_equals_jax(order2):
    fb, _, _ = order2
    pack, cpar = jps.build_pack(_j(fb.tau), _j(fb.idx_up), _j(fb.idx_down), jnp.float64)
    np.testing.assert_array_equal(fb.pack.numpy(), np.asarray(pack))
    np.testing.assert_array_equal(fb.cparams.numpy(), np.asarray(cpar))
    assert fb.pack.shape == (3, fb.L, fs.PK_W) and fb.cparams.shape == (3, 8)
    lanes = (fs.PK_TAU, fs.PK_DROP, fs.PK_CH1, fs.PK_CH2, fs.PK_R1, fs.PK_R2,
             fs.PK_HDT_DN, fs.PK_HDT_UP)
    assert lanes == (jps.PK_TAU, jps.PK_DROP, jps.PK_CH1, jps.PK_CH2, jps.PK_R1,
                     jps.PK_R2, jps.PK_HDT_DN, jps.PK_HDT_UP)
    p32, c32 = fs.build_pack(fb.tau.float(), fb.idx_up, fb.idx_down, torch.float32)
    j32 = jps.build_pack(_j(fb.tau.float()), _j(fb.idx_up), _j(fb.idx_down), jnp.float32)
    np.testing.assert_array_equal(p32.numpy(), np.asarray(j32[0]))
    np.testing.assert_array_equal(c32.numpy(), np.asarray(j32[1]))


def test_down_sweep_plain_matches_pallas_interpret(order2):
    fb, jn, m = order2
    got = fs.down_sweep_plain(jn[:, :, :m], fb.pack, fb.mu_down_safe)
    want = jps.down_sweep_pallas(_j(jn[:, :, :m]), _j(fb.pack), _j(fb.mu_down_safe),
                                 block_b=3, interpret=True)
    assert np.isfinite(np.asarray(want)).all()
    assert_close_scaled(got.numpy(), want, rtol=1e-12, atol_scale=1e-14)


# (B, L, M) edge shapes of the down sweep: one column, odd M, one layer and
# layer counts below and off the kernel's 32-layer ring; the Pallas kernel
# takes L a multiple of 8 only, a float64 numpy loop the rest
DOWN_PALLAS_EDGES = [(1, 8, 51), (2, 16, 33), (1, 40, 1)]
DOWN_LOOP_EDGES = [(1, 1, 51), (1, 9, 33), (2, 30, 51), (3, 1, 1)]


def _down_loop(jn, pack, mu):
    """The downward recurrence written out in float64 numpy, one layer at a
    time over every (column, angle)."""
    B, L, M = jn.shape
    s = np.zeros((B, M))
    j_prev = np.zeros((B, M))
    out = np.empty((B, L, M))
    for t in range(L):
        w = pack[:, t, fs.PK_HDT_DN][:, None]
        a = np.exp(2.0 * w / mu[None, :])
        s = a * s + w * (j_prev * a + jn[:, t])
        j_prev = jn[:, t]
        out[:, t] = -s / mu[None, :]
    return out


def _down_edge_inputs(shape):
    return down_inputs(*shape, torch.float64, torch.device("cpu"))


@pytest.mark.parametrize("shape", DOWN_PALLAS_EDGES, ids=lambda s: "x".join(map(str, s)))
def test_down_sweep_plain_at_edge_shapes_matches_pallas_interpret(shape):
    jn, pack, mu = _down_edge_inputs(shape)
    got = fs.down_sweep_plain(jn, pack, mu)
    want = jps.down_sweep_pallas(_j(jn), _j(pack), _j(mu), block_b=shape[0], interpret=True)
    assert np.isfinite(np.asarray(want)).all()
    assert_close_scaled(got.numpy(), want, rtol=1e-12, atol_scale=1e-14)


@pytest.mark.parametrize("shape", DOWN_LOOP_EDGES, ids=lambda s: "x".join(map(str, s)))
def test_down_sweep_plain_at_edge_shapes_matches_a_numpy_loop(shape):
    jn, pack, mu = _down_edge_inputs(shape)
    got = fs.down_sweep_plain(jn, pack, mu)
    assert got.shape == shape and bool(torch.isfinite(got).all())
    assert_close_scaled(got.numpy(), _down_loop(jn.numpy(), pack.numpy(), mu.numpy()),
                        rtol=1e-12, atol_scale=1e-14)
    # the strided half-view and its contiguous copy give the same bits
    assert torch.equal(fs.down_sweep_plain(jn.contiguous(), pack, mu), got)


def test_up_sweep_plain_matches_pallas_interpret(order2):
    fb, jn, m = order2
    dn = fb.narrow_down_fixes(fs.down_sweep_plain(jn[:, :, :m], fb.pack,
                                                  fb.mu_down_safe), jn)
    bc = fb.surface_bc(dn)
    args = (jn[:, :, m:], fb.pack, fb.cparams, fb.mu_up_row, bc)
    got = fs.up_sweep_smooth_plain(*args)
    want = jps.up_sweep_smooth_pallas(*(_j(a) for a in args), block_b=3, interpret=True)
    assert np.isfinite(np.asarray(want)).all()
    assert_close_scaled(got.numpy(), want, rtol=1e-12, atol_scale=1e-14)


def _walk_rows(m):
    """Three rows over lanes 0..m-1 whose walk stops at lane 1 (a straight
    line), at lane m // 2 (a parabola that turns into a line there) and
    never (an alternating row)."""
    k = np.arange(m, dtype=np.float64)
    line = 0.3 + 0.01 * k
    mid = m // 2
    bent = np.where(k < mid, 0.3 + 0.01 * k + 0.002 * (k - mid) ** 2, 0.3 + 0.01 * k)
    saw = 0.3 + 0.05 * (-1.0) ** k
    return np.stack([line, bent, saw]), (2, mid + 1, m - 2)


def test_smoothing_walk_stops_early_in_the_middle_and_never():
    m = 24
    rows, idx = _walk_rows(m)
    mu_row = np.concatenate([[0.0], np.linspace(0.0, 1.0, m)[1:]])
    got = fs.smooth_rows(torch.as_tensor(rows), torch.as_tensor(mu_row))
    want = jps._smooth_rows(jnp.asarray(rows), jnp.asarray(mu_row)[None, :], m)
    assert_close_scaled(got.numpy(), want, rtol=1e-13, atol_scale=1e-15)
    for r, i in enumerate(idx):
        # lanes from the blend endpoint on are untouched, lanes 1..idx-1 blended
        np.testing.assert_array_equal(got.numpy()[r, i:], rows[r, i:])
        w = mu_row[1:i] / mu_row[i]
        np.testing.assert_allclose(got.numpy()[r, 1:i],
                                   (1 - w) * rows[r, 0] + w * rows[r, i], rtol=1e-14)
    assert not np.allclose(got.numpy()[1, 1:idx[1]], rows[1, 1:idx[1]])


def test_up_sweep_on_rows_with_known_walks():
    """The three walks through the whole up sweep: with a constant τ every
    layer step is the identity, so each layer's raw row is the BC row."""
    m, L, B = 24, 16, 3
    rows, _ = _walk_rows(m)
    mu_row = torch.as_tensor(np.concatenate([[0.0], np.linspace(0.0, 1.0, m)[1:]]))
    tau = torch.zeros((B, L), dtype=torch.float64)
    idx_up = torch.tensor([3, 4, 5])
    idx_down = torch.tensor([7, 9, 12])
    pack, cpar = fs.build_pack(tau, idx_up, idx_down, torch.float64)
    jn = torch.as_tensor(rows)[:, None, :].expand(B, L, m).contiguous()
    bc = torch.as_tensor(rows).clone()
    got = fs.up_sweep_smooth_plain(jn, pack, cpar, mu_row, bc)
    want = jps.up_sweep_smooth_pallas(_j(jn), _j(pack), _j(cpar), _j(mu_row), _j(bc),
                                      block_b=3, interpret=True)
    assert_close_scaled(got.numpy(), want, rtol=1e-12, atol_scale=1e-14)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("grid", [JGrid(51, 16), JGrid(201, 16),
                                  JGrid(51, 16, spacing="gauss")],
                         ids=["m51", "m201", "gauss51"])
def test_band_functions_match_jax(grid):
    rng = np.random.default_rng(11)
    m = grid.nb_angles
    jst = jsw.stencils_for(grid)
    st = sw.build_stencils(grid.mu(), m)
    for f in ("poly_w", "poly_src", "poly_mask", "small_cols", "taylor_mask"):
        np.testing.assert_array_equal(getattr(st, f), getattr(jst, f))
    assert (st.band_max, st.bands) == (jst.band_max, jst.bands)
    field = rng.normal(size=(2, grid.nb_layers, m))
    polys, valids = sw.polyfit_band_variants(torch.as_tensor(field),
                                             sw.stencils_on(st, "cpu", torch.float64))
    for b in range(2):
        jp, jv = jsw.polyfit_band_variants(jnp.asarray(field[b]), jst)
        assert_close_scaled(polys[:, b].numpy(), jp, rtol=1e-12, atol_scale=1e-14)
        np.testing.assert_array_equal(valids.numpy(), np.asarray(jv))
    choice = np.array([0, 3])
    got = sw.select_band_choice(polys, torch.as_tensor(choice)[:, None, None])
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(), polys[choice[b], b].numpy())
    jsel = jsw.select_band_choice(jnp.asarray(valids.numpy()), jnp.asarray(choice)[:, None])
    sel = sw.select_band_choice(valids, torch.as_tensor(choice)[:, None])
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert (sw.SMOOTH_TOL, sw.EXP_CLAMP) == (jsw.SMOOTH_TOL, jsw.EXP_CLAMP)


def test_wrappers_run_the_plain_versions_on_cpu_tensors(order2):
    fb, jn, m = order2
    fs.down_sweep.launches = fs.up_sweep_smooth.launches = 0
    dn = fs.down_sweep(jn[:, :, :m], fb.pack, fb.mu_down_safe)
    assert torch.equal(dn, fs.down_sweep_plain(jn[:, :, :m], fb.pack, fb.mu_down_safe))
    bc = fb.surface_bc(fb.narrow_down_fixes(dn.clone(), jn))
    args = (jn[:, :, m:], fb.pack, fb.cparams, fb.mu_up_row, bc)
    assert torch.equal(fs.up_sweep_smooth(*args), fs.up_sweep_smooth_plain(*args))
    # a launch is counted only where a kernel is launched
    assert fs.down_sweep.launches == fs.up_sweep_smooth.launches == 0
    from sos_rt_tpu_torch.ops import megastream as ms
    assert set(fs.KERNELS) <= set(ms.ALL_KERNELS) and len(ms.ALL_KERNELS) == 8
