"""The µ→0⁻ down-fix shared by the host-loop engines, against the JAX package.

``sos_rt_tpu_torch.ops.sweeps.DownFix`` writes the small-µ columns' windowed
or Taylor values, the zeroed µ=0⁻ column and each region's polyfit band into
a downward field; the reference, fused, layer-sharded and single-layer solves
all call it.  Here it meets the JAX reference engine's composition of the
same steps (``down_small_mu``, ``polyfit_band_variants``,
``select_band_choice``), column by column, on a uniform grid without small-µ
columns and on a Gauss grid with a Taylor column, in float64 and float32;
and the device stencils it reads are copied to their device once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid
from sos_rt_tpu.ops import sweeps as jsw
from sos_rt_tpu_torch.config import GridSpec
from sos_rt_tpu_torch.grids import tau_profile
from sos_rt_tpu_torch.ops import sweeps as sw

from torch_cases import assert_close_scaled

GRIDS = {"uniform": (51, 24, "uniform"), "gauss_taylor": (51, 24, "gauss")}
# rtol, absolute floor as a share of the largest value: float64 differs from
# JAX only in a 6-term dot's summation order; float32 by that order at its
# own epsilon (2⁻²³), times the band's extrapolation weights
TOLS = {torch.float64: (1e-12, 1e-14), torch.float32: (2e-5, 2e-6)}
CPU = torch.device("cpu")


def _columns(nb_layers, dtype):
    """τ profiles (B, L) whose two regions select every band width, with an
    aerosol layer in the top layer and one in the bottom layer."""
    tau, idx_up, idx_down = tau_profile(
        torch.tensor([0.044, 0.5, 3.0, 6.0, 0.2], dtype=torch.float64),
        torch.tensor([0.02, 0.3, 1.5, 4.0, 0.6], dtype=torch.float64),
        torch.full((5,), 120.0, dtype=torch.float64),
        torch.tensor([25.0, 30.0, 20.0, 25.0, 120.0], dtype=torch.float64),
        torch.tensor([17.0, 10.0, 15.0, 2.0, 0.1], dtype=torch.float64), nb_layers)
    return tau.to(dtype), idx_up, idx_down


def _jax_fix(raw, jn, tau, idx_up, idx_down, mu, grid):
    """The JAX reference engine's down-fix (sos_rt_tpu/solver.py's
    compute_down after its scan) of one column (L, M)."""
    st = jsw.stencils_for(grid)
    m = grid.nb_angles
    if st.small_cols.size:
        cols = jnp.asarray(st.small_cols)
        raw = raw.at[:, cols].set(jsw.down_small_mu(
            jn[:, cols], raw[:, cols], tau, mu[cols], jnp.asarray(st.taylor_mask),
            idx_up, idx_down))
    raw = raw.at[:, m - 1].set(0.0)
    choice_a = jsw.band_choice(tau[idx_up - 1])
    choice_bc = jsw.band_choice(tau[idx_down])
    mask = jnp.asarray(st.poly_mask)
    in_a_col = (jnp.arange(tau.shape[0]) < idx_up)[:, None]
    band_valid = jnp.where(in_a_col, jsw.select_band_choice(mask, choice_a)[None, :],
                           jsw.select_band_choice(mask, choice_bc)[None, :])
    polys, _ = jsw.polyfit_band_variants(raw, st)
    poly = jnp.where(in_a_col, jsw.select_band_choice(polys, choice_a),
                     jsw.select_band_choice(polys, choice_bc))
    cols = m - 1 - jnp.arange(st.band_max)
    return raw.at[:, cols].set(jnp.where(band_valid, poly, raw[:, cols])), (choice_a,
                                                                           choice_bc)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_device_stencils_are_built_once_on_their_device(dtype):
    grid = GridSpec(51, 24, spacing="gauss")
    st = sw.device_stencils(grid, CPU, dtype)
    assert sw.device_stencils(grid, CPU, dtype) is st
    host = sw.stencils_for(grid)
    assert (st.nb_angles, st.band_max, st.has_small) == (51, host.band_max, True)
    for c in range(4):
        assert st.poly_w[c].dtype == dtype and st.poly_src[c].dtype == torch.int64
        np.testing.assert_array_equal(st.poly_w[c].numpy(), host.poly_w[c].astype(
            np.float64 if dtype == torch.float64 else np.float32))
        np.testing.assert_array_equal(st.poly_src[c].numpy(), host.poly_src[c])
    for f in ("poly_mask", "small_cols", "taylor_mask"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), getattr(host, f))
    np.testing.assert_array_equal(st.band_cols.numpy(), 50 - np.arange(host.band_max))
    tensors = [*st.poly_w, *st.poly_src, st.poly_mask, st.small_cols, st.taylor_mask,
               st.band_cols]
    assert all(t.device == CPU for t in tensors)
    other = sw.device_stencils(grid, CPU, torch.float32 if dtype == torch.float64
                               else torch.float64)
    assert other is not st
    with pytest.raises(TypeError, match="device stencils"):
        sw.polyfit_band_variants(torch.zeros((2, 51), dtype=dtype), host)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_down_fix_matches_jax(name, dtype):
    m, nb_layers, spacing = GRIDS[name]
    grid, jgrid = GridSpec(m, nb_layers, spacing=spacing), JGrid(m, nb_layers,
                                                                 spacing=spacing)
    tau, idx_up, idx_down = _columns(nb_layers, dtype)
    rng = np.random.default_rng(23)
    raw = torch.as_tensor(rng.uniform(0.1, 1.0, (5, nb_layers, m))).to(dtype)
    jn = torch.as_tensor(rng.uniform(0.1, 1.0, (5, nb_layers, 2 * m))).to(dtype)
    mu = torch.as_tensor(grid.mu()).to(dtype)
    fix = sw.DownFix.build(sw.device_stencils(grid, CPU, dtype), tau, idx_up, idx_down, mu)
    got = raw.clone()
    assert fix.apply(got, jn) is got
    assert (fix.window is not None) == (name == "gauss_taylor")
    if name == "gauss_taylor":
        assert sw.stencils_for(grid).taylor_mask.any()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = lambda x: jnp.asarray(x.numpy(), jdt)
    rtol, floor = TOLS[dtype]
    seen = set()
    choice_a, choice_bc = sw.region_band_choices(tau, idx_up, idx_down)
    for b in range(5):
        want, choices = _jax_fix(j(raw[b]), j(jn[b, :, :m]), j(tau[b]), int(idx_up[b]),
                                 int(idx_down[b]), j(mu), jgrid)
        assert (int(choice_a[b]), int(choice_bc[b])) == tuple(map(int, choices))
        seen.update(map(int, choices))
        assert_close_scaled(got[b].numpy(), want, rtol=rtol, atol_scale=floor)
    assert seen == {0, 1, 2, 3}
    # the columns the fix leaves alone keep their bits
    touched = set(range(m - 1 - fix.stencils.band_max, m)) | set(
        fix.stencils.small_cols.tolist())
    kept = [k for k in range(m) if k not in touched]
    assert torch.equal(got[:, :, kept], raw[:, :, kept])


def test_down_fix_of_a_layer_shard_is_the_whole_fix_on_its_rows():
    grid = GridSpec(51, 24)
    tau, idx_up, idx_down = _columns(24, torch.float64)
    mu = torch.as_tensor(grid.mu())
    fix = sw.DownFix.build(sw.device_stencils(grid, CPU, torch.float64), tau, idx_up,
                           idx_down, mu)
    raw = torch.as_tensor(np.random.default_rng(5).uniform(0.1, 1.0, (5, 24, 51)))
    whole = fix.apply(raw.clone(), raw)
    for own in (slice(0, 12), slice(12, 24), slice(6, 18)):
        part = fix.rows(own).apply(raw[:, own].clone(), raw[:, own])
        assert torch.equal(part, whole[:, own])
    gauss = GridSpec(51, 24, spacing="gauss")
    small = sw.DownFix.build(sw.device_stencils(gauss, CPU, torch.float64), tau, idx_up,
                             idx_down, torch.as_tensor(gauss.mu()))
    with pytest.raises(ValueError, match="small-µ window"):
        small.rows(slice(0, 12))
