"""The mega engine with the first order from the host (``i1='host'``).

``sos_rt_tpu_torch.fused.solve_batch_mega(i1='host')`` against
``sos_rt_tpu.fused.solve_batch_mega(i1='host', interpret=True)`` (the
Pallas kernels with their ``i1dn`` / ``i1up`` inputs, in interpreter mode)
at GridSpec(56, 64), B=4, ``cols_per_block=2``, float64, resident and
streamed: equal order counts and flags, I_total and Solution.i1 within
rtol 1e-9 (atol 1e-11·scale), with the default ``sort=True`` and with
``sort=False``.  In the port, ``i1='host'`` equals ``i1='kernel'`` (the
same closed form, regrouped: equal counts, 1e-12 of scale), launches no
passI, returns I₁ only for full outputs, and the fused fallback keeps its
own I₁.  One JAX solve per execution, shared by the module.
"""
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu_torch.fused import prepare_batch, solve_batch_mega
from sos_rt_tpu_torch.ops import megakernel as mk
from sos_rt_tpu_torch.ops import megastream as ms

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(56, 64)
OPTS = JOpts(surface="lambertian", dtype="float64")


@pytest.fixture(scope="module")
def tables():
    return jax_tables(GRID)


@pytest.fixture(scope="module", params=[False, True], ids=["resident", "streamed"])
def jax_host(request, tables):
    stream = request.param
    scenes = jax_scenes(4)
    ref = j_solve_mega(scenes, tables, GRID, OPTS, cols_per_block=2, interpret=True,
                       stream=stream, i1="host", outputs="full")
    return stream, scenes, ref


def _port(scenes, tables, stream, **kw):
    return solve_batch_mega(*port_inputs(scenes, tables, GRID, OPTS), cols_per_block=2,
                            stream=stream, device="cpu", **kw)


def _same(got, ref, rtol):
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert_close_scaled(got.i_total.numpy(), np.asarray(ref.i_total), rtol=rtol,
                        atol_scale=rtol * 1e-2)
    assert_close_scaled(got.i1.numpy(), np.asarray(ref.i1), rtol=rtol,
                        atol_scale=rtol * 1e-2)


@pytest.mark.parametrize("sort", [True, False])
def test_host_i1_matches_jax(jax_host, tables, sort):
    stream, scenes, ref = jax_host
    ms.reset_launches()
    got = _port(scenes, tables, stream, i1="host", outputs="full", sort=sort)
    assert got.i1 is not None and tuple(got.i1.shape) == (4, 64, 112)
    assert bool(got.converged.all())
    _same(got, ref, 1e-9)
    # the CPU runs the plain versions: no kernel launched, no passI
    assert [k.launches for k in ms.ALL_KERNELS] == [0] * len(ms.ALL_KERNELS)


def test_host_i1_equals_kernel_i1(jax_host, tables):
    stream, scenes, ref = jax_host
    host = _port(scenes, tables, stream, i1="host", outputs="full")
    kern = _port(scenes, tables, stream, i1="kernel", outputs="full")
    assert kern.i1 is None
    np.testing.assert_array_equal(host.n_orders.numpy(), kern.n_orders.numpy())
    np.testing.assert_array_equal(host.n_orders.numpy(), np.asarray(ref.n_orders))
    assert_close_scaled(host.i_total.numpy(), kern.i_total.numpy(), rtol=1e-12,
                        atol_scale=1e-14)
    # summary outputs carry the same rows and no I₁
    summ = _port(scenes, tables, stream, i1="host", outputs="summary")
    assert not hasattr(summ, "i1")
    np.testing.assert_array_equal(summ.i_toa.numpy(), host.i_total[:, 0].numpy())
    np.testing.assert_array_equal(summ.i_surface.numpy(), host.i_total[:, -1].numpy())


def test_host_i1_planes_start_the_loop():
    """The prepared batch holds I₁ and its (L, Bp, Mp) planes, angle pads
    0; the plain loops started from them equal the loops that evaluate I₁
    themselves."""
    g50 = JGrid(50, 32)                           # Mp = 56: four pad angles
    scenes, tbl, grid, opts = port_inputs(jax_scenes(4), jax_tables(g50), g50, OPTS)
    from sos_rt_tpu_torch.fused import scene_on, tables_on

    scenes, tbl = scene_on(scenes, "cpu"), tables_on(tbl, "cpu")
    host = prepare_batch(scenes, tbl, grid, opts, cols_per_block=2, device="cpu",
                         i1="host")
    kern = prepare_batch(scenes, tbl, grid, opts, cols_per_block=2, device="cpu")
    L, Mp = grid.nb_layers, host.ops.mp
    assert tuple(host.i1dn.shape) == (L, 4, Mp) and host.tiles.shape[0] == 0
    assert float(host.i1dn[..., grid.nb_angles:].abs().max()) == 0.0
    m = grid.nb_angles
    i1 = torch.cat([host.i1dn[..., :m], host.i1up[..., :m]], -1).transpose(0, 1)
    assert torch.equal(i1, host.i1)
    pk, cp, ti = kern.block(1)
    fdn, fup = ms.passI_plain(pk, ti, cp, kern.ops)
    planes = ms.i1_block_of(host.i1dn, host.i1up, 1, 2)
    assert_close_scaled(planes["i1dn"].numpy(), fdn.numpy(), 1e-12, 1e-14)
    assert_close_scaled(planes["i1up"].numpy(), fup.numpy(), 1e-12, 1e-14)
    kw = dict(tol=float(opts.tol), max_orders=int(opts.max_orders), full=False)
    a = mk.mega_call(host.pack, host.cpar, host.tiles, host.ops, cols_per_tile=2,
                     **kw, **host.i1_planes())
    b = mk.mega_call(kern.pack, kern.cpar, kern.tiles, kern.ops, cols_per_tile=2, **kw)
    assert torch.equal(a[-1][mk.ST_N], b[-1][mk.ST_N])
    for x, y in zip(a[:4], b[:4]):
        assert_close_scaled(x.numpy(), y.numpy(), 1e-12, 1e-14)
    c = ms.stream_order_loop(host.pack, host.cpar, host.tiles, host.ops,
                             cols_per_block=2, **{k: v for k, v in kw.items()
                                                  if k != "full"},
                             **host.i1_planes())
    assert torch.equal(c[-1][mk.ST_N], a[-1][mk.ST_N])
    with pytest.raises(ValueError, match="i1 mode"):
        prepare_batch(scenes, tbl, grid, opts, device="cpu", i1="device")


def test_fused_fallback_keeps_its_i1(tables):
    """A grid the mega path cannot take goes to the fused engine, whose
    Solution carries its own I₁ whatever ``i1`` says."""
    small = JGrid(201, 48)
    port = port_inputs(jax_scenes(2), jax_tables(small), small, OPTS)
    for i1 in ("host", "kernel"):
        sol = solve_batch_mega(*port, i1=i1, device="cpu")
        assert sol.i1 is not None and bool(sol.converged.all())
    with pytest.raises(ValueError, match="i1 mode"):
        solve_batch_mega(*port, i1="other", device="cpu")
