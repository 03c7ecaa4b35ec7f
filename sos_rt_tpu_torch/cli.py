"""Command line: `python -m sos_rt_tpu_torch <command>`.

Counterpart of ``sos_rt_tpu/cli.py``, with the same commands and flags:

  run              solve a scenario preset (or overridden parameters),
                   write results to .npz, optionally plot
  critical-albedo  Haywood critical-albedo search over τ*_aer values
  sweep            batched column sweep (columns × parameters)
  list             show presets and phase models

and one flag more, ``--device``: the commands run on the GPU unless it
names another device (``--device cpu`` runs the plain PyTorch versions of
the kernels).  All outputs are relative paths.  ``run`` and
``critical-albedo`` default to the ``eva`` preset, whose log-normal Mie
tables are built on the host (``models/mie_tables.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from sos_rt_tpu_torch.config import SCENE_FIELDS, torch_dtype


def _build(preset, dtype, device):
    from sos_rt_tpu_torch.solver import PhaseTables

    return PhaseTables.from_models(preset.grid, float(np.asarray(preset.scene.mu0)),
                                   atm=preset.atm, aer=preset.aer,
                                   dtype=torch_dtype(dtype), device=device)


def _scene_overrides(scene, args):
    over = {f: getattr(args, f) for f in SCENE_FIELDS
            if getattr(args, f, None) is not None}
    return dataclasses.replace(scene, **over) if over else scene


def _to_np(x):
    return x.detach().cpu().numpy()


def cmd_run(args):
    """Solve one column of a preset (the reference engine) and write the
    radiance field, I₁, fluxes, diffusivity and heating rate to .npz."""
    from sos_rt_tpu_torch import outputs
    from sos_rt_tpu_torch.config import GridSpec, resolve_device
    from sos_rt_tpu_torch.presets import get_preset
    from sos_rt_tpu_torch.solver import solve_column

    device = resolve_device(args.device)
    p = get_preset(args.preset)
    grid = p.grid
    if args.nb_angles or args.nb_layers:
        grid = GridSpec(nb_angles=args.nb_angles or grid.nb_angles,
                        nb_layers=args.nb_layers or grid.nb_layers)
        p = dataclasses.replace(p, grid=grid)
    opts = p.opts
    for f in ("surface", "dtype", "mm"):
        if getattr(args, f):
            opts = dataclasses.replace(opts, **{f: getattr(args, f)})
    scene = _scene_overrides(p.scene, args)

    print(f"[sos] building {p.atm[0]}/{p.aer[0]} tables "
          f"(grid {grid.nb_angles}x{grid.nb_layers})...", file=sys.stderr)
    tables = _build(dataclasses.replace(p, scene=scene), opts.dtype, device)
    t0 = time.perf_counter()
    sol = solve_column(scene, tables, grid, opts, device=device)
    n_orders = int(sol.n_orders)           # waits for the device
    dt = time.perf_counter() - t0
    print(f"[sos] solved in {dt:.2f}s: {n_orders} orders, "
          f"converged={bool(sol.converged)}", file=sys.stderr)

    as_t = lambda x: torch.as_tensor(x, dtype=sol.i_total.dtype, device=device)
    mu, w = as_t(grid.mu()), as_t(grid.trapz_weights())
    z = torch.as_tensor(np.linspace(float(scene.z0), 0.0, grid.nb_layers),
                        device=device)
    mu0, grd = float(scene.mu0), float(scene.grd_alb)
    fu, fd = outputs.flux_up_down(sol.i_total, mu, w, sol.tau, mu0, grd,
                                  grid.nb_angles)
    nf = outputs.net_flux(sol.i_total, mu, w, sol.tau, mu0, grd)   # graphe_flux convention
    dif = outputs.diffusivity(sol.i_total, mu, w)
    hr = outputs.heating_rate(sol.i_total, mu, w, sol.tau, z, mu0, grd,
                              grid.nb_angles, sol.idx_up, sol.idx_down)
    out = args.output or f"sos_{p.name}.npz"
    np.savez_compressed(
        out, I=_to_np(sol.i_total), I1=_to_np(sol.i1), tau=_to_np(sol.tau),
        mu=_to_np(mu), z=_to_np(z), flux_up=_to_np(fu), flux_down=_to_np(fd),
        net_flux=_to_np(nf), diffusivity=_to_np(dif), heating_rate=_to_np(hr),
        n_orders=n_orders)
    print(f"[sos] wrote {out}", file=sys.stderr)
    if args.save_orders:
        _save_orders(scene, tables, grid, opts, out, z, device)
    if args.plot:
        _plot(out)


def _save_orders(scene, tables, grid, opts, out, z, device):
    """Per-order artifacts: Iₙ fields + per-order diffusivity + plot (the
    reference's ``graphe_successive_dif``, SOS_Aer_graphe.py:118-149, from
    the driver's ``I_saved`` list, SOS_Aer_main_lambertian.py:460)."""
    from sos_rt_tpu_torch import outputs
    from sos_rt_tpu_torch.solver import solve_column_orders

    _, buf, valid = solve_column_orders(scene, tables, grid, opts, device=device)
    n = int(valid.sum())
    i_orders = buf[:n]
    as_t = lambda x: torch.as_tensor(x, dtype=buf.dtype, device=device)
    dif_orders = _to_np(outputs.per_order_diffusivity(
        i_orders, as_t(grid.mu()), as_t(grid.trapz_weights())))
    path = out.replace(".npz", "_orders.npz")
    np.savez_compressed(path, I_orders=_to_np(i_orders),
                        diffusivity_orders=dif_orders, z=_to_np(z))
    print(f"[sos] wrote {path} ({n} orders)", file=sys.stderr)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    for k in range(n):
        ax.plot(dif_orders[k], _to_np(z), label=f"order {k + 1}", alpha=0.8)
    ax.set_xlabel(r"per-order diffusivity $\bar{\mu}$")
    ax.set_ylabel("Altitude (km)")
    ax.grid(True)
    if n <= 12:
        ax.legend(fontsize=7)
    png = path.replace(".npz", ".png")
    fig.tight_layout(), fig.savefig(png, dpi=150)
    print(f"[sos] wrote {png}", file=sys.stderr)


def _plot(path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(path) as z:
        fig, axes = plt.subplots(1, 3, figsize=(13, 4))
        axes[0].plot(z["flux_up"], z["z"], label="flux up")
        axes[0].plot(z["flux_down"], z["z"], label="flux down")
        if "net_flux" in z.files:
            axes[0].plot(z["net_flux"], z["z"], label="net (graphe)", ls="--")
        axes[0].set_xlabel("Flux"), axes[0].legend()
        axes[1].plot(z["diffusivity"], z["z"])
        axes[1].set_xlabel(r"Diffusivity $\bar{\mu}$")
        axes[2].plot(z["heating_rate"], z["z"])
        axes[2].set_xlabel("Heating rate")
        for ax in axes:
            ax.set_ylabel("Altitude (km)"), ax.grid(True)
        png = path.replace(".npz", ".png")
        fig.tight_layout(), fig.savefig(png, dpi=150)
        print(f"[sos] wrote {png}", file=sys.stderr)


def cmd_critical_albedo(args):
    """Haywood critical-albedo curve over a τ*_aer list: every τ value is
    one lane of a batched scene, and each bisection step solves all lanes
    together."""
    from sos_rt_tpu_torch.config import resolve_device
    from sos_rt_tpu_torch.forcing import critical_albedo, critical_albedo_batch
    from sos_rt_tpu_torch.parallel import broadcast_scene
    from sos_rt_tpu_torch.presets import get_preset

    device = resolve_device(args.device)
    p = get_preset(args.preset)
    if args.engine == "mega" and p.opts.dtype != "float32":
        # the production batched path is the float32 engine; the float64
        # per-column path (--engine column) is the verification twin
        p = dataclasses.replace(p, opts=dataclasses.replace(p.opts, dtype="float32"))
        print("[sos] --engine mega: using float32 (production path); "
              "--engine column keeps the preset dtype", file=sys.stderr)
    tables = _build(p, p.opts.dtype, device)
    taus = np.array([float(x) for x in args.tau_aer.split(",")])
    if args.num and args.num > len(taus):
        # densify between the min/max of --tau-aer; geometric spacing needs
        # a positive lower endpoint, linear otherwise
        lo, hi = float(taus.min()), float(taus.max())
        hi = max(hi, lo + 1e-6)
        taus = np.geomspace(lo, hi, args.num) if lo > 0 else np.linspace(lo, hi, args.num)
    t0 = time.perf_counter()
    scenes = dataclasses.replace(broadcast_scene(p.scene, len(taus), device=device),
                                 tau_star_aer=torch.as_tensor(taus, device=device))
    if args.engine == "column":
        albs = critical_albedo(scenes, tables, p.grid, p.opts, device=device)
    else:
        albs = critical_albedo_batch(scenes, tables, p.grid, p.opts,
                                     engine=args.engine, device=device)
    albs = _to_np(albs)
    dt = time.perf_counter() - t0
    results = {float(t): float(a) for t, a in zip(taus, albs)}
    for t, a in results.items():
        print(f"[sos] tau*_aer={t}: critical albedo = {a:.4f}", file=sys.stderr)
    print(f"[sos] {len(taus)}-point curve in {dt:.2f}s (batched bisection)",
          file=sys.stderr)
    out = args.output or "critical_albedo.json"
    with open(out, "w") as f:
        json.dump({"preset": args.preset, "critical_albedo": results}, f, indent=2)
    print(f"[sos] wrote {out}", file=sys.stderr)
    if args.plot and len(taus) > 1:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(taus, albs, "o-")
        ax.set_xlabel(r"$\tau^*_{aer}$")
        ax.set_ylabel(r"critical albedo $\omega_c$")
        ax.grid(True)
        png = out.rsplit(".", 1)[0] + ".png"
        fig.tight_layout(), fig.savefig(png, dpi=150)
        print(f"[sos] wrote {png}", file=sys.stderr)


def cmd_sweep(args):
    """Batched column sweep.  Defaults for a sweep preset: mega engine,
    summary outputs, µ0 drawn from a 64-value pool.  With ``--chunk`` +
    ``--output DIR`` results are written as resumable per-chunk shards
    (``--resume`` skips completed ones).  ``--mesh`` shards the columns
    over every rank of the process group (``parallel.make_mesh``); the
    mesh's first rank writes the shards and reports."""
    from sos_rt_tpu_torch import sweep as _sweep
    from sos_rt_tpu_torch.parallel.mesh import is_first_rank, make_mesh
    from sos_rt_tpu_torch.presets import get_preset

    p = get_preset(args.preset)
    if args.mm:
        p = dataclasses.replace(p, opts=dataclasses.replace(p.opts, mm=args.mm))
    if args.dtype:
        p = dataclasses.replace(p, opts=dataclasses.replace(p.opts, dtype=args.dtype))
    batch = args.batch or p.batch or 1024
    engine = args.engine or ("mega" if p.batch else "reference")
    outputs = "full" if (args.full or engine != "mega") else "summary"
    mu0_pool = args.mu0_pool if args.mu0_pool is not None else (64 if p.batch else 0)
    mesh = make_mesh(device=args.device) if args.mesh else None
    # --output without --chunk = one shard covering the whole batch
    chunk = args.chunk or (batch if args.output else 0)
    log = lambda m: print(f"[sos] {m}", file=sys.stderr)
    if mesh is not None and is_first_rank(mesh):
        log(f"mesh of {mesh.size()} rank(s), {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
            f"on {mesh.device_type}")
    m = _sweep.run_sweep(
        p, batch, seed=args.seed, mu0_pool=mu0_pool, engine=engine,
        outputs=outputs, buckets=args.buckets, block_b=args.block_b,
        chunk=chunk, out_dir=args.output, resume=args.resume, mesh=mesh, log=log,
        save_orders=args.save_orders, sort=args.sort, device=args.device)
    if mesh is not None and not is_first_rank(mesh):
        return
    m["preset"], m["batch_requested"] = args.preset, batch
    if "col_per_s" in m:
        stages = ", ".join(f"{k} {v:.2f}s" for k, v in m["stages_s"].items())
        log(f"{batch} columns: {m.get('wall_s', 0):.2f}s "
            f"({m['col_per_s']:,.0f} col/s), engine={engine}/{outputs}; {stages}")
    print(json.dumps({"sweep_metrics": m}), flush=True)
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(m, f, indent=2)
        log(f"wrote {args.metrics}")


def cmd_list(_args):
    from sos_rt_tpu_torch.models import available_models
    from sos_rt_tpu_torch.presets import PRESETS

    print("presets:", ", ".join(sorted(PRESETS)))
    print("phase models:", ", ".join(available_models()))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sos_rt_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    device = dict(default=None, help="torch device (default: the GPU; 'cpu' runs "
                                     "the plain PyTorch versions of the kernels)")

    run = sub.add_parser("run", help="solve one scenario")
    run.add_argument("--preset", default="eva")
    run.add_argument("--surface", choices=["lambertian", "specular"])
    run.add_argument("--dtype", choices=["float32", "float64"])
    run.add_argument("--mm", choices=["bf16x3", "bf16x5", "highest"],
                     help="matmul precision mode (config.SolverOptions.mm)")
    run.add_argument("--nb-angles", type=int, dest="nb_angles")
    run.add_argument("--nb-layers", type=int, dest="nb_layers")
    for f in SCENE_FIELDS:
        run.add_argument(f"--{f.replace('_', '-')}", type=float, dest=f)
    run.add_argument("--output", "-o")
    run.add_argument("--plot", action="store_true")
    run.add_argument("--save-orders", action="store_true", dest="save_orders",
                     help="also write per-order fields + per-order "
                          "diffusivity (npz + png)")
    run.add_argument("--device", **device)
    run.set_defaults(fn=cmd_run)

    ca = sub.add_parser("critical-albedo", help="Haywood critical albedo")
    ca.add_argument("--preset", default="eva")
    ca.add_argument("--tau-aer", default="0.120", dest="tau_aer",
                    help="comma-separated τ*_aer values (batched as lanes)")
    ca.add_argument("--num", type=int, default=0,
                    help="densify to N geometric τ*_aer lanes between "
                         "min/max of --tau-aer")
    ca.add_argument("--engine", choices=["mega", "reference", "column"],
                    default="mega",
                    help="forcing evaluator per bisection step: 'mega' = one "
                         "batched summary solve (float32), 'reference' = the "
                         "batched reference engine, 'column' = the per-column "
                         "reference path (float64-capable twin)")
    ca.add_argument("--plot", action="store_true")
    ca.add_argument("--output", "-o")
    ca.add_argument("--device", **device)
    ca.set_defaults(fn=cmd_critical_albedo)

    sw = sub.add_parser("sweep", help="batched column sweep")
    sw.add_argument("--preset", default="fwc_sweep")
    sw.add_argument("--batch", type=int)
    sw.add_argument("--seed", type=int, default=0)
    sw.add_argument("--engine", choices=["reference", "fused", "mega"],
                    help="solver engine (default: mega for sweep presets)")
    sw.add_argument("--full", action="store_true",
                    help="keep full (B, L, 2M) fields instead of "
                         "TOA/surface summary rows")
    sw.add_argument("--mu0-pool", type=int, dest="mu0_pool",
                    help="draw per-column mu0 from N distinct values "
                         "(default 64 for sweep presets; 0 = fixed mu0)")
    sw.add_argument("--buckets", type=int, default=1,
                    help="convergence-homogeneous bucketing")
    sw.add_argument("--block-b", type=int, default=16, dest="block_b")
    sw.add_argument("--sort", choices=["predict", "score"], default="predict",
                    help="mega-engine convergence-sort key: 'predict' = "
                         "coarse-grid order pre-solve, 'score' = closed-form "
                         "proxy")
    sw.add_argument("--dtype", choices=["float32", "float64"],
                    help="override the preset compute dtype")
    sw.add_argument("--save-orders", action="store_true", dest="save_orders",
                    help="record per-order TOA/surface rows + validity per "
                         "column in the shard files (runs the reference "
                         "engine, slower than mega)")
    sw.add_argument("--mm", choices=["bf16x3", "bf16x5", "highest"],
                    help="matmul precision mode (config.SolverOptions.mm)")
    sw.add_argument("--chunk", type=int, default=0,
                    help="columns per resumable shard (with --output DIR)")
    sw.add_argument("--resume", action="store_true",
                    help="skip shards already in --output/index.json")
    sw.add_argument("--metrics", help="write aggregated metrics JSON here")
    sw.add_argument("--mesh", action="store_true",
                    help="shard the columns over every rank of the process group "
                         "(one a GPU: torchrun --nproc-per-node N)")
    sw.add_argument("--output", "-o",
                    help="shard output DIRECTORY (npz shards + index.json)")
    sw.add_argument("--device", **device)
    sw.set_defaults(fn=cmd_sweep)

    ls = sub.add_parser("list", help="list presets and models")
    ls.set_defaults(fn=cmd_list)
    return ap


def main(argv=None):
    """Run a command.  Under ``torchrun`` (its environment) each process
    first starts its rank of the process group on the device of
    ``--device`` (parallel.distributed.init_distributed); without it
    nothing is started."""
    from sos_rt_tpu_torch.parallel.distributed import init_distributed

    args = build_parser().parse_args(argv)
    init_distributed(device=getattr(args, "device", None))
    args.fn(args)


if __name__ == "__main__":
    main()
