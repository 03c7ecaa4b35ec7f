"""Command line: `python -m sos_rt_tpu_torch <command>`.

Counterpart of ``sos_rt_tpu/cli.py``, with the same commands and flags:

  sweep            batched column sweep (columns × parameters)
  list             show presets and phase models
  run              solve a scenario preset        (not ported yet)
  critical-albedo  Haywood critical-albedo search (not ported yet)

and one flag more, ``--device``: the commands run on the GPU unless it
names another device (``--device cpu`` runs the plain PyTorch versions of
the kernels).  All outputs are relative paths.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from sos_rt_tpu_torch.config import SCENE_FIELDS, NotPortedError


def cmd_sweep(args):
    """Batched column sweep.  Defaults for a sweep preset: mega engine,
    summary outputs, µ0 drawn from a 64-value pool.  With ``--chunk`` +
    ``--output DIR`` results are written as resumable per-chunk shards
    (``--resume`` skips completed ones)."""
    from sos_rt_tpu_torch import sweep as _sweep
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
    if args.mesh:
        raise NotPortedError("--mesh (multi-GPU column sharding) is not "
                             "ported yet; see ROADMAP.md")
    # --output without --chunk = one shard covering the whole batch
    chunk = args.chunk or (batch if args.output else 0)
    log = lambda m: print(f"[sos] {m}", file=sys.stderr)
    m = _sweep.run_sweep(
        p, batch, seed=args.seed, mu0_pool=mu0_pool, engine=engine,
        outputs=outputs, buckets=args.buckets, block_b=args.block_b,
        chunk=chunk, out_dir=args.output, resume=args.resume, log=log,
        save_orders=args.save_orders, sort=args.sort, device=args.device)
    m["preset"], m["batch_requested"] = args.preset, batch
    if "col_per_s" in m:
        log(f"{batch} columns: {m.get('wall_s', 0):.2f}s "
            f"({m['col_per_s']:,.0f} col/s), engine={engine}/{outputs}")
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


def cmd_run(_args):
    raise NotPortedError("the run command needs solve_column and outputs.py, "
                         "which are not ported yet; see ROADMAP.md")


def cmd_critical_albedo(_args):
    raise NotPortedError("the critical-albedo command needs forcing.py, "
                         "which is not ported yet; see ROADMAP.md")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sos_rt_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    device = dict(default=None, help="torch device (default: the GPU; 'cpu' runs "
                                     "the plain PyTorch versions of the kernels)")

    run = sub.add_parser("run", help="solve one scenario (not ported yet)")
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
                     help="also write per-order fields + per-order diffusivity")
    run.add_argument("--device", **device)
    run.set_defaults(fn=cmd_run)

    ca = sub.add_parser("critical-albedo",
                        help="Haywood critical albedo (not ported yet)")
    ca.add_argument("--preset", default="eva")
    ca.add_argument("--tau-aer", default="0.120", dest="tau_aer",
                    help="comma-separated τ*_aer values (batched as lanes)")
    ca.add_argument("--num", type=int, default=0,
                    help="densify to N geometric τ*_aer lanes between "
                         "min/max of --tau-aer")
    ca.add_argument("--engine", choices=["mega", "reference", "column"],
                    default="mega", help="forcing evaluator per bisection step")
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
                    help="record per-order TOA/surface rows per column in "
                         "the shard files (not ported yet)")
    sw.add_argument("--mm", choices=["bf16x3", "bf16x5", "highest"],
                    help="matmul precision mode (config.SolverOptions.mm)")
    sw.add_argument("--chunk", type=int, default=0,
                    help="columns per resumable shard (with --output DIR)")
    sw.add_argument("--resume", action="store_true",
                    help="skip shards already in --output/index.json")
    sw.add_argument("--metrics", help="write aggregated metrics JSON here")
    sw.add_argument("--mesh", action="store_true",
                    help="shard over all visible devices (not ported yet)")
    sw.add_argument("--output", "-o",
                    help="shard output DIRECTORY (npz shards + index.json)")
    sw.add_argument("--device", **device)
    sw.set_defaults(fn=cmd_sweep)

    ls = sub.add_parser("list", help="list presets and models")
    ls.set_defaults(fn=cmd_list)
    return ap


def main(argv=None):
    """Run a command.  A route that is not ported yet ends the program
    with its message (exit code 1)."""
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except NotPortedError as e:
        raise SystemExit(f"sos_rt_tpu_torch: not ported yet: {e}")


if __name__ == "__main__":
    main()
