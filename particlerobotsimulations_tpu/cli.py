"""Command-line entry point.

Mirrors the reference binary's interface (``./ParticleBot <cfg>``,
/root/reference/main.cpp:913-917) plus subcommands the reference lacks:

    python -m particlerobotsimulations_tpu.cli simulate examples/example.cfg
    python -m particlerobotsimulations_tpu.cli simulate cfg --video --max-time 600
    python -m particlerobotsimulations_tpu.cli sweep cfg --seeds 0:8 --steps 6000
    python -m particlerobotsimulations_tpu.cli bench

Outputs land in the working directory under the cfg's csv_filename /
video_filename, exactly like the reference.
"""

from __future__ import annotations

import argparse
import sys
import time


_PLATFORM_HELP = (
    "force the JAX platform (e.g. 'cpu'); overrides an environment-pinned "
    "JAX_PLATFORMS, which clobbers the usual env-var override"
)


def _add_overrides(p: argparse.ArgumentParser):
    p.add_argument("--max-time", type=float, default=None, help="override max_time")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--n-cells", type=int, default=None)
    p.add_argument("--backend", type=str, default=None,
                   help="force backend: dense|cellgrid|stencil|pallas")
    p.add_argument("--csv", type=str, default=None, help="override csv_filename")
    p.add_argument("--testing", type=int, default=None,
                   help="1 = full per-bot CSV columns (enables resume)")
    p.add_argument("--platform", type=str, default=None, help=_PLATFORM_HELP)


def _apply_overrides(params, args):
    from .config import ForceBackend

    over = {}
    if args.max_time is not None:
        over["max_time"] = args.max_time
    if args.seed is not None:
        over["seed"] = args.seed
    if args.n_cells is not None:
        over["n_cells"] = args.n_cells
    if args.backend is not None:
        try:
            over["force_backend"] = ForceBackend[args.backend.upper()]
        except KeyError:
            names = ", ".join(b.name.lower() for b in ForceBackend)
            raise SystemExit(
                f"error: unknown backend '{args.backend}' (choose from: {names})"
            )
    if args.csv is not None:
        over["csv_filename"] = args.csv
    if args.testing is not None:
        over["testing"] = args.testing
    return params.replace(**over) if over else params


def cmd_simulate(args) -> int:
    import os

    from .config import load_cfg
    from .sim import Simulation

    params = _apply_overrides(load_cfg(args.cfg), args)
    resumed = False
    if args.resume:
        # reference 'cont' mode (main.cpp:886, 941-956): continue from the
        # last complete CSV row; checkpoint resume is higher fidelity
        if args.checkpoint and os.path.exists(args.checkpoint):
            from .io.checkpoint import load_checkpoint
            from .sim import Simulation as S

            ck_params, ck_state = load_checkpoint(args.checkpoint)
            # CLI overrides (e.g. a later --max-time) apply on top of the
            # checkpointed params; structural mismatches raise on shapes
            sim = S(_apply_overrides(ck_params, args), state=ck_state)
            resumed = True
        elif os.path.exists(params.csv_filename):
            sim = Simulation.resume_from_csv(params, params.csv_filename)
            resumed = True
        else:
            raise SystemExit(
                "error: --resume needs an existing checkpoint or CSV "
                f"({params.csv_filename})"
            )
        print(f"resumed at t = {sim.time:g} s", file=sys.stderr)
    else:
        sim = Simulation(params)
    # a checkpoint resume may carry different params (e.g. a --n-cells
    # override recorded at save time): the recorder, CSV target and the
    # summary must describe the sim that actually runs, not the cfg
    params = sim.params
    start_steps = int(sim.time / params.timestep + 0.5)

    recorder = None
    frame_cb = None
    if args.video:
        from .render.video import VideoRecorder

        recorder = VideoRecorder(params, width=args.video_width,
                                 height=args.video_height,
                                 codec=args.video_codec,
                                 quality=args.video_quality,
                                 style=args.video_style)
        frame_cb = recorder.capture
        print(f"recording video -> {recorder.path}", file=sys.stderr)

    t0 = time.time()
    try:
        sim.run(
            csv_path=params.csv_filename,
            echo=not args.quiet,
            checkpoint_path=args.checkpoint,
            checkpoint_every_dumps=args.checkpoint_every,
            frame_callback=frame_cb,
            frame_every_steps=args.frame_every or None,
            append_csv=resumed,
        )
    finally:
        if recorder is not None:
            recorder.close()
    wall = time.time() - t0
    # steps actually executed this invocation (a resume starts mid-run)
    steps = max(0, params.n_steps() - start_steps)
    print(
        f"simulated {steps * params.timestep:g} sim-s ({steps} steps, "
        f"{params.n_cells} bots) in {wall:.1f} s wall "
        f"({steps * params.n_cells / max(wall, 1e-9) / 1e6:.2f} M particle-steps/s)",
        file=sys.stderr,
    )
    return 0


def cmd_sweep(args) -> int:
    from .config import load_cfg
    from .parallel.sweep import default_mesh, run_sweep, sweep_summary

    params = _apply_overrides(load_cfg(args.cfg), args)
    lo, hi = (int(x) for x in args.seeds.split(":"))
    seeds = list(range(lo, hi))
    n_steps = args.steps or params.n_steps()
    mesh = default_mesh() if args.mesh else None
    _, cents = run_sweep(params, seeds, n_steps, mesh=mesh)
    summary = sweep_summary(cents, params)
    print("time_s,distance_mean,distance_std,centroid_x,centroid_y")
    dump_dt = params.dump_steps * params.timestep
    for i in range(len(summary["distance_mean"])):
        print(
            f"{i * dump_dt:g},{summary['distance_mean'][i]:f},"
            f"{summary['distance_std'][i]:f},"
            f"{summary['centroid_mean'][i, 0]:f},{summary['centroid_mean'][i, 1]:f}"
        )
    return 0


def cmd_experiment(args) -> int:
    from .config import load_cfg
    from .models.experiments import (
        dead_cell_robustness,
        gap_transit,
        payload_transport,
        phototaxis_speed,
    )
    from .parallel.sweep import default_mesh

    params = _apply_overrides(load_cfg(args.cfg), args)
    lo, hi = (int(x) for x in args.seeds.split(":"))
    seeds = list(range(lo, hi))
    mesh = default_mesh() if args.mesh else None

    if args.kind == "robustness":
        fracs = [float(f) for f in args.fractions.split(",")]
        out = dead_cell_robustness(params, fracs, seeds, args.sim_seconds, mesh=mesh)
        print("dead_fraction,approach_speed_units_per_s")
        for f, v in zip(out["fractions"], out["approach_speed"]):
            print(f"{f:g},{v:.6f}")
    elif args.kind == "gap":
        out = gap_transit(params, seeds, args.sim_seconds, mesh=mesh)
        print("seed,frac_past_wall")
        for s, v in zip(seeds, out["frac_past_wall"]):
            print(f"{s},{v:.4f}")
        print(f"# mean fraction past wall x={out['wall_x']:g}: "
              f"{out['frac_past_wall_mean']:.4f}")
    elif args.kind == "transport":
        out = payload_transport(params, seeds, args.sim_seconds, mesh=mesh)
        print("seed,payload_dx,payload_dy")
        for s, d in zip(seeds, out["payload_displacement"]):
            print(f"{s},{d[0]:.6f},{d[1]:.6f}")
        print(f"# mean payload dx: {out['payload_mean_dx']:.6f}")
    else:
        out = phototaxis_speed(params, seeds, args.sim_seconds, mesh=mesh)
        print("time_s,distance_mean,distance_std")
        for t, m, s in zip(out["time_s"], out["distance_mean"], out["distance_std"]):
            print(f"{t:g},{m:.6f},{s:.6f}")
        print(f"# approach speed: {out['approach_speed']:.6f} units/s")
    return 0


def cmd_bench(args) -> int:
    import importlib.util
    import os

    # the benchmark harness lives at the repo root (the driver runs it as
    # `python bench.py`); an installed package has no copy next to it
    path = os.path.join(os.path.dirname(__file__), "..", "bench.py")
    if not os.path.exists(path):
        raise SystemExit(
            "error: bench.py not found next to the package — the bench "
            "subcommand needs a source checkout (run `python bench.py` "
            "from the repo root)"
        )
    spec = importlib.util.spec_from_file_location("bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="particlerobotsimulations_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sim_p = sub.add_parser("simulate", help="run one scenario from a .cfg")
    sim_p.add_argument("cfg")
    sim_p.add_argument("--video", action="store_true", help="record AVI video")
    # reference default geometry: 1920x1080 @ 20 FPS (main.cpp:65,
    # postprocess.cu:102)
    sim_p.add_argument("--video-width", type=int, default=1920)
    sim_p.add_argument("--video-height", type=int, default=1080)
    sim_p.add_argument("--video-codec", choices=["MJPG", "DIB "], default="MJPG",
                       help="MJPG (compressed, default) or 'DIB ' (raw)")
    sim_p.add_argument("--video-quality", type=int, default=90,
                       help="JPEG quality 1-100 for MJPG")
    sim_p.add_argument("--video-style", choices=["2d", "3d"], default="2d",
                       help="top-down ortho (2d) or the reference's "
                            "perspective presentation look (3d)")
    sim_p.add_argument("--frame-every", type=int, default=0,
                       help="physics steps between frames "
                            "(default: cfg DISPLAY_INTERVAL)")
    sim_p.add_argument("--quiet", action="store_true")
    sim_p.add_argument("--resume", action="store_true",
                       help="continue from checkpoint/CSV (reference 'cont' mode)")
    sim_p.add_argument("--checkpoint", type=str, default=None)
    sim_p.add_argument("--checkpoint-every", type=int, default=0,
                       help="checkpoint every N dumps")
    _add_overrides(sim_p)
    sim_p.set_defaults(fn=cmd_simulate)

    sw_p = sub.add_parser("sweep", help="Monte-Carlo seed sweep over devices")
    sw_p.add_argument("cfg")
    sw_p.add_argument("--seeds", type=str, default="0:8", help="lo:hi seed range")
    sw_p.add_argument("--steps", type=int, default=0)
    sw_p.add_argument("--mesh", action="store_true", help="shard over all devices")
    _add_overrides(sw_p)
    sw_p.set_defaults(fn=cmd_sweep)

    b_p = sub.add_parser("bench", help="run the throughput benchmark")
    b_p.add_argument("--platform", type=str, default=None, help=_PLATFORM_HELP)
    b_p.set_defaults(fn=cmd_bench)

    ex_p = sub.add_parser(
        "experiment", help="canned paper experiments (robustness, transport)"
    )
    ex_p.add_argument("kind", choices=["robustness", "transport", "speed", "gap"])
    ex_p.add_argument("cfg")
    ex_p.add_argument("--seeds", type=str, default="0:8")
    ex_p.add_argument("--sim-seconds", type=float, default=600.0)
    ex_p.add_argument("--fractions", type=str, default="0,0.1,0.2,0.3",
                      help="dead-cell fractions (robustness)")
    ex_p.add_argument("--mesh", action="store_true")
    _add_overrides(ex_p)
    ex_p.set_defaults(fn=cmd_experiment)

    args = ap.parse_args(argv)
    if getattr(args, "platform", None) is not None:
        # Must happen before any computation: the config update after
        # import wins over an environment-pinned JAX_PLATFORMS.
        import jax

        try:
            from jax._src import xla_bridge

            initialized = xla_bridge.backends_are_initialized()
        except (ImportError, AttributeError):  # pragma: no cover - jax drift
            initialized = False
        if initialized and jax.default_backend() != args.platform:
            # jax.config.update is silently ineffective once a backend
            # client exists (e.g. a second programmatic cli.main() call in
            # the same process): say so instead of running on the old one.
            # (No warning when the requested platform already matches the
            # initialized one — the override is then a no-op, not a trap.)
            print(
                "warning: --platform set after JAX backends were already "
                "initialized in this process; the override may not take "
                "effect for this run",
                file=sys.stderr,
            )
        jax.config.update("jax_platforms", args.platform)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
