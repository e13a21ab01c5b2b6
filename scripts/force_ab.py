"""Force-pass measurements on the card.

Usage:
    python scripts/force_ab.py force [n_bots ...]      # kernel vs plain jnp
    python scripts/force_ab.py crossover [n_bots ...]  # DENSE vs table loop
    python scripts/force_ab.py tiles [n_bots ...]      # kernel alone per tile
    python scripts/force_ab.py trace [n_bots ...]      # device-time breakdown

``force`` times the PALLAS table loop end to end through
``engine.make_run_chunk`` twice: with the Triton force kernel
(``ops/pallas_stencil.table_forces``) and with its plain-jnp twin
(``table_forces_jnp``) swapped in at trace time.  Runs alternate A B B A
on one card; the best of each side is reported in us/step.  The cadence is
pinned to ``slot_rebuild_steps=4`` so both sides compile one program.

``crossover`` times DENSE against the table loop (HEX phototaxis), the
measurement behind ``config.GPU_DENSE_MAX_BOTS``.

``tiles`` times the force kernel alone (inside a jitted loop, so no
dispatch is counted) for several (TILE, NUM_WARPS) pairs, beside the jnp
twin, and checks every variant against the twin.

``trace`` profiles one steady 400-step chunk of the table loop
(``jax.profiler``, written under artifacts/traces/) and reduces the
device events to: the traced window, the device-busy share, the time in
each named scope (``table_forces``, ``slot_rebuild``) and the top kernels.

Every line names the device; the script refuses to run without a GPU.
"""

from __future__ import annotations

import collections
import glob
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])

from particlerobotsimulations_tpu import (  # noqa: E402
    Config,
    ForceBackend,
    SimParams,
    Simulation,
)
from particlerobotsimulations_tpu import engine, engine_table  # noqa: E402
from particlerobotsimulations_tpu.ops import pallas_stencil as ps  # noqa: E402
from particlerobotsimulations_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)


def scene(n: int, **kw) -> SimParams:
    return SimParams(
        n_cells=n, n_dead=0, seed=7, config=Config.HEX,
        light_x=-20.0, light_y=0.0, world_half=0.0, **kw,
    )


def copy(state):
    return jax.tree.map(jnp.copy, state)


def steps_for(n: int) -> int:
    # ~0.1-1 s per timed call; a multiple of the 200-step gate segment
    return 2000 if n <= 20_000 else 400


def time_ab(runs: dict, state0, steps: int, reps: int = 2) -> dict:
    """Best seconds per call of each runner, in A B B A order."""
    states = {k: copy(state0) for k in runs}
    for k, run in runs.items():  # compile + warm
        t0 = time.perf_counter()
        states[k] = jax.block_until_ready(run(states[k], steps, True))
        print(f"  compile+first {k}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    best = {k: float("inf") for k in runs}
    order = list(runs) + list(runs)[::-1]
    for _ in range(reps):
        for k in order:
            t0 = time.perf_counter()
            states[k] = jax.block_until_ready(runs[k](states[k], steps, True))
            best[k] = min(best[k], time.perf_counter() - t0)
    for k, s in states.items():
        if not np.isfinite(np.asarray(s.pos)).all():
            raise RuntimeError(f"{k}: state not finite")
    return best


def jnp_runner(params: SimParams):
    """The table loop with the jnp twin traced in place of the kernel."""
    run = engine._make_run_chunk_uncached(params)

    def traced(state, n, seg):
        saved = engine_table.table_forces
        engine_table.table_forces = ps.table_forces_jnp
        try:
            return run(state, n, seg)
        finally:
            engine_table.table_forces = saved

    return traced


def cmd_force(ns):
    for n in ns:
        p = scene(n, force_backend=ForceBackend.PALLAS, slot_rebuild_steps=4)
        sim = Simulation(p)
        p = sim.params
        steps = steps_for(n)
        runs = {
            "kernel": engine._make_run_chunk_uncached(p),
            "jnp": jnp_runner(p),
        }
        best = time_ab(runs, sim.state, steps)
        g = p.resolved_grid_dim()
        print(
            f"force n={n} G={g} spill={p.resolved_overflow_slots()} "
            f"steps={steps}: kernel {best['kernel'] / steps * 1e6:.2f} "
            f"us/step, jnp {best['jnp'] / steps * 1e6:.2f} us/step",
            flush=True,
        )


def cmd_crossover(ns):
    for n in ns:
        runs = {}
        state0 = None
        for b in (ForceBackend.DENSE, ForceBackend.PALLAS):
            sim = Simulation(scene(n, force_backend=b))
            runs[b.name] = engine._make_run_chunk_uncached(sim.params)
            state0 = sim.state
        best = time_ab(runs, state0, 2000)
        print(
            f"crossover n={n}: DENSE {best['DENSE'] / 2000 * 1e6:.2f} "
            f"us/step, PALLAS {best['PALLAS'] / 2000 * 1e6:.2f} us/step",
            flush=True,
        )


def table_of(n: int):
    p = scene(n, force_backend=ForceBackend.PALLAS)
    sim = Simulation(p)
    p = sim.params.validate()
    ts = engine_table.enter_table(p, sim.state)
    return p, ts.fields


def cmd_tiles(ns, reps: int = 200):
    default = ps.TILE, ps.NUM_WARPS
    for n in ns:
        p, fields = table_of(n)
        g = p.resolved_grid_dim()
        gg = g * g

        def timed(fn):
            @jax.jit
            def loop(f):
                def body(i, acc):
                    # a real dependence on the previous call keeps XLA from
                    # hoisting the kernel out of the loop
                    ff = dict(f, px=f["px"] + acc * 1e-30)
                    return acc + fn(ff)[0][0, 0]

                return jax.lax.fori_loop(0, reps, body, jnp.float32(0))

            out = fn(fields)
            jax.block_until_ready(loop(fields))
            t0 = time.perf_counter()
            jax.block_until_ready(loop(fields))
            return (time.perf_counter() - t0) / reps, out

        def fn_jnp(f):
            return ps.table_forces_jnp(p, f, g, g, gg, 0, gg)

        t_ref, ref = timed(jax.jit(fn_jnp))
        print(f"tiles n={n} G={g}: jnp {t_ref * 1e6:.2f} us", flush=True)
        for tile, warps in ((2, 1), (2, 2), (4, 2), (4, 4), (8, 4), (8, 8)):
            ps.TILE, ps.NUM_WARPS = tile, warps

            def fn_k(f):
                return ps.table_forces(p, f, g, g, gg, 0, gg)

            try:
                t_k, out = timed(jax.jit(fn_k))
            except Exception as e:  # report and go on to the next shape
                print(f"  TILE={tile} warps={warps}: FAILED {e!r:.300}")
                continue
            err = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(out, ref))
            print(
                f"  TILE={tile} warps={warps}: {t_k * 1e6:.2f} us "
                f"(max |kernel - jnp| {err:.3g})", flush=True,
            )
        ps.TILE, ps.NUM_WARPS = default


def device_events(trace_dir: str):
    """(name, start_ns, duration_ns, stats) of every event on a GPU plane
    of the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True), key=os.path.getmtime)[-1]
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for e in line.events:
                stats = {}
                for st in e.stats:
                    try:
                        k, v = st
                        stats[str(k)] = str(v)
                    except (TypeError, ValueError):
                        pass
                out.append((e.name, e.start_ns, e.duration_ns, stats))
    return out


def reduce_trace(events, steps: int) -> None:
    if not events:
        print("  no device events in the trace")
        return
    t0 = min(e[1] for e in events)
    t1 = max(e[1] + e[2] for e in events)
    spans = sorted((e[1], e[1] + e[2]) for e in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    window = t1 - t0
    print(f"  window {window / 1e3:.1f} us ({window / steps / 1e3:.2f} us/step)"
          f", device busy {busy / window:.3f}, {len(events)} events")
    by_scope = collections.Counter()
    by_name = collections.Counter()
    for name, _, dur, stats in events:
        blob = name + " " + " ".join(stats.values())
        scope = next((sc for sc in ("table_forces", "slot_rebuild")
                      if sc in blob), "other")
        by_scope[scope] += dur
        by_name[name[:80]] += dur
    total = sum(by_scope.values())
    for sc, dur in by_scope.most_common():
        print(f"  scope {sc}: {dur / steps / 1e3:.2f} us/step "
              f"({dur / total:.3f} of kernel time)")
    for name, dur in by_name.most_common(25):
        print(f"    {dur / steps / 1e3:8.2f} us/step  {name}")
    sample = next((e for e in events if "table_forces" in e[0]), events[0])
    print(f"  sample event stats: {sample[0]} {sample[3]}")


def cmd_trace(ns, steps: int = 400):
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "traces")
    for n in ns:
        p = scene(n, force_backend=ForceBackend.PALLAS, slot_rebuild_steps=4)
        sim = Simulation(p)
        run = engine._make_run_chunk_uncached(sim.params)
        state = jax.block_until_ready(run(sim.state, steps, True))
        state = jax.block_until_ready(run(state, steps, True))
        out = os.path.join(root, f"table_loop_{n}")
        with jax.profiler.trace(out):
            state = jax.block_until_ready(run(state, steps, True))
        print(f"trace n={n} G={sim.params.resolved_grid_dim()} "
              f"{steps} steps (K=4):", flush=True)
        reduce_trace(device_events(out), steps)


def main(argv):
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform}")
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f" | nvidia-smi: {smi}", flush=True)
    mode, ns = argv[0], [int(a) for a in argv[1:]]
    {"force": cmd_force, "crossover": cmd_crossover, "tiles": cmd_tiles,
     "trace": cmd_trace}[mode](ns)


if __name__ == "__main__":
    main(sys.argv[1:])
