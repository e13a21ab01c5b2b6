"""Smoke run of the simulator on one NVIDIA GPU: the main path end to end,
every kernel compiled for the card, each checked against the plain
reference.

    python chip_smoke.py               # one card: phases a-h
    python chip_smoke.py --four-cards  # the multi-card phase only (4 GPUs)

Phases (one line each):
  a  device: JAX's devices and ``nvidia-smi`` name / power limit; anything
     but a GPU exits non-zero before the simulator is imported
  b  compile: the 10k-bot HEX table-loop chunk (bench.py's scene), with
     ``compiled.memory_analysis()``
  c  force check: one 10k-bot state, the table-loop collide pass (Triton
     kernel) against ``dense_collide``, and the kernel against its jnp twin
  d  simulation: ``Simulation.run`` at 10k bots over three dump intervals
     (18,000 steps: rebuilds, phase gates, the adaptive K=4 -> 8 cadence)
  e  CLI: ``simulate`` on examples/example_gap.cfg (1000 bots) and
     examples/example.cfg (300 bots), max_time cut to 600 s
  f  spill: 131,072 bots for 400 steps with the spill slots on
  g  gradient: models/optimize.py through PALLAS against DENSE, 1000 bots,
     20-step horizon
  h  card-marked tests (tests/test_gpu.py), in this process

Everything runs in this one process.  It exits non-zero if any phase
failed; only then is the last line not the JSON result line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "artifacts", "smoke")

# bench.py's scene: 10k bots, HEX blob, phototaxis toward (-20, 0)
SCENE = dict(n_cells=10_000, n_dead=0, seed=7, light_x=-20.0, light_y=0.0)
SIM_SECONDS = 180.0     # phase d: three 60 s dump intervals
CLI_SECONDS = 600       # phase e
N_SPILL = 131_072       # phase f: past the 100k auto-spill threshold
N_GRAD = 1000           # phase g
N_SHARDED = 400_000     # four-card phase


def result_line(devices) -> str:
    """The last line of a successful run."""
    d = devices[0]
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": d.platform,
                "kind": d.device_kind,
                "count": len(devices),
            },
        }
    )


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def close(name, got, want, atol, rtol):
    """Max |got - want| and whether every element is within
    ``atol + rtol * |want|``."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    ok = bool((err <= atol + rtol * np.abs(want)).all())
    return f"{name} max|d|={err.max():.3g} (atol {atol:g}, rtol {rtol:g})", ok


def csv_rows(path: str):
    """(rows, columns) floats of a simulation CSV (two header lines; rows
    end with a comma, as the reference writes them)."""
    import numpy as np

    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()[2:]
    return np.array(
        [[float(v) for v in ln.split(",") if v.strip()] for ln in lines]
    )


def scene_params(**kw):
    from particlerobotsimulations_tpu import Config, SimParams

    return SimParams(config=Config.HEX, **{**SCENE, **kw})


def jittered(state, scale: float, vel_std: float = 0.0):
    """Break the HEX lattice's exact tangencies (gap == 0 sits on the
    overlap/magnet branch edge, where two compiled programs may disagree
    by a whole magnet force) and optionally give the bots velocities."""
    import jax

    key = jax.random.key(11)
    pos = state.pos + jax.random.uniform(
        key, state.pos.shape, minval=-scale, maxval=scale
    )
    vel = state.vel
    if vel_std:
        vel = vel_std * jax.random.normal(jax.random.fold_in(key, 1),
                                          state.vel.shape)
    return state._replace(pos=pos, vel=vel)


# ----------------------------------------------------------------- phases


def phase_b():
    from particlerobotsimulations_tpu import Simulation
    from particlerobotsimulations_tpu.engine_table import make_run_chunk_table

    sim = Simulation(scene_params())
    p = sim.params.replace(slot_rebuild_steps=4)
    run = make_run_chunk_table(p)
    t0 = time.perf_counter()
    compiled = run.lower(sim.state, 2000, True).compile()
    dt = time.perf_counter() - t0
    say("b", f"compiled 10k HEX table-loop chunk (2000 steps, K=4, "
             f"G={p.resolved_grid_dim()}) in {dt:.1f} s; "
             f"memory_analysis: {compiled.memory_analysis()}")
    return True


def phase_c():
    import jax
    import jax.numpy as jnp

    from particlerobotsimulations_tpu import Simulation
    from particlerobotsimulations_tpu.engine_table import enter_table
    from particlerobotsimulations_tpu.ops import pallas_stencil as ps
    from particlerobotsimulations_tpu.ops.forces import dense_collide
    from particlerobotsimulations_tpu.state import active_mask, payload_mask

    sim = Simulation(scene_params())
    p = sim.params.validate()
    st = jittered(sim.state, 2e-3, vel_std=0.05)
    n_pad = st.pos.shape[0]
    mask = active_mask(p, n_pad)
    payload = payload_mask(p, n_pad)
    args = (st.pos, st.vel, st.rad, mask, payload)
    got = jax.jit(
        lambda *a: ps.pallas_stencil_collide(p, *a, p.timestep)
    )(*args)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda *a: dense_collide(p, *a, p.timestep))(*args)
    n = p.n_cells
    # tolerance: float32 reassociation of the 9-cell sums (the kernel sums
    # per neighbour cell, DENSE over all bots) and the kernel's rsqrt form
    # of the pair distance — tens of ulp on velocities of O(0.1-1)
    lines, ok = [], True
    for name, a, b, atol, rtol in (
        ("vel", got[0][:n], want[0][:n], 1e-5, 1e-5),
        ("|fa|", got[1][:n], want[1][:n], 2e-4, 1e-4),
        ("|fr|", got[2][:n], want[2][:n], 2e-4, 1e-4),
    ):
        line, good = close(name, a, b, atol, rtol)
        lines.append(line)
        ok &= good
    say("c", "kernel collide vs dense_collide at 10k: " + "; ".join(lines))

    fields = enter_table(p, st).fields
    g = p.resolved_grid_dim()
    gg = g * g
    k = jax.jit(lambda f: ps.table_forces(p, f, g, g, gg, 0, gg))(fields)
    j = jax.jit(lambda f: ps.table_forces_jnp(p, f, g, g, gg, 0, gg))(fields)
    lines = []
    for name, a, b in zip(("fx", "fy", "|fa|", "|fr|"), k, j):
        line, good = close(name, a, b, 1e-4, 1e-5)
        lines.append(line)
        ok &= good
    ok &= float(jnp.max(k[3])) > 0
    say("c", "Triton kernel vs jnp twin on the 10k table: " + "; ".join(lines))
    return ok


def phase_d():
    import numpy as np

    from particlerobotsimulations_tpu import Simulation

    os.makedirs(OUT, exist_ok=True)
    sim = Simulation(scene_params())
    p = sim.params
    light = np.array([p.light_x, p.light_y])
    d0 = float(np.linalg.norm(sim.centroid() - light))
    t0 = time.perf_counter()
    sim.run(max_time=SIM_SECONDS, csv_path=os.path.join(OUT, "sim.csv"),
            echo=False)
    wall = time.perf_counter() - t0
    h = sim.health()
    d1 = float(np.linalg.norm(sim.centroid() - light))
    live = getattr(sim._run_chunk, "live", {})
    say("d", f"Simulation.run {p.n_cells} bots, {int(sim.state.step)} steps in "
             f"{wall:.1f} s wall (compiles included): finite={h['finite']} "
             f"cell_overflow={h['cell_overflow']} distance to light "
             f"{d0:.4f} -> {d1:.4f}; rebuild cadence now K={live.get('k')}"
             f" (last probe {getattr(sim._run_chunk, 'last_probe', None)})")
    want_steps = round(SIM_SECONDS / p.timestep)
    return (h["finite"] and h["cell_overflow"] == 0 and d1 < d0
            and int(sim.state.step) == want_steps)


def phase_e():
    import numpy as np

    from particlerobotsimulations_tpu import cli, load_cfg

    os.makedirs(OUT, exist_ok=True)
    ok = True
    for cfg in ("example_gap.cfg", "example.cfg"):
        path = os.path.join(ROOT, "examples", cfg)
        csv = os.path.join(OUT, cfg.replace(".cfg", ".csv"))
        backend = load_cfg(path).validate().resolved_backend().name
        t0 = time.perf_counter()
        rc = cli.main(["simulate", path, "--max-time", str(CLI_SECONDS),
                       "--quiet", "--csv", csv])
        wall = time.perf_counter() - t0
        rows = csv_rows(csv)
        want_rows = CLI_SECONDS // 60 + 1  # t = 0 and every 60 s dump
        good = (rc == 0 and rows.shape[0] == want_rows
                and np.isfinite(rows).all())
        say("e", f"cli simulate {cfg} (AUTO -> {backend}): rc={rc}, "
                 f"{rows.shape[0]} CSV rows to t={rows[-1, 0]:g} s, distance"
                 f" to light {rows[0, -1]:.4f} -> {rows[-1, -1]:.4f}, finite="
                 f"{bool(np.isfinite(rows).all())}, {wall:.1f} s wall")
        ok &= bool(good)
    return ok


def phase_f():
    import jax
    import numpy as np

    from particlerobotsimulations_tpu import Simulation
    from particlerobotsimulations_tpu.engine_table import _geometry, enter_table

    sim = Simulation(scene_params(n_cells=N_SPILL, world_half=0.0))
    p = sim.params.validate()
    g, cap, cs = p.resolved_grid_dim(), p.cell_capacity, p.storage_capacity()
    t0 = time.perf_counter()
    sim.step_chunk(400, start_step=0)
    pos = np.asarray(jax.device_get(sim.state.pos))[: p.n_cells]
    wall = time.perf_counter() - t0
    total = _geometry(p)[0]
    val = np.asarray(enter_table(p, sim.state).fields["val"])
    spilled = int((val[g * g * cap : total] > 0.5).sum())
    finite = bool(np.isfinite(pos).all())
    say("f", f"{p.n_cells} bots, 400 steps, G={g}, slots {cap}+{cs - cap} "
             f"spill: finite={finite}, bots in spill slots at exit="
             f"{spilled}, {wall:.1f} s wall (compiles included)")
    return finite and cs > cap and int(sim.state.step) == 400


def phase_g():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from particlerobotsimulations_tpu import ForceBackend, Simulation
    from particlerobotsimulations_tpu.models.optimize import make_phase_rollout

    base = scene_params(n_cells=N_GRAD, light_x=-5.0)
    st = Simulation(base.replace(force_backend=ForceBackend.DENSE)).state
    # spread the HEX lattice 6% about its centroid so that most neighbour
    # gaps (~0.009) sit in the smooth inverse-square tail of the magnet law
    # and the gradient is large against the absolute tolerance below
    n = base.n_cells
    c = st.pos[:n].mean(axis=0)
    active = (jnp.arange(st.pos.shape[0]) < n)[:, None]
    st = st._replace(pos=jnp.where(active, c + 1.06 * (st.pos - c), st.pos))
    phase0 = 0.1 * jax.random.normal(jax.random.key(0), st.phase.shape)
    out = {}
    for b in (ForceBackend.PALLAS, ForceBackend.DENSE):
        roll = make_phase_rollout(base.replace(force_backend=b), 20)
        v, gr = jax.jit(jax.value_and_grad(roll))(phase0, st)
        out[b.name] = (float(v), np.asarray(gr)[:n])
    (vp, gp), (vd, gd) = out["PALLAS"], out["DENSE"]
    rel = float(np.linalg.norm(gp - gd) / np.linalg.norm(gd))
    cos = float(gp @ gd / (np.linalg.norm(gp) * np.linalg.norm(gd)))
    within = float((np.abs(gp - gd) <= 2e-4 + 2e-2 * np.abs(gd)).mean())
    # tolerance: the kernel's forward rounds differently from DENSE's (its
    # rsqrt-first pair distance, per-cell sums).  A bot sitting on a branch
    # edge — contact onset, a magnet-law breakpoint, the radius
    # controller's force limit — can then take the other branch and the
    # other one-sided derivative, so a few bots' entries differ wholesale
    # while the rest agree to tests/test_optimize.py's tolerance (rtol
    # 2e-2, atol 2e-4).  Required: the rollout values agree, 98% of the
    # bots' entries are within that tolerance, and the gradients point the
    # same way (cosine >= 0.98).
    ok = (np.isfinite(gp).all() and abs(vp - vd) <= 1e-4 * abs(vd) + 1e-5
          and within >= 0.98 and cos >= 0.98)
    say("g", f"d centroid_x / d phase over 20 steps, {n} bots: PALLAS vs "
             f"DENSE value {vp:.6f} vs {vd:.6f}; gradient: {within:.3f} of "
             f"bots within rtol 2e-2 / atol 2e-4 (need 0.98), cosine "
             f"{cos:.5f} (need 0.98), rel L2 {rel:.3g}, |grad| "
             f"{np.linalg.norm(gd):.3g}")
    return bool(ok)


def phase_h():
    import pytest

    class Count:
        def __init__(self):
            self.outcomes = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes[report.outcome] = (
                    self.outcomes.get(report.outcome, 0) + 1
                )

    count = Count()
    rc = pytest.main(
        [os.path.join(ROOT, "tests", "test_gpu.py"), "-m", "gpu",
         "--noconftest", "-p", "no:cacheprovider", "-q",
         "--rootdir", ROOT],
        plugins=[count],
    )
    say("h", f"card-marked tests: exit {int(rc)}, outcomes {count.outcomes}")
    return (int(rc) == 0 and count.outcomes.get("passed", 0) > 0
            and set(count.outcomes) == {"passed"})


def phase_four_cards():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from particlerobotsimulations_tpu import Simulation
    from particlerobotsimulations_tpu.engine_table import make_run_chunk_table
    from particlerobotsimulations_tpu.parallel.spatial_table import (
        make_sharded_table_run,
    )
    from particlerobotsimulations_tpu.parallel.sweep import default_mesh, run_sweep

    devs = jax.devices()
    ok = len(devs) == 4
    say("4", f"{len(devs)} devices: {[d.device_kind for d in devs]}")

    # dp sweep: 4 scenes x 10k bots over the mesh vs the same seeds on one
    # card (tolerance: the two programs compile the same per-scene math
    # for different batch shapes; 1-ulp differences grow chaotically over
    # 400 contact-dominated steps, the centroid averages them away)
    p = scene_params()
    seeds = [0, 1, 2, 3]
    t0 = time.perf_counter()
    fin4, c4 = run_sweep(p, seeds, 400, mesh=default_mesh(), record_every=200)
    jax.block_until_ready(fin4)
    t4 = time.perf_counter() - t0
    spans = len(fin4.pos.sharding.device_set)
    t0 = time.perf_counter()
    fin1, c1 = run_sweep(p, seeds, 400, mesh=None, record_every=200)
    jax.block_until_ready(fin1)
    t1 = time.perf_counter() - t0
    d = float(np.abs(c4 - c1).max())
    good = spans == 4 and d <= 1e-4 and np.isfinite(c4).all()
    say("4", f"dp sweep 4 x {p.n_cells} bots, 400 steps: output spans {spans} "
             f"devices; max |centroid(4 cards) - centroid(1 card)| = {d:.3g}"
             f" (tolerance 1e-4); wall {t4:.1f} s vs {t1:.1f} s "
             f"(compiles included)")
    ok &= bool(good)

    # sharded table loop: one 400k-bot scene, grid rows over 4 cards, vs
    # the unsharded table loop on one card (phase noise off: the sharded
    # loop draws it from per-shard streams)
    mesh = Mesh(np.array(devs), ("bots",))
    base = scene_params(n_cells=N_SHARDED, world_half=0.0, phase_std=0.0,
                        slot_rebuild_steps=4)
    sim = Simulation(base)
    run_sh, pr = make_sharded_table_run(sim.params, mesh)
    run_1 = make_run_chunk_table(pr)
    st0 = jittered(sim.state, 1e-3)
    n = pr.n_cells
    out = {}
    for name, run in (("sharded", run_sh), ("one card", run_1)):
        st = jax.tree.map(jnp.copy, st0)
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(st, 50))
        out[name] = (res, time.perf_counter() - t0)
    sh, one = out["sharded"][0], out["one card"][0]
    spans = len(sh.pos.sharding.device_set)
    a = np.asarray(sh.pos)[:n]
    b = np.asarray(one.pos)[:n]
    dpos = float(np.abs(a - b).max())
    dcen = float(np.abs(a.mean(0) - b.mean(0)).max())
    # tolerance: both run the same kernel on the same slot layout; the
    # rest compiles differently (fusion, FMA), and 1-ulp differences grow
    # chaotically over 50 contact-dominated steps
    good = (spans == 4 and np.isfinite(a).all() and dpos <= 1e-2
            and dcen <= 1e-4)
    say("4", f"sharded table loop {n} bots (G={pr.resolved_grid_dim()}) "
             f"over {spans} devices vs one card, 50 steps: max|dpos| = "
             f"{dpos:.3g} (tolerance 1e-2), |d centroid| = {dcen:.3g} "
             f"(tolerance 1e-4); wall {out['sharded'][1]:.1f} s vs "
             f"{out['one card'][1]:.1f} s (compiles included)")
    return ok and bool(good)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    say("a", f"jax.devices(): {devices}")
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX runs on {devices[0].platform}", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)  # name, power limit

    sys.path.insert(0, ROOT)
    from particlerobotsimulations_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    say("a", f"compile cache: {enable_compile_cache()}")
    if args.four_cards:
        phases = [("4", phase_four_cards)]
    else:
        phases = [("b", phase_b), ("c", phase_c), ("d", phase_d),
                  ("e", phase_e), ("f", phase_f), ("g", phase_g),
                  ("h", phase_h)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            good = fn()
        except Exception as e:  # recorded as a failure; the run exits 1
            import traceback

            traceback.print_exc()
            say(name, f"FAILED with {type(e).__name__}: {e}")
            good = False
        say(name, f"{'ok' if good else 'FAILED'} ({time.perf_counter() - t0:.1f} s)")
        if not good:
            failed.append(name)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
