"""Throughput / phase profiling helpers.

The reference has no timing code at all (SURVEY.md §5 — the vendored
StopWatch helpers are never used).  This module gives the framework native
observability: steps/sec for a scenario and a per-stage breakdown of the
step pipeline.  Timings end in ``jax.block_until_ready``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import numpy as np

from ..config import SimParams
from ..engine import make_run_chunk
from ..sim import Simulation


@dataclass
class Throughput:
    steps_per_sec: float
    particle_steps_per_sec: float
    ms_per_step: float
    n_bots: int
    backend: str


def measure_throughput(
    params: SimParams, n_steps: int = 1000, reps: int = 3
) -> Throughput:
    """Compile + time ``n_steps`` fused physics steps; returns best of reps."""
    sim = Simulation(params)
    # sim.params carries the Nx == 0 -> config_size_x resolution; compiling
    # from the raw params would time a different actuation wave.  Every rep
    # enters at a multiple of n_steps, so when that lands on the gate-segment
    # boundary the run takes the same amortized-cond fast path as the
    # official bench (seg_aligned) instead of the traced-cond slow path.
    params = sim.params
    seg = sim._gate_seg
    run = make_run_chunk(params)
    done = 0

    def chunk(state):
        nonlocal done
        aligned = seg > 0 and done % seg == 0
        state = run(state, n_steps, aligned)
        done += n_steps
        return state

    state = jax.block_until_ready(chunk(sim.state))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(chunk(state))
        best = min(best, time.perf_counter() - t0)
    pos = np.asarray(jax.device_get(state.pos[: params.n_cells]))
    if not np.isfinite(pos).all():
        raise RuntimeError("simulation diverged during profiling")
    sps = n_steps / best
    return Throughput(
        steps_per_sec=sps,
        particle_steps_per_sec=sps * params.n_cells,
        ms_per_step=1e3 / sps,
        n_bots=params.n_cells,
        backend=params.resolved_backend().name,
    )


def scaling_report(ns=(1000, 4000, 10000, 20000), **param_overrides):
    """Print a throughput table over swarm sizes."""
    from ..config import Config

    rows = []
    for n in ns:
        params = SimParams(
            n_cells=n, n_dead=0, config=Config.HEX, light_x=-20.0,
            **param_overrides,
        )
        t = measure_throughput(params)
        rows.append(t)
        print(
            f"n={t.n_bots:>7}  {t.ms_per_step:8.3f} ms/step  "
            f"{t.particle_steps_per_sec / 1e6:8.2f} M particle-steps/s  "
            f"[{t.backend}]"
        )
    return rows
