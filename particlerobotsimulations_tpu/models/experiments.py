"""Canned paper experiments.

The Nature 2019 paper's headline studies, reproduced as Monte-Carlo sweep
harnesses over the device mesh (reference scenarios: examples/*.cfg; the
reference itself runs one seed per process and leaves aggregation to the
user).  Each experiment returns plain numpy results ready for plotting or
CSV export.

* phototaxis_speed      — centroid approach speed toward the light
* dead_cell_robustness  — locomotion vs fraction of dead (non-actuating)
                          bots, the paper's robustness result
                          (examples/example_dead_cells.cfg)
* payload_transport     — object displacement with the swarm
                          (examples/example_object_transport.cfg)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import SimParams
from ..parallel.sweep import run_sweep, sweep_summary


def phototaxis_speed(
    params: SimParams,
    seeds: Sequence[int],
    sim_seconds: float,
    mesh=None,
    record_every_steps: int | None = None,
):
    """Mean/std distance-to-light trajectory plus approach speed (units/s)."""
    n_steps = int(round(sim_seconds / params.timestep))
    record = record_every_steps or params.dump_steps
    _, cents = run_sweep(params, seeds, n_steps, mesh=mesh, record_every=record)
    s = sweep_summary(cents, params)
    d = s["distance_mean"]
    t = np.arange(len(d)) * record * params.timestep
    speed = (d[0] - d[-1]) / max(t[-1], 1e-9)
    return {
        "time_s": t,
        "distance_mean": d,
        "distance_std": s["distance_std"],
        "approach_speed": float(speed),
        "centroids": cents,
    }


def dead_cell_robustness(
    base: SimParams,
    dead_fractions: Sequence[float],
    seeds: Sequence[int],
    sim_seconds: float,
    mesh=None,
):
    """Approach speed vs dead-cell fraction (paper robustness experiment).

    Each fraction is a separate compile (n_dead is static); seeds within a
    fraction run as one sharded batch.
    """
    results = {}
    for frac in dead_fractions:
        n_dead = int(round(frac * base.n_cells))
        params = base.replace(n_dead=n_dead, time_to_dead=0.0)
        results[frac] = phototaxis_speed(params, seeds, sim_seconds, mesh=mesh)
    return {
        "fractions": list(dead_fractions),
        "approach_speed": [results[f]["approach_speed"] for f in dead_fractions],
        "per_fraction": results,
    }


def gap_transit(
    params: SimParams,
    seeds: Sequence[int],
    sim_seconds: float,
    mesh=None,
):
    """Wall-gap traversal (examples/example_gap.cfg): fraction of the swarm
    past the wall plane at the end, per seed, plus centroid trajectories."""
    import jax

    if not params.rect_obstacles:
        raise ValueError("gap_transit expects rectangular wall obstacles")
    wall_x = min(x1 for (x1, _x2, _y1, _y2) in params.rect_obstacles)
    n_steps = int(round(sim_seconds / params.timestep))
    state, cents = run_sweep(
        params, seeds, n_steps, mesh=mesh, record_every=params.dump_steps
    )
    pos = np.asarray(jax.device_get(state.pos[:, : params.n_cells, :]))
    frac_past = (pos[..., 0] < wall_x).mean(axis=1)  # (n_scenes,)
    s = sweep_summary(cents, params)
    return {
        "centroids": cents,
        "wall_x": float(wall_x),
        "frac_past_wall": frac_past,
        "frac_past_wall_mean": float(frac_past.mean()),
        "distance_mean": s["distance_mean"],
        "distance_std": s["distance_std"],
    }


def payload_transport(
    params: SimParams,
    seeds: Sequence[int],
    sim_seconds: float,
    mesh=None,
):
    """Payload x-displacement toward the light (n_dead == -1 scenarios)."""
    if not params.has_payload:
        raise ValueError("payload_transport requires n_dead == -1")
    import jax

    from ..parallel.sweep import make_batch_state

    start = np.asarray(
        jax.device_get(
            make_batch_state(params, seeds).pos[:, params.n_cells - 1, :]
        )
    )
    n_steps = int(round(sim_seconds / params.timestep))
    state, cents = run_sweep(
        params, seeds, n_steps, mesh=mesh, record_every=params.dump_steps
    )
    payload_pos = np.asarray(
        jax.device_get(state.pos[:, params.n_cells - 1, :])
    )  # (n_scenes, 2)
    disp = payload_pos - start
    return {
        "centroids": cents,
        "payload_start": start,
        "payload_final": payload_pos,
        "payload_displacement": disp,
        "payload_mean_dx": float(disp[:, 0].mean()),
    }
