"""Monte-Carlo sweeps: vmap over scenes, sharded over a device mesh.

The reference is strictly single-GPU/single-scene
(/root/reference/particlebot_cuda.cu:29-47); its parallelism story is one
CUDA thread per bot.  The scale-out axis here is the *scene batch*: the
paper workflow (robustness curves vs dead-cell fraction, seed sweeps) runs
many seeds of the same scenario, which is embarrassingly parallel — one
scene fits one card; we ``vmap`` scenes on a card and lay the batch over
the mesh's data axis so XLA keeps every card busy with zero per-step
communication.  Cross-scene statistics (mean/std centroid trajectories)
are reduced on the host at the end.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimParams
from ..engine import make_run_chunk, make_run_chunk_batched
from ..models.placement import initial_state_arrays
from ..state import SimState, make_state


def make_batch_state(params: SimParams, seeds: Sequence[int]) -> SimState:
    """Stack fresh scenes (one per seed) along a leading batch axis.

    Placement runs on host per seed (inherently sequential accretion); the
    stacked pytree is then a single device array per field.
    """
    states = []
    for s in seeds:
        p_eff, pos, vel, rad, phase, dead = initial_state_arrays(
            params.replace(seed=int(s))
        )
        states.append(make_state(p_eff, pos, vel, rad, phase, dead, seed=int(s)))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def shard_batch(state: SimState, mesh: Mesh, axis: str = "data") -> SimState:
    """Lay the scene batch over the mesh's data axis; per-scene arrays are
    replicated-free (fully sharded on the leading dim)."""
    # every leaf — including step counters and keys — is per-scene along the
    # leading batch dim after make_batch_state, so all leaves shard on it
    # (the lockstep gating in engine.make_run_chunk_batched relies on the
    # per-scene counters advancing together)
    batch_spec = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, batch_spec), state)


def default_mesh(axis: str = "data") -> Mesh:
    devs = np.array(jax.devices())
    return Mesh(devs.reshape(-1), (axis,))


def make_run_chunk_sharded(params: SimParams, mesh: Mesh, axis: str = "data"):
    """The batched chunk runner laid over ``mesh``: each device advances
    its own scenes (``shard_map`` over the scene axis), so the step needs
    no collective and every kernel sees device-local operands.  Takes and
    returns a batch sharded as :func:`shard_batch` lays it out."""
    run = make_run_chunk_batched(params)

    @functools.partial(jax.jit, static_argnums=(1, 2), donate_argnums=0)
    def run_chunk(state: SimState, n_steps: int, seg_aligned: bool = False):
        return shard_map(
            lambda s: run(s, n_steps, seg_aligned),
            mesh=mesh,
            in_specs=P(axis),
            out_specs=P(axis),
            check_vma=False,
        )(state)

    return run_chunk


def choose_sweep_strategy(
    params: SimParams, n_scenes: int, mesh: Mesh | None
) -> str:
    """Pick the sweep execution strategy: ``"sequential"`` (single-scene
    chunk runner looped over seeds) or ``"batched"`` (scenes vmapped into
    one stacked pytree).

    With a mesh the batch IS the parallelism axis — always batched.  One
    scene has nothing to batch — sequential.  Otherwise batched: one
    dispatch advances every scene.  The packed scene-tiling strategy
    (parallel/packed.py) is never chosen automatically; ask for it with
    ``strategy="packed"``.  The env knob ``PBOT_SWEEP_STRATEGY`` forces a
    strategy for A/B runs.
    """
    del params  # the policy does not depend on the scenario
    forced = os.environ.get("PBOT_SWEEP_STRATEGY", "")
    if forced in ("sequential", "batched", "packed"):
        if mesh is not None and forced != "batched":
            raise ValueError(
                f"PBOT_SWEEP_STRATEGY={forced} is incompatible with a "
                "device mesh (the scene batch is the sharding axis)"
            )
        return forced
    if mesh is not None:
        return "batched"
    if n_scenes <= 1:
        return "sequential"
    return "batched"


def _run_sweep_sequential(
    params: SimParams,
    seeds: Sequence[int],
    n_steps: int,
    record_every: int,
    seg: int,
):
    """Loop scenes through the SINGLE-scene chunk runner (compiled once,
    reused across seeds — shapes are seed-independent)."""
    run = make_run_chunk(params)
    n = params.n_cells
    finals = []
    all_records = []
    for s in seeds:
        p_eff, pos, vel, rad, phase, dead = initial_state_arrays(
            params.replace(seed=int(s))
        )
        state = make_state(p_eff, pos, vel, rad, phase, dead, seed=int(s))
        # centroids stay ON DEVICE until the end: a per-chunk device_get
        # would serialize the chunk pipeline; deferred fetches let chunks
        # queue back-to-back
        recs = [jnp.mean(state.pos[:n, :], axis=0)]
        done = 0
        while done < n_steps:
            chunk = min(record_every, n_steps - done)
            state = run(state, chunk, seg > 0 and done % seg == 0)
            done += chunk
            recs.append(jnp.mean(state.pos[:n, :], axis=0))
        finals.append(state)
        all_records.append(recs)
    final = jax.tree.map(lambda *xs: jnp.stack(xs), *finals)
    # (n_records, n_scenes, 2) — same layout as the batched recorder; ONE
    # device_get on the whole record pytree is the only host sync of the
    # sweep
    return final, np.asarray(jax.device_get(all_records)).transpose(1, 0, 2)


def run_sweep(
    params: SimParams,
    seeds: Sequence[int],
    n_steps: int,
    mesh: Mesh | None = None,
    record_every: int | None = None,
    strategy: str | None = None,
):
    """Run ``len(seeds)`` scenes for ``n_steps``; returns
    (final_state, centroid_trajectories (n_records, n_scenes, 2)).

    ``record_every`` defaults to the scenario dump interval.  With a mesh,
    scenes are sharded across devices and each device advances its own
    (:func:`make_run_chunk_sharded`) — no per-step collectives.  Without one, the execution
    strategy (sequential single-scene chunks vs on-card vmap batch) is
    picked by ``choose_sweep_strategy``.
    """
    from ..config import ForceBackend
    from ..engine_table import gate_seg
    from ..models.placement import resolve_params

    # Nx == 0 -> config_size_x, exactly as Simulation resolves it — the
    # compiled actuation wave period must match single-scene runs
    params = resolve_params(params.validate())
    record_every = record_every or params.dump_steps
    seg = (
        gate_seg(params)
        if params.resolved_backend() == ForceBackend.PALLAS
        else 0
    )
    if strategy is None:
        strategy = choose_sweep_strategy(params, len(seeds), mesh)
    elif strategy not in ("sequential", "batched", "packed"):
        raise ValueError(f"unknown sweep strategy: {strategy!r}")
    elif strategy != "batched" and mesh is not None:
        # same incompatibility the env-knob path rejects: the scene batch
        # IS the sharding axis, so a sequential/packed run would silently
        # drop the requested multi-device sharding
        raise ValueError(
            f"strategy={strategy!r} is incompatible with a device mesh "
            "(the scene batch is the sharding axis)"
        )
    if strategy == "packed":
        from .packed import run_sweep_packed

        return run_sweep_packed(params, seeds, n_steps, record_every)
    if strategy == "sequential":
        return _run_sweep_sequential(params, seeds, n_steps, record_every, seg)

    state = make_batch_state(params, seeds)
    if mesh is not None:
        state = shard_batch(state, mesh)
        run = make_run_chunk_sharded(params, mesh)
    else:
        run = make_run_chunk_batched(params)

    n = params.n_cells
    records = []

    def centroid(s: SimState):
        return jnp.mean(s.pos[:, :n, :], axis=1)

    done = 0  # scenes start at step 0 and advance in lockstep
    # deferred host fetches: see _run_sweep_sequential
    records.append(centroid(state))
    while done < n_steps:
        chunk = min(record_every, n_steps - done)
        state = run(state, chunk, seg > 0 and done % seg == 0)
        done += chunk
        records.append(centroid(state))
    return state, np.stack(jax.device_get(records))


def sweep_summary(centroids: np.ndarray, params: SimParams):
    """Aggregate a sweep into mean/std distance-to-light trajectories."""
    light = np.array([params.light_x, params.light_y], dtype=np.float64)
    d = np.linalg.norm(centroids - light, axis=-1)  # (n_records, n_scenes)
    return {
        "distance_mean": d.mean(axis=1),
        "distance_std": d.std(axis=1),
        "centroid_mean": centroids.mean(axis=1),
    }
