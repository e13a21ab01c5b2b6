"""Spatial (bot-axis) sharding of one giant scene across a mesh.

The stretch design from SURVEY.md §2: when a single swarm outgrows one chip,
shard the *bot* axis.  Forces need every bot's position, so each device
all-gathers the (small: N*5 floats) kinematic state and computes
forces for its own bot shard — the tensor-parallel analogue.  Reductions the
step needs globally (min distance to light for the phase law, the swarm
centroid) are ``psum``-style collectives.

Implemented with ``shard_map`` so the collectives are explicit and the
per-device working set stays O(N/D * N) for the dense backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import Control, SimParams, padded_n
from ..ops.actuation import update_radius
from ..ops.forces import (
    attraction_scale,
    friction_velocity_update,
    obstacle_forces,
    pair_forces,
)
from ..ops.integrate import integrate
from ..ops.phase import light_distance, update_phase
from ..state import SimState


def make_sharded_step(
    params: SimParams,
    mesh: Mesh,
    axis: str = "bots",
    batch_axis: str | None = None,
):
    """One physics step with bots sharded over ``axis``.

    State layout inside: pos/vel/rad/... carry the bot dimension sharded;
    step/key/centroid_ring are replicated.  The collide pass all-gathers
    positions (the only cross-device traffic) and computes the local rows of
    the pair interaction.

    With ``batch_axis`` set (composed dp x tp), the state carries a leading
    scene-batch dimension sharded over ``batch_axis`` and each scene's bot
    axis is sharded over ``axis`` — the mesh must have both axes.
    """
    params = params.validate()
    dt = params.timestep
    n_pad = padded_n(params)
    n_dev = mesh.shape[axis]
    if n_pad % n_dev:
        raise ValueError(f"padded bot count {n_pad} not divisible by mesh axis {n_dev}")
    f32 = jnp.float32

    bot_spec = P(axis)
    bot2_spec = P(axis, None)
    rep = P()

    state_specs = SimState(
        pos=bot2_spec,
        vel=bot2_spec,
        rad=bot_spec,
        phase=bot_spec,
        dead=bot_spec,
        abs_force_a=bot_spec,
        abs_force_r=bot_spec,
        step=rep,
        key=rep,
        centroid_ring=rep,
    )

    def local_masks(shard_size):
        dev = jax.lax.axis_index(axis)
        idx = dev * shard_size + jnp.arange(shard_size)
        mask = idx < params.n_cells
        payload = (
            (idx == params.n_cells - 1)
            if params.has_payload
            else jnp.zeros((shard_size,), bool)
        )
        return idx, mask, payload

    # use_cond: the single-scene path gates phase/cog work behind real
    # lax.conds (replicated predicates).  The composed dp x tp path vmaps
    # this body with per-scene predicates, where a cond decays to a select
    # (both branches run) AND trips a vma check inside shard_map — so the
    # vmapped variant keeps the plain where-selects instead.
    def make_step_local(use_cond: bool):
        return functools.partial(_step_local, use_cond=use_cond)

    def _step_local(state: SimState, use_cond: bool) -> SimState:
        shard = state.pos.shape[0]
        idx, mask, payload = local_masks(shard)
        time = state.step.astype(f32) * f32(dt)
        step_key = jax.random.fold_in(state.key, state.step)

        # dead-cell injection (particlebot.cpp:178-194): every shard draws
        # the same global scores from the replicated key, picks the global
        # n_dead smallest, and keeps its own slice — no communication needed
        dead = state.dead
        if params.n_dead > 0:
            def inject(d):
                gscores = jax.random.uniform(step_key, (n_pad,))
                gidx_all = jnp.arange(n_pad)
                gmask = gidx_all < params.n_cells
                gdead = jax.lax.all_gather(d, axis, tiled=True)
                gscores = jnp.where(gmask & ~gdead, gscores, jnp.inf)
                _, kill = jax.lax.top_k(-gscores, params.n_dead)
                killed = jnp.zeros((n_pad,), bool).at[kill].set(True)
                me = jax.lax.axis_index(axis)
                return d | jax.lax.dynamic_slice(killed, (me * shard,), (shard,))

            pred = state.step == params.dead_step
            if use_cond:
                dead = jax.lax.cond(pred, inject, lambda d: d, dead)
            else:
                # vmapped composed path: per-scene predicate decays a cond
                # to a select inside shard_map (vma error) — run the gather
                # unconditionally and select
                dead = jnp.where(pred, inject(dead), dead)
        state = state._replace(dead=dead)

        # --- phase (interval gated); min-dist is a cross-device min.
        #     FIXED_PHASE keeps scripted/learned offsets untouched, matching
        #     engine.make_step (particlebot.cpp:211 gates on LIGHT_WAVE) -----
        if params.control == Control.LIGHT_WAVE:
            # one shared phase law (ops/phase.update_phase) with the
            # cross-device pmin passed through its min_d hook; a real
            # lax.cond (replicated predicate) so the shadow raycast and the
            # noise draw only run on the 1/phase_update_steps gated steps —
            # mirroring engine.make_step, not a decayed select
            def do_phase(operand):
                pos_, phase_ = operand
                dist = light_distance(params, pos_)
                min_d = jax.lax.pmin(
                    jnp.min(jnp.where(mask, dist, jnp.inf)), axis_name=axis
                )
                noise_key = jax.random.fold_in(
                    jax.random.fold_in(step_key, 1), jax.lax.axis_index(axis)
                )
                return update_phase(
                    params, pos_, phase_, mask, noise_key, min_d=min_d
                )

            gate = state.step % params.phase_update_steps == 0
            operand = (state.pos, state.phase)
            if use_cond:
                phase = jax.lax.cond(gate, do_phase, lambda o: o[1], operand)
            else:
                phase = jnp.where(gate & mask, do_phase(operand), state.phase)
        else:
            phase = state.phase

        # --- radius / integrate (purely local) ---------------------------
        rad = update_radius(
            params, state.rad, phase, state.abs_force_a, state.abs_force_r,
            state.dead, mask, time, dt,
        )
        pos, vel = integrate(params, state.pos, state.vel, rad, dt)

        # --- collide: all-gather kinematics, compute local rows ----------
        all_pos = jax.lax.all_gather(pos, axis, tiled=True)      # (n_pad, 2)
        all_vel = jax.lax.all_gather(vel, axis, tiled=True)
        all_rad = jax.lax.all_gather(rad, axis, tiled=True)
        all_mask = jax.lax.all_gather(mask, axis, tiled=True)

        gidx = jnp.arange(n_pad)
        all_payload = (
            (gidx == params.n_cells - 1)
            if params.has_payload
            else jnp.zeros((n_pad,), bool)
        )

        diff = all_pos[None, :, :] - pos[:, None, :]
        rel_vel = all_vel[None, :, :] - vel[:, None, :]
        valid = mask[:, None] & all_mask[None, :] & (idx[:, None] != gidx[None, :])
        afac_i = attraction_scale(params, payload)
        afac_j = attraction_scale(params, all_payload)
        attraction_ij = f32(params.attraction) * afac_i[:, None] * afac_j[None, :]

        pf = pair_forces(
            params, diff, rel_vel, rad[:, None], all_rad[None, :],
            attraction_ij, valid,
        )
        force = jnp.sum(pf.force, axis=1)
        abs_a = jnp.sum(pf.mag_attract, axis=1)
        abs_r = jnp.sum(pf.mag_contact, axis=1)

        f_obs, m_obs = obstacle_forces(params, pos, vel, rad)
        force = force + f_obs
        abs_r = abs_r + m_obs

        new_vel = friction_velocity_update(params, vel, force, payload, dt)
        new_vel = jnp.where(mask[..., None], new_vel, 0.0)

        # --- centroid ring (psum over shards, replicated write) ----------
        # from PRE-integrate positions, like engine.make_step and the
        # reference (calcCOG before integrateSystem, particlebot.cpp:207/246)
        cog_gate = state.step % params.centroid_steps_interval == 0
        ring_idx = (
            state.step // params.centroid_steps_interval
        ) % params.centroid_steps

        def write_ring(ring):
            local_sum = jnp.sum(
                jnp.where(mask[:, None], state.pos, 0.0), axis=0
            )
            centroid = jax.lax.psum(local_sum, axis) / f32(params.n_cells)
            return jax.lax.dynamic_update_slice(
                ring, centroid[None, :], (ring_idx, 0)
            )

        if use_cond:
            ring = jax.lax.cond(
                cog_gate, write_ring, lambda r: r, state.centroid_ring
            )
        else:
            ring = jnp.where(
                cog_gate, write_ring(state.centroid_ring), state.centroid_ring
            )

        return SimState(
            pos=pos, vel=new_vel, rad=rad, phase=phase, dead=state.dead,
            abs_force_a=abs_a, abs_force_r=abs_r, step=state.step + 1,
            key=state.key, centroid_ring=ring,
        )

    if batch_axis is None:
        sharded = shard_map(
            make_step_local(use_cond=True),
            mesh=mesh,
            in_specs=(state_specs,),
            out_specs=state_specs,
        )
    else:
        # composed dp x tp: a leading scene-batch dim sharded over
        # ``batch_axis``; each scene's bot axis sharded over ``axis``.  The
        # local body vmaps the single-scene step over its batch shard — the
        # bot-axis collectives (all_gather/pmin/psum) ride inside the vmap.
        def prepend(spec: P) -> P:
            return P(batch_axis, *spec)

        state_specs = jax.tree.map(
            prepend, state_specs, is_leaf=lambda x: isinstance(x, P)
        )
        sharded = shard_map(
            jax.vmap(make_step_local(use_cond=False)),
            mesh=mesh,
            in_specs=(state_specs,),
            out_specs=state_specs,
        )

    @jax.jit
    def step(state: SimState) -> SimState:
        return sharded(state)

    return step, state_specs


def shard_state(
    state: SimState,
    mesh: Mesh,
    axis: str = "bots",
    batch_axis: str | None = None,
) -> SimState:
    """Place a SimState according to the sharded-step layout.

    With ``batch_axis`` (composed dp x tp), the state must carry a leading
    scene-batch dim (from ``sweep.make_batch_state``)."""
    specs = SimState(
        pos=P(axis, None), vel=P(axis, None), rad=P(axis), phase=P(axis),
        dead=P(axis), abs_force_a=P(axis), abs_force_r=P(axis),
        step=P(), key=P(), centroid_ring=P(),
    )
    if batch_axis is not None:
        specs = jax.tree.map(
            lambda s: P(batch_axis, *s), specs, is_leaf=lambda x: isinstance(x, P)
        )

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, state, specs)
