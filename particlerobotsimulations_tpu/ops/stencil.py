"""Stencil force backend: neighbor search as a dense 3x3 roll, zero gathers.

The cell-table backend (ops/grid.py) gathers ``(N, 9*C)`` candidates per
field.  This backend removes the gathers entirely — a dense-array
formulation of the reference's uniform-grid scan
(particlebot_kernel_impl.cuh:691-699):

1. scatter bot fields into a dense wrapped cell table ``(G, G, C)``
   (scatters are cheap: one argsort + rank computation),
2. the 3x3 neighborhood is then ``jnp.roll`` of the table along the grid
   axes — nine *contiguous* shifted views, no random access,
3. pair forces reduce over the candidate capacity axis as a fused
   elementwise chain ``(G, G, C, C) -> (G, G, C)``,
4. per-bot results come back through four tiny ``(N,)`` flat gathers.

Compute is O(G^2 * C^2 * 9): at G=64, C=16 that is 9.4M pair evaluations —
~6.5x the bot count's true pair work, traded for perfect vectorization.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SimParams
from .forces import (
    attraction_scale,
    friction_velocity_update,
    obstacle_forces,
    pair_forces,
)
from .grid import cell_ids, rank_cells


class SlotAssignment(NamedTuple):
    slot: jax.Array      # (n_pad,) int32 — flat table slot per bot (OOB = dropped)
    overflow: jax.Array  # () int32


def assign_slots(params: SimParams, pos: jax.Array, mask: jax.Array) -> SlotAssignment:
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    n = pos.shape[0]
    cid = cell_ids(params, pos, mask)          # padding -> g*g (out of range)
    order, scid, rank, in_range, overflow = rank_cells(cid, g, cap)
    keep = in_range & (rank < cap)
    slot_sorted = jnp.where(keep, scid * cap + rank, g * g * cap)
    # invert the sort: slot for bot order[k] is slot_sorted[k]
    slot = jnp.zeros((n,), jnp.int32).at[order].set(slot_sorted)
    return SlotAssignment(slot=slot, overflow=overflow)


def stencil_collide(
    params: SimParams,
    pos: jax.Array,        # (n_pad, 2)
    vel: jax.Array,        # (n_pad, 2)
    rad: jax.Array,        # (n_pad,)
    mask: jax.Array,       # (n_pad,) bool
    payload: jax.Array,    # (n_pad,) bool
    dt: float,
):
    """Collide pass in table space.  Same semantics as ``dense_collide``."""
    f32 = jnp.float32
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    n = pos.shape[0]
    slots = assign_slots(params, pos, mask)
    slot = slots.slot

    total = g * g * cap

    def scat(v, width=None):
        shape = (total,) if width is None else (total, width)
        return jnp.zeros(shape, v.dtype).at[slot].set(v, mode="drop")

    afac = attraction_scale(params, payload)
    tpos = scat(pos, 2).reshape(g, g, cap, 2)
    tvel = scat(vel, 2).reshape(g, g, cap, 2)
    trad = scat(rad).reshape(g, g, cap)
    tval = (
        jnp.zeros((total,), bool).at[slot].set(mask, mode="drop")
        .reshape(g, g, cap)
    )
    tafac = scat(afac).reshape(g, g, cap)

    force = jnp.zeros((g, g, cap, 2), f32)
    abs_a = jnp.zeros((g, g, cap), f32)
    abs_r = jnp.zeros((g, g, cap), f32)

    eye = jnp.eye(cap, dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                qpos, qvel, qrad, qval, qafac = tpos, tvel, trad, tval, tafac
            else:
                sh = (dy, dx)
                qpos = jnp.roll(tpos, sh, axis=(0, 1))
                qvel = jnp.roll(tvel, sh, axis=(0, 1))
                qrad = jnp.roll(trad, sh, axis=(0, 1))
                qval = jnp.roll(tval, sh, axis=(0, 1))
                qafac = jnp.roll(tafac, sh, axis=(0, 1))

            # pairs: slot c (mine) x slot k (theirs) -> (g, g, C, K)
            diff = qpos[:, :, None, :, :] - tpos[:, :, :, None, :]
            rel_vel = qvel[:, :, None, :, :] - tvel[:, :, :, None, :]
            valid = tval[:, :, :, None] & qval[:, :, None, :]
            if dy == 0 and dx == 0:
                valid = valid & ~eye[None, None, :, :]
            attraction_ij = (
                f32(params.attraction)
                * tafac[:, :, :, None]
                * qafac[:, :, None, :]
            )
            pf = pair_forces(
                params,
                diff,
                rel_vel,
                trad[:, :, :, None],
                qrad[:, :, None, :],
                attraction_ij,
                valid,
            )
            force = force + jnp.sum(pf.force, axis=3)
            abs_a = abs_a + jnp.sum(pf.mag_attract, axis=3)
            abs_r = abs_r + jnp.sum(pf.mag_contact, axis=3)

    # back to bot-major: four small flat gathers
    safe_slot = jnp.minimum(slot, total - 1)
    got = mask & (slot < total)
    bot_force = jnp.where(
        got[:, None], force.reshape(total, 2)[safe_slot], 0.0
    )
    bot_a = jnp.where(got, abs_a.reshape(total)[safe_slot], 0.0)
    bot_r = jnp.where(got, abs_r.reshape(total)[safe_slot], 0.0)

    f_obs, m_obs = obstacle_forces(params, pos, vel, rad)
    bot_force = bot_force + f_obs
    bot_r = bot_r + m_obs

    new_vel = friction_velocity_update(params, vel, bot_force, payload, dt)
    new_vel = jnp.where(mask[..., None], new_vel, 0.0)
    return new_vel, bot_a, bot_r
