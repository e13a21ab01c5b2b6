"""Simulation state pytree.

Replacement for the reference's scattered host/device arrays
(/root/reference/particlebot.cpp:77-166).  Structure-of-arrays, float32,
padded to a multiple of 128 bots.  The struct is a pytree: it can be
scanned over, vmapped over a batch of scenes, donated, and sharded.

One-step-lag force feedback: ``abs_force_a`` / ``abs_force_r`` are the
attraction / repulsion force magnitudes accumulated by the *previous* step's
collide pass (reference: particlebot_kernel_impl.cuh:829-830); the radius
controller reads them before collide overwrites them, exactly matching the
reference's update ordering (particlebot.cpp:238-296).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import SimParams, padded_n


class SimState(NamedTuple):
    """Per-scene simulation state.  All arrays padded to ``n_pad`` bots."""

    pos: jax.Array          # (n_pad, 2) float32
    vel: jax.Array          # (n_pad, 2) float32
    rad: jax.Array          # (n_pad,)  float32
    phase: jax.Array        # (n_pad,)  float32
    dead: jax.Array         # (n_pad,)  bool
    abs_force_a: jax.Array  # (n_pad,)  float32 — attraction magnitude sum
    abs_force_r: jax.Array  # (n_pad,)  float32 — repulsive magnitude sum
    step: jax.Array         # ()        int32 — sim time = step * dt
    key: jax.Array          # PRNG key for phase noise / dead-cell choice
    centroid_ring: jax.Array  # (centroid_steps, 2) float32 — COG history

    @property
    def n_pad(self) -> int:
        return self.pos.shape[-2]

    def time(self, dt: float) -> jax.Array:
        return self.step.astype(jnp.float32) * jnp.float32(dt)


def active_mask(params: SimParams, n_pad: int | None = None) -> jax.Array:
    """Boolean (n_pad,) mask of real (non-padding) bots."""
    n_pad = n_pad or padded_n(params)
    return jnp.arange(n_pad) < params.n_cells


def payload_mask(params: SimParams, n_pad: int | None = None) -> jax.Array:
    """Mask of the transported payload object: the last bot when n_dead == -1
    (reference: particlebot_kernel_impl.cuh:629-649, 804-815)."""
    n_pad = n_pad or padded_n(params)
    idx = jnp.arange(n_pad)
    if params.has_payload:
        return idx == (params.n_cells - 1)
    return jnp.zeros((n_pad,), dtype=bool)


def make_state(
    params: SimParams,
    pos: np.ndarray,
    vel: np.ndarray | None = None,
    rad: np.ndarray | None = None,
    phase: np.ndarray | None = None,
    dead: np.ndarray | None = None,
    seed: int | None = None,
) -> SimState:
    """Build a padded device state from host (n_cells, ...) arrays.

    Initial radii / payload handling replicates particlebot.cpp:784-791:
    every bot starts at ``min_radius``; the payload (last bot, n_dead == -1)
    gets ``min_radius * rad_factor`` and is flagged dead (never modulates).
    """
    n = params.n_cells
    n_pad = padded_n(params)
    f32 = jnp.float32

    def pad2(a):
        out = np.zeros((n_pad, 2), dtype=np.float32)
        out[:n] = np.asarray(a, dtype=np.float32).reshape(n, 2)
        return out

    def pad1(a, fill=0.0, dtype=np.float32):
        out = np.full((n_pad,), fill, dtype=dtype)
        out[:n] = np.asarray(a, dtype=dtype).reshape(n)
        return out

    if vel is None:
        vel = np.zeros((n, 2), dtype=np.float32)
    if rad is None:
        rad = np.full((n,), params.min_radius, dtype=np.float32)
        if params.has_payload:
            rad[n - 1] = params.min_radius * params.rad_factor
    if phase is None:
        phase = np.zeros((n,), dtype=np.float32)
    if dead is None:
        dead = np.zeros((n,), dtype=bool)
        if params.has_payload:
            dead[n - 1] = True

    # Padding slots start far outside the world and are flagged dead.  NOTE:
    # this is NOT a standing no-interaction invariant — the integrator's
    # boundary clamp (ops/integrate.py) pulls every row to +-world_half after
    # one step, leaving all padding rows coincident at the world corner.
    # Consumers MUST mask (grid bbox, force valid masks all do); never rely
    # on padding positions staying remote.
    pos_p = pad2(pos)
    pos_p[n:] = 1.0e6 + 4.0 * np.arange(n_pad - n, dtype=np.float32)[:, None]
    key = jax.random.key(params.seed if seed is None else seed)

    return SimState(
        pos=jnp.asarray(pos_p, f32),
        vel=jnp.asarray(pad2(vel), f32),
        rad=jnp.asarray(pad1(rad), f32),
        phase=jnp.asarray(pad1(phase), f32),
        dead=jnp.asarray(pad1(dead, fill=True, dtype=bool)),
        abs_force_a=jnp.zeros((n_pad,), f32),
        abs_force_r=jnp.zeros((n_pad,), f32),
        step=jnp.int32(0),
        key=key,
        # Reference parks unwritten trail slots at x=-5000 (particlebot.cpp:778)
        centroid_ring=jnp.full((params.centroid_steps, 2), -5000.0, f32)
        .at[:, 1]
        .set(0.0),
    )
