"""Position integrator + world-boundary response.

Re-derivation of ``integrate_functor``
(/root/reference/particlebot_kernel_impl.cuh:53-103).  The reference runs a
split symplectic-Euler: collide updates velocity at step k, this op moves the
position at step k+1 (velocity already includes forces) and clamps to the
±world_half box, flipping the velocity component by ``boundary_damping``
(default -1, elastic).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimParams


def _require_resolved_world(params: SimParams) -> None:
    """The ``world_half == 0`` auto-fit sentinel must be resolved from the
    placement extent BEFORE any step function compiles — a 0 box would
    clamp every bot to the origin.  Simulation/initial_state_arrays resolve
    it; direct engine callers must do the same."""
    if params.world_half == 0:
        raise ValueError(
            "world_half=0 (auto-fit) is unresolved: build state via "
            "Simulation/initial_state_arrays (which derive the box from "
            "the placement extent) or set world_half explicitly"
        )


def integrate(
    params: SimParams,
    pos: jax.Array,   # (n, 2)
    vel: jax.Array,   # (n, 2)
    rad: jax.Array,   # (n,)
    dt: float,
):
    f32 = jnp.float32
    _require_resolved_world(params)
    half = f32(params.world_half)
    bd = f32(params.boundary_damping)

    new_pos = pos + vel * f32(dt)
    hi = (half - rad)[..., None]
    lo = (-half + rad)[..., None]
    out = (new_pos > hi) | (new_pos < lo)
    new_pos = jnp.clip(new_pos, lo, hi)
    new_vel = jnp.where(out, vel * bd, vel)
    return new_pos, new_vel


def radius_integrate_planes(params: SimParams, f: dict, time) -> dict:
    """Radius controller + integrate/boundary on a dict of flat component
    planes (keys rad/phase/aa/ar/dead/val/px/py/vx/vy) — the table-resident
    form shared by engine_table.step_pre and the sharded table loop so the
    reference-parity op order (particlebot.cpp:170-300:
    radius update from the PREVIOUS step's force magnitudes, then
    position integrate with the ±world_half clamp and boundary_damping
    velocity flip) lives in exactly one place.  Mutates and returns f.

    NOTE: the expression shape is pinned — reordering flips XLA FMA
    contraction choices (CLAUDE.md) and 1-ulp roundings across every
    table-path consistency test."""
    from .actuation import update_radius

    f32 = jnp.float32
    _require_resolved_world(params)
    dt = params.timestep
    f["rad"] = update_radius(
        params, f["rad"], f["phase"], f["aa"], f["ar"],
        f["dead"] > 0.5, f["val"] > 0.5, time, dt,
    )
    hi = f32(params.world_half) - f["rad"]
    lo = -f32(params.world_half) + f["rad"]
    bd = f32(params.boundary_damping)
    for c, v in (("px", "vx"), ("py", "vy")):
        new_p = f[c] + f[v] * f32(dt)
        out = (new_p > hi) | (new_p < lo)
        f[c] = jnp.clip(new_p, lo, hi)
        f[v] = jnp.where(out, f[v] * bd, f[v])
    return f
