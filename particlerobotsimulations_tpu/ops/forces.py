"""Contact + magnet + obstacle forces and stick-slip friction.

Re-derivation of the reference's hot loop #1, ``collideD``
(/root/reference/particlebot_kernel_impl.cuh:540-831).  Instead of one CUDA
thread per bot scanning 25 grid cells, forces are computed as masked
vectorized pair interactions (dense O(N^2) here; the scalable cell-table
backend in ``ops/grid.py`` reuses the same pair math).

Physics, matching the reference constants exactly:

* Overlapping pair (DEM): spring ``-k (d_c - d) n`` + dashpot ``c v_rel`` +
  tangential shear ``s v_t``  (particlebot_kernel_impl.cuh:560-573).
* Non-overlapping pair (magnet): piecewise in the surface gap g —
  constant 2.5 for g < 0.9 mm, linear ramp to ``attraction/int2^2`` at
  g = 1.9 mm, then inverse-square ``attraction / g^2``
  (particlebot_kernel_impl.cuh:576-593).
* Payload (last bot when n_dead == -1) scales attraction by
  ``attraction_factor`` on either side of the pair
  (particlebot_kernel_impl.cuh:629-649).
* Stick-slip friction: zero net force if nearly static and |F| below the
  static threshold, then kinetic mu*g*dt opposing motion
  (particlebot_kernel_impl.cuh:801-825).

Everything is pure float32 and shape-static; no data-dependent control flow.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SimParams

_EPS = 1.0e-12
# Magnet-force breakpoints (surface gap, world units = meters*?) —
# particlebot_kernel_impl.cuh:578-580.
MAGNET_INT1 = 0.0009
MAGNET_INT2 = 0.0019
MAGNET_MIN_ATTR = 2.5


class PairForces(NamedTuple):
    force: jax.Array    # (..., 2) net force on i from each pair
    mag_contact: jax.Array  # (...,) |contact force| per pair (absForce_r term)
    mag_attract: jax.Array  # (...,) |magnet force| per pair (absForce_a term)


def _norm(v: jax.Array, axis: int = -1) -> jax.Array:
    # max() keeps sqrt off exact zero: forward change is < 1e-15 (masked
    # anyway) and the backward pass stays NaN-free — the whole step loop is
    # differentiable (see models/optimize.py)
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=axis), 1.0e-30))


def pair_forces(
    params: SimParams,
    diff: jax.Array,       # (..., 2) pos_j - pos_i
    rel_vel: jax.Array,    # (..., 2) vel_j - vel_i
    rad_i: jax.Array,      # (...,)
    rad_j: jax.Array,      # (...,)
    attraction_ij: jax.Array,  # (...,) pre-scaled attraction constant
    valid: jax.Array,      # (...,) bool — is this a real, non-self pair
) -> PairForces:
    """Force on bot i from each candidate pair (i, j).

    Mirrors ``collideSpheres`` (particlebot_kernel_impl.cuh:540-594) with a
    branch-free ``where`` formulation.  ``valid`` must already exclude self
    pairs and padding; pairs beyond ``params.cutoff()`` are additionally
    masked here, standing in for the reference's 5x5-cell reach.
    """
    f32 = jnp.float32
    dist = _norm(diff)
    safe_dist = jnp.maximum(dist, f32(_EPS))
    norm = diff / safe_dist[..., None]

    collide_dist = rad_i + rad_j
    overlap = valid & (dist < collide_dist)
    attract = valid & ~(dist < collide_dist) & (dist < f32(params.cutoff()))

    # --- DEM contact ------------------------------------------------------
    vn = jnp.sum(rel_vel * norm, axis=-1)
    tan_vel = rel_vel - vn[..., None] * norm
    f_contact = (
        -f32(params.spring) * (collide_dist - dist)[..., None] * norm
        + f32(params.damping) * rel_vel
        + f32(params.shear) * tan_vel
    )

    # --- magnet attraction ---------------------------------------------------
    gap = dist - collide_dist
    # double-where: the untaken inverse-square branch must not see tiny gaps,
    # or its (unused) gradient is inf and poisons the where backward pass
    gap_inv2 = jnp.where(gap >= f32(MAGNET_INT2), gap, f32(1.0))
    ramp_slope = (
        attraction_ij / f32(MAGNET_INT2) ** 2 - f32(MAGNET_MIN_ATTR)
    ) / f32(MAGNET_INT2 - MAGNET_INT1)
    attr_mag = jnp.where(
        gap < f32(MAGNET_INT1),
        f32(MAGNET_MIN_ATTR),
        jnp.where(
            gap < f32(MAGNET_INT2),
            f32(MAGNET_MIN_ATTR) + ramp_slope * (gap - f32(MAGNET_INT1)),
            attraction_ij / (gap_inv2 * gap_inv2),
        ),
    )
    f_attract = attr_mag[..., None] * norm

    mag_c = jnp.where(overlap, _norm(f_contact), 0.0)
    mag_a = jnp.where(attract, _norm(f_attract), 0.0)
    force = jnp.where(overlap[..., None], f_contact, 0.0) + jnp.where(
        attract[..., None], f_attract, 0.0
    )
    return PairForces(force=force, mag_contact=mag_c, mag_attract=mag_a)


def attraction_scale(params: SimParams, payload: jax.Array) -> jax.Array:
    """Per-bot attraction multiplier; pairwise scale is the product of the two
    endpoints' factors (particlebot_kernel_impl.cuh:629-649)."""
    return jnp.where(payload, jnp.float32(params.attraction_factor), jnp.float32(1.0))


def obstacle_forces(
    params: SimParams,
    pos: jax.Array,   # (n, 2)
    vel: jax.Array,   # (n, 2)
    rad: jax.Array,   # (n,)
):
    """Circle + axis-aligned rectangle obstacle contact forces.

    Re-derivation of particlebot_kernel_impl.cuh:703-798.  Obstacle lists are
    static tuples, so the loop unrolls at trace time (<= 10 each).  Returns
    (force (n,2), repulsive_magnitude (n,)).
    """
    f32 = jnp.float32
    n = pos.shape[0]
    force = jnp.zeros_like(pos)
    mag_r = jnp.zeros((n,), f32)
    px, py = pos[:, 0], pos[:, 1]

    def dem(direction, overlap, hit):
        """Spring(2k) + dashpot + shear against a static obstacle.

        The obstacle spring constant is doubled relative to bot-bot contact
        (particlebot_kernel_impl.cuh:719, 789)."""
        rel_vel = -vel
        vn = jnp.sum(rel_vel * direction, axis=-1)
        tan = rel_vel - vn[..., None] * direction
        f = (
            -2.0 * f32(params.spring) * overlap[..., None] * direction
            + f32(params.damping) * rel_vel
            + f32(params.shear) * tan
        )
        return (
            jnp.where(hit[..., None], f, 0.0),
            jnp.where(hit, _norm(f), 0.0),
        )

    for cx, cy, cr in params.circle_obstacles:
        d2 = (px - f32(cx)) ** 2 + (py - f32(cy)) ** 2
        hit = d2 < (rad + f32(cr)) ** 2
        to_center = jnp.stack([f32(cx) - px, f32(cy) - py], axis=-1)
        direction = to_center / jnp.maximum(_norm(to_center), f32(_EPS))[..., None]
        overlap = rad + f32(cr) - jnp.sqrt(jnp.maximum(d2, f32(_EPS)))
        # reference spring is +2k*overlap*(-dir_toward_center)
        # (particlebot_kernel_impl.cuh:719) == dem()'s -2k*overlap*dir with
        # dir pointing toward the obstacle center.
        f, m = dem(direction, overlap, hit)
        force = force + f
        mag_r = mag_r + m

    for x1, x2, y1, y2 in params.rect_obstacles:
        x1, x2, y1, y2 = f32(x1), f32(x2), f32(y1), f32(y2)
        in_y = (py > y1) & (py < y2)
        in_x = (px > x1) & (px < x2)

        # side contacts (later condition wins, matching the sequential ifs at
        # particlebot_kernel_impl.cuh:733-756)
        left = in_y & (px > x1 - rad) & (px < x2 - rad)
        right = in_y & (px < x2 + rad) & (px > x1 + rad)
        bottom = ~in_y & in_x & (py > y1 - rad) & (py < y2 - rad)
        top = ~in_y & in_x & (py < y2 + rad) & (py > y1 + rad)

        zeros = jnp.zeros_like(px)
        ones = jnp.ones_like(px)
        side_hit = left | right | bottom | top
        side_dir = jnp.stack([ones, zeros], axis=-1)
        side_over = px - x1 + rad
        for cond, d, o in (
            (right, jnp.stack([-ones, zeros], axis=-1), -px + x2 + rad),
            (bottom, jnp.stack([zeros, ones], axis=-1), py - y1 + rad),
            (top, jnp.stack([zeros, -ones], axis=-1), -py + y2 + rad),
        ):
            side_dir = jnp.where(cond[..., None], d, side_dir)
            side_over = jnp.where(cond, o, side_over)

        # corner contacts, first match wins, only if no side contact
        # (elif chain at particlebot_kernel_impl.cuh:757-780)
        corner_hit = jnp.zeros((n,), bool)
        corner_dir = jnp.zeros((n, 2), f32)
        corner_over = jnp.zeros((n,), f32)
        for corx, cory in ((x2, y2), (x1, y2), (x1, y1), (x2, y1)):
            dvec = jnp.stack([px - corx, py - cory], axis=-1)
            d = _norm(dvec)
            hit_c = (d < rad) & ~in_y & ~in_x & ~corner_hit
            dirc = -dvec / jnp.maximum(d, f32(_EPS))[..., None]
            corner_dir = jnp.where(hit_c[..., None], dirc, corner_dir)
            corner_over = jnp.where(hit_c, rad - d, corner_over)
            corner_hit = corner_hit | hit_c

        hit = side_hit | corner_hit
        direction = jnp.where(side_hit[..., None], side_dir, corner_dir)
        overlap = jnp.where(side_hit, side_over, corner_over)
        f, m = dem(direction, overlap, hit)
        force = force + f
        mag_r = mag_r + m

    return force, mag_r


def friction_velocity_update_xy(
    params: SimParams,
    vx: jax.Array,
    vy: jax.Array,
    fx: jax.Array,
    fy: jax.Array,
    payload: jax.Array,  # (...,) bool
    dt: float,
):
    """Component-form stick-slip friction + explicit velocity update.

    Matches particlebot_kernel_impl.cuh:801-825: static hold zeroes the net
    force when the bot is at rest below the 2*mu*g threshold; the velocity
    then integrates F*dt (payload: F/massFactor*dt); kinetic friction
    removes mu*g*dt from the speed, clamping through zero.  The component
    form exists so the table-resident loop never has to interleave its flat
    px/py planes into (n, 2) arrays."""
    f32 = jnp.float32
    fric = f32(params.friction) * jnp.where(
        payload, f32(params.friction_factor), f32(1.0)
    )
    grav = f32(params.gravity) * jnp.where(
        payload, f32(params.mass_factor), f32(1.0)
    )

    def norm2(x, y):
        return jnp.sqrt(jnp.maximum(x * x + y * y, f32(1.0e-30)))

    speed = norm2(vx, vy)
    fmag = norm2(fx, fy)
    static_hold = (speed < f32(1.0e-6)) & (fmag < 2.0 * fric * grav)
    fx = jnp.where(static_hold, 0.0, fx)
    fy = jnp.where(static_hold, 0.0, fy)

    inv_mass_dt = jnp.where(payload, f32(1.0 / params.mass_factor), f32(1.0)) * f32(dt)
    vx = vx + fx * inv_mass_dt
    vy = vy + fy * inv_mass_dt

    new_speed = norm2(vx, vy)
    kin = fric * grav * f32(dt)
    inv = jnp.maximum(new_speed, f32(_EPS))
    stopped = new_speed < kin
    # op order matches the historical vector form (vel - kin * (vel/speed))
    # bit-for-bit so golden fixtures stay valid
    return (
        jnp.where(stopped, 0.0, vx - kin * (vx / inv)),
        jnp.where(stopped, 0.0, vy - kin * (vy / inv)),
    )


def friction_velocity_update(
    params: SimParams,
    vel: jax.Array,      # (n, 2)
    force: jax.Array,    # (n, 2)
    payload: jax.Array,  # (n,) bool
    dt: float,
) -> jax.Array:
    """Vector-form stick-slip friction + explicit velocity update.

    Same physics as friction_velocity_update_xy; kept as the historical
    vector formulation VERBATIM rather than a wrapper because slicing and
    restacking changes XLA's FMA fusion choices
    (--xla_allow_excess_precision), which flips 1-ulp roundings and
    invalidates the golden trajectory fixtures."""
    f32 = jnp.float32
    fric = f32(params.friction) * jnp.where(
        payload, f32(params.friction_factor), f32(1.0)
    )
    grav = f32(params.gravity) * jnp.where(
        payload, f32(params.mass_factor), f32(1.0)
    )

    speed = _norm(vel)
    fmag = _norm(force)
    static_hold = (speed < f32(1.0e-6)) & (fmag < 2.0 * fric * grav)
    force = jnp.where(static_hold[..., None], 0.0, force)

    inv_mass = jnp.where(payload, f32(1.0 / params.mass_factor), f32(1.0))
    vel = vel + force * (inv_mass * f32(dt))[..., None]

    new_speed = _norm(vel)
    kin = fric * grav * f32(dt)
    unit = vel / jnp.maximum(new_speed, f32(_EPS))[..., None]
    return jnp.where((new_speed < kin)[..., None], 0.0, vel - kin[..., None] * unit)


def dense_collide(
    params: SimParams,
    pos: jax.Array,        # (n_pad, 2)
    vel: jax.Array,        # (n_pad, 2)
    rad: jax.Array,        # (n_pad,)
    mask: jax.Array,       # (n_pad,) bool — real bots
    payload: jax.Array,    # (n_pad,) bool
    dt: float,
):
    """Full collide pass with dense masked O(N^2) pairs.

    Exact for any bot count; preferred for small swarms, where the (N, N)
    pairwise tensors stay cheap.  Returns
    (new_vel, abs_force_a, abs_force_r) in the reference's semantics
    (particlebot_kernel_impl.cuh:657-831).
    """
    n = pos.shape[0]
    diff = pos[None, :, :] - pos[:, None, :]        # (i, j, 2): pos_j - pos_i
    rel_vel = vel[None, :, :] - vel[:, None, :]
    eye = jnp.eye(n, dtype=bool)
    valid = mask[:, None] & mask[None, :] & ~eye

    afac = attraction_scale(params, payload)
    attraction_ij = jnp.float32(params.attraction) * afac[:, None] * afac[None, :]

    pf = pair_forces(
        params,
        diff,
        rel_vel,
        rad[:, None],
        rad[None, :],
        attraction_ij,
        valid,
    )
    force = jnp.sum(pf.force, axis=1)
    abs_a = jnp.sum(pf.mag_attract, axis=1)
    abs_r = jnp.sum(pf.mag_contact, axis=1)

    f_obs, m_obs = obstacle_forces(params, pos, vel, rad)
    force = force + f_obs
    abs_r = abs_r + m_obs

    new_vel = friction_velocity_update(params, vel, force, payload, dt)
    new_vel = jnp.where(mask[..., None], new_vel, 0.0)
    return new_vel, abs_a, abs_r
