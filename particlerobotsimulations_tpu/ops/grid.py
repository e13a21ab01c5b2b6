"""Cell-table neighbor search — the scalable force backend for 10k+ bots.

XLA analogue of the reference's uniform-grid pipeline
(calcHashD -> thrust sort -> reorderDataAndFindCellStartD -> collideD 5x5
scan, /root/reference/particlebot_cuda.cu:162-383 and
particlebot_kernel_impl.cuh:445-538, 691-699), re-designed for XLA:

* The reference sorts only every ``sort_interval`` (180 s) and compensates
  for the stale ordering with a 5x5-cell scan.  Rebuilding every step is
  one ``argsort`` of N keys and strictly *more* accurate, so we do that
  and scan only 3x3 cells of size ``cutoff``.
* Instead of variable-length cell buckets (dynamic shapes), bots are
  scattered into a fixed-capacity index table ``(grid_dim^2, cell_capacity)``
  — all shapes static, fully vectorized, no data-dependent control flow.
* The grid wraps with a power-of-two mask exactly like ``calcGridHash``
  (particlebot_kernel_impl.cuh:114-120); aliased far-away pairs are
  eliminated by the true-distance cutoff inside ``pair_forces``.

The pair math itself is shared with the dense backend (``ops/forces.py``),
so the two paths agree to float reassociation order.
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


# the full 3x3 neighborhood (dx, dy), center first — shared by the
# force kernel, its jnp twin and the cadence probe's velocity envelopes
OFFSETS9 = (
    (0, 0),
    (1, 0), (-1, 0), (0, 1), (0, -1),
    (1, 1), (1, -1), (-1, 1), (-1, -1),
)


class CellTable(NamedTuple):
    idx: jax.Array        # (G*G*C,) int32 — bot index or -1
    cell_id: jax.Array    # (n_pad,) int32 — each bot's cell
    overflow: jax.Array   # () int32 — bots dropped for exceeding capacity


def cell_origin(params: SimParams, pos: jax.Array, mask: jax.Array) -> jax.Array:
    """(2,) grid anchor: the swarm's bounding-box min (active bots only)."""
    big = jnp.float32(4.0 * params.world_half)
    ox = jnp.min(jnp.where(mask, pos[..., 0], big))
    oy = jnp.min(jnp.where(mask, pos[..., 1], big))
    return jnp.stack([ox, oy])


def cell_ids(
    params: SimParams,
    pos: jax.Array,
    mask: jax.Array,
    origin: jax.Array | None = None,
) -> jax.Array:
    """Wrapped cell id per bot; padding routed out of range (dropped later).

    The grid is anchored to the swarm's bounding box (dynamic origin =
    min active position) rather than the world: a compact blob then fills a
    small table densely, which is what makes the stencil backends fast.  The
    modular wrap (reference: calcGridHash power-of-2 wrap,
    particlebot_kernel_impl.cuh:114-120) keeps stragglers safe — aliased
    far-apart pairs are eliminated by the true-distance cutoff.  An explicit
    ``origin`` pins the anchor (the table loop keeps it fixed per chunk so
    every rebuild of a chunk sees consistent lane arithmetic).
    """
    g = params.resolved_grid_dim()
    h = jnp.float32(params.cutoff())
    if origin is None:
        origin = cell_origin(params, pos, mask)
    ix = jnp.floor((pos[..., 0] - origin[0]) / h).astype(jnp.int32) % g
    iy = jnp.floor((pos[..., 1] - origin[1]) / h).astype(jnp.int32) % g
    cid = iy * g + ix
    return jnp.where(mask, cid, g * g)


def rank_cells(cid: jax.Array, g: int, cap: int):
    """Sort bots by cell id and rank each within its cell's run.

    The shared core of every slot-table build (the equivalent of the
    reference's calcHash -> thrust::sort -> findCellStart pipeline,
    particlebot_kernel_impl.cuh:445-538): a stable argsort groups bots by
    cell, then rank = position within the group.  Returns
    ``(order, scid, rank, in_range, overflow)`` where ``scid``/``rank``/
    ``in_range`` are in sorted order and ``overflow`` counts in-range bots
    beyond ``cap`` per cell (they get no slot)."""
    n = cid.shape[0]
    order = jnp.argsort(cid)                       # stable radix-style sort
    scid = cid[order]
    arange = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), scid[1:] != scid[:-1]])
    run_start = jax.lax.cummax(jnp.where(is_start, arange, 0))
    rank = arange - run_start
    in_range = scid < g * g
    overflow = jnp.sum((in_range & (rank >= cap)).astype(jnp.int32))
    return order, scid, rank, in_range, overflow


def build_cell_table(params: SimParams, pos: jax.Array, mask: jax.Array) -> CellTable:
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    cid = cell_ids(params, pos, mask)
    order, scid, rank, in_range, overflow = rank_cells(cid, g, cap)
    keep = in_range & (rank < cap)
    slot = jnp.where(keep, scid * cap + rank, g * g * cap)
    table = jnp.full((g * g * cap,), -1, dtype=jnp.int32)
    table = table.at[slot].set(order.astype(jnp.int32), mode="drop")
    return CellTable(idx=table, cell_id=cid, overflow=overflow)


def neighbor_candidates(params: SimParams, table: CellTable) -> jax.Array:
    """(n_pad, 9*cell_capacity) int32 candidate bot indices (-1 = empty)."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    cid = jnp.minimum(table.cell_id, g * g - 1)
    cx = cid % g
    cy = cid // g
    offs = jnp.array(
        [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dtype=jnp.int32
    )
    nx = (cx[:, None] + offs[None, :, 1]) % g
    ny = (cy[:, None] + offs[None, :, 0]) % g
    ncell = ny * g + nx                                        # (n, 9)
    base = ncell[..., None] * cap + jnp.arange(cap, dtype=jnp.int32)
    return table.idx[base.reshape(base.shape[0], -1)]          # (n, 9*cap)


def cellgrid_collide(
    params: SimParams,
    pos: jax.Array,        # (n_pad, 2)
    vel: jax.Array,        # (n_pad, 2)
    rad: jax.Array,        # (n_pad,)
    mask: jax.Array,       # (n_pad,) bool
    payload: jax.Array,    # (n_pad,) bool
    dt: float,
):
    """Collide pass over 3x3-cell candidates.  Same semantics as
    ``dense_collide`` but O(N * 9 * cell_capacity) instead of O(N^2)."""
    n = pos.shape[0]
    table = build_cell_table(params, pos, mask)
    cand = neighbor_candidates(params, table)      # (n, K)

    arange = jnp.arange(n, dtype=jnp.int32)
    cand_valid = (cand >= 0) & (cand != arange[:, None]) & mask[:, None]
    cj = jnp.maximum(cand, 0)

    pos_j = pos[cj]                                 # (n, K, 2)
    vel_j = vel[cj]
    rad_j = rad[cj]

    diff = pos_j - pos[:, None, :]
    rel_vel = vel_j - vel[:, None, :]

    afac = attraction_scale(params, payload)
    attraction_ij = jnp.float32(params.attraction) * afac[:, None] * afac[cj]

    pf = pair_forces(
        params,
        diff,
        rel_vel,
        rad[:, None],
        rad_j,
        attraction_ij,
        cand_valid,
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
