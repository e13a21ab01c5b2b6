"""Neighbor-force pass on the slot-major cell table: a Pallas kernel for the
GPU (Triton route) and its plain-jnp twin.

The table holds every field as slot-major rows: row ``slot * stride +
lane``, where ``lane = y * G + x`` is a cell of the wrapped, bbox-anchored
grid and ``slot`` is the bot's rank inside its cell (occupied slots are a
prefix of each cell; empty rows are all zero, so ``rad > 0`` is the
occupancy flag).

The kernel follows the reference's ``collideD``
(reference particlebot_kernel_impl.cuh:657-700): one program per
tile of ``TILE`` cells; every target slot of the tile scans the 3x3
neighbouring cells' slots straight from the un-shifted table (the
neighbour lane is computed with the exact 2-D wrap) and accumulates only
its OWN (fx, fy, |fa|, |fr|).  No reaction is written to another bot, so
there are no reaction planes to realign and the same kernel serves the
sharded table's halo-extended call (parallel/spatial_table.py), whose
targets are a window of a wider array.  Each program bounds its candidate
loop by the highest occupied slot of the neighbour cells in its tile and
skips every offset when the tile holds no target, which XLA cannot do.

``table_forces_jnp`` computes the same 9-block pair math as broadcast
(C, C, cells) blocks left to XLA: the reference for the tests and the
plain version the kernel is measured against.

Pair physics constants match collideSpheres
(reference particlebot_kernel_impl.cuh:540-594) exactly; see
ops/forces.py for the annotated scalar form.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import SimParams
from .forces import (
    MAGNET_INT1,
    MAGNET_INT2,
    MAGNET_MIN_ATTR,
    attraction_scale,
    friction_velocity_update,
    obstacle_forces,
)
from .grid import OFFSETS9, cell_ids, rank_cells

# Cells per kernel program (a power of two; the largest power of two
# <= TILE dividing the target window is used) and warps per program.
# Chosen on an H100 by scripts/force_ab.py tiles: two cells on two warps
# keep each (C, C, TILE) pair temporary at 8 registers per thread and beat
# (4, 4) and (8, 8) at 10k and 131k bots (CHANGES.md).
TILE = 2
NUM_WARPS = 2


def interpret_mode() -> bool:
    """Whether Pallas kernels run in interpret mode: on the CPU only, where
    the tests run them.  Every other platform compiles them for the card."""
    return jax.default_backend() == "cpu"


def kernel_fields(params: SimParams) -> tuple:
    """Field planes the force pass reads.  ``val`` is recomputed as
    ``rad > 0``; without a payload every bot's attraction factor is 1, so
    ``afac`` equals ``val`` and is not read either."""
    base = ("px", "py", "vx", "vy", "rad")
    return base + ("afac",) if params.has_payload else base


def _magmin_ok(params: SimParams) -> bool:
    """Static eligibility for the min/max magnet-select collapse.

    The three-way select ``where(gap < i1, mina, where(gap < i2, ramp,
    inv2))`` equals ``min(max(mina, ramp), inv2)`` region by region when
    the piecewise law is monotone (ramp slope >= 0, inv2 >= mina on
    [0, i1)), PROVIDED the float orderings ``ramp <= inv2`` on [i1, i2)
    and ``inv2 <= ramp`` on [i2, inf) hold bitwise — rounding-luck facts
    near the i2 breakpoint that depend on the attraction constant, so the
    collapse is gated on the enumeration-verified value (the reference
    default 3*0.000015884, config.py / main.cpp defaults; every shipped
    cfg uses it).
    tests/test_pallas.py::test_magmin_exhaustive_enumeration checks every
    float32 gap in the risky window and pins the monotone edge arguments.
    Payload runs keep the select: per-pair ``attr`` planes can be small
    (or zero -> 0/0 = NaN at gap == 0, which min/max would PROPAGATE
    where the select discards it)."""
    if os.environ.get("PBOT_MAGMIN", "1") == "0":
        return False
    return (not params.has_payload) and (
        float(params.attraction) == 3.0 * 0.000015884
    )


def neighbor_lanes(lane: jax.Array, g: int, rows: int, dx: int, dy: int):
    """Lane of the cell (x + dx, y + dy) for each lane ``y * g + x`` of an
    array of ``rows`` grid rows, wrapped exactly in both axes."""
    x = jax.lax.rem(lane, g)
    y = jax.lax.div(lane, g)
    return jax.lax.rem(y + (dy + rows), rows) * g + jax.lax.rem(x + (dx + g), g)


def _pair_terms(params: SimParams, t: dict, c: dict, pair_mask=None):
    """Fused pair forces of targets ``t`` against candidates ``c`` (dicts of
    broadcast-compatible field arrays; ``val`` and ``afac`` included).
    Returns (fx, fy, ma, mc) in the broadcast shape.  Identical math to
    ops/forces.py::pair_forces but rsqrt-first (float32 agrees to ~1 ulp).
    ``pair_mask`` (bool) excludes pairs, e.g. a slot with itself."""
    f32 = jnp.float32
    eps = f32(1.0e-12)
    legacy = os.environ.get("PBOT_PAIRMATH", "") == "legacy"
    dx = c["px"] - t["px"]
    dy = c["py"] - t["py"]
    if legacy:
        d2 = jnp.maximum(dx * dx + dy * dy, eps * eps)
    else:
        # + eps^2 instead of max(., eps^2): bitwise-identical for every
        # real pair (d2 ~ 1e-3 ULP-absorbs 1e-24) and equal at the
        # degenerate d2 == 0 point; one fewer vector op per pair
        d2 = dx * dx + dy * dy + eps * eps
    inv_dist = jax.lax.rsqrt(d2)
    dist = d2 * inv_dist
    nx = dx * inv_dist
    ny = dy * inv_dist

    cd = t["rad"] + c["rad"]
    valid = t["val"] * c["val"]
    if pair_mask is not None:
        valid = jnp.where(pair_mask, valid, 0.0)
    is_overlap = dist < cd
    overlap = jnp.where(is_overlap, valid, 0.0)
    attract = jnp.where(
        jnp.logical_and(~is_overlap, dist < f32(params.cutoff())), valid, 0.0
    )

    rvx = c["vx"] - t["vx"]
    rvy = c["vy"] - t["vy"]
    vn = rvx * nx + rvy * ny
    tx = rvx - vn * nx
    ty = rvy - vn * ny

    # the spring constant is negated on the host: a negated literal does
    # not lower on the Triton route
    neg_spring = f32(-params.spring)
    damping = f32(params.damping)
    shear = f32(params.shear)
    fcx = neg_spring * (cd - dist) * nx + damping * rvx + shear * tx
    fcy = neg_spring * (cd - dist) * ny + damping * rvy + shear * ty

    gap = dist - cd
    if params.has_payload or legacy:
        attr = f32(params.attraction) * t["afac"] * c["afac"]
    else:
        # no payload -> every afac plane is exactly val (1.0 on occupied
        # rows), so attr folds to the scalar: the valid factor re-enters
        # through the `attract` mask on every output that uses mag, and
        # invalid pairs' mag stays finite (inv2 <= attraction/eps^2 ~
        # 2.5e24 < f32 max) so `0 * mag == 0` — outputs bitwise-identical
        attr = f32(params.attraction)
    i1, i2, mina = f32(MAGNET_INT1), f32(MAGNET_INT2), f32(MAGNET_MIN_ATTR)
    ramp = mina + (attr * f32(1.0 / (MAGNET_INT2 * MAGNET_INT2)) - mina) * f32(
        1.0 / (MAGNET_INT2 - MAGNET_INT1)
    ) * (gap - i1)
    if legacy:
        inv2 = attr / (jnp.maximum(gap, eps) ** 2)
    else:
        # no eps guard: inv2 is only SELECTED when gap >= MAGNET_INT2
        # (where it equals the guarded form bitwise); for gap <= 0 it may
        # be inf, which the select discards without arithmetic.
        # FORWARD-ONLY: differentiating this branch would hit where's
        # 0*inf/NaN cotangent poisoning (models/optimize.py) — the
        # differentiable path pulls gradients through ops/stencil.py
        # instead (make_diff_pallas_collide)
        inv2 = attr / (gap * gap)
    if not legacy and _magmin_ok(params):
        # region-by-region collapse of the three-way select (see
        # _magmin_ok): gap < i1 -> ramp <= mina exactly and inv2 >=
        # attr/i1^2 >> mina, so both reductions land on mina (gap == 0
        # gives inv2 = +inf, which min discards); [i1, i2) -> mina <= ramp
        # <= inv2; [i2, inf) -> inv2 <= ramp.  gap < 0 pairs may differ in
        # mag but are overlap pairs: attract == 0 and both forms finite.
        mag = jnp.minimum(jnp.maximum(mina, ramp), inv2)
    else:
        mag = jnp.where(gap < i1, mina, jnp.where(gap < i2, ramp, inv2))
    fax = mag * nx
    fay = mag * ny

    fx = overlap * fcx + attract * fax
    fy = overlap * fcy + attract * fay
    mc = overlap * jnp.sqrt(fcx * fcx + fcy * fcy)
    ma = attract * mag  # mag >= 0 and n is unit, so |mag * n| == mag
    return fx, fy, ma, mc


def _with_derived(params: SimParams, d: dict) -> dict:
    """Add the ``val`` (= rad > 0) and, without a payload, ``afac`` (=
    val) planes that :func:`kernel_fields` does not read."""
    d["val"] = (d["rad"] > 0).astype(jnp.float32)
    if not params.has_payload:
        d["afac"] = d["val"]
    return d


def _tile_for(n_t: int) -> int:
    tile = TILE
    while n_t % tile:
        tile //= 2
    return tile


def _make_kernel(
    params: SimParams, names: tuple, g: int, rows: int, stride: int,
    t0: int, tile: int, cp: int,
):
    cap = params.cell_capacity
    f32 = jnp.float32

    def kernel(*refs):
        src = dict(zip(names, refs[: len(names)]))
        out_ref = refs[len(names)]
        lane = t0 + pl.program_id(0) * tile + jnp.arange(tile, dtype=jnp.int32)
        slot = jnp.arange(cp, dtype=jnp.int32)[:, None]          # (cp, 1)
        row_mask = (
            None if cp == cap else jnp.broadcast_to(slot < cap, (cp, tile))
        )

        def load_block(name, lanes):
            """(cp, tile) slot block of the cells ``lanes``."""
            idx = slot * stride + lanes[None, :]
            if row_mask is None:
                return src[name][idx]
            return plgpu.load(src[name].at[idx], mask=row_mask, other=0.0)

        t = _with_derived(params, {k: load_block(k, lane) for k in names})
        # targets on axis 0, candidates on axis 1, cells on axis 2
        t3 = {k: v[:, None, :] for k, v in t.items()}
        zero = tuple(jnp.zeros((cp, tile), f32) for _ in range(4))

        def forces():
            acc = zero
            for dx, dy in OFFSETS9:
                nl = neighbor_lanes(lane, g, rows, dx, dy)
                c = _with_derived(
                    params, {k: load_block(k, nl)[None, :, :] for k in names}
                )
                self_pair = None
                if dx == 0 and dy == 0:
                    self_pair = slot[:, :, None] != slot[None, :, :]
                terms = _pair_terms(params, t3, c, self_pair)
                acc = tuple(a + jnp.sum(b, axis=1) for a, b in zip(acc, terms))
            return acc

        # a tile with no target (most of the bbox grid's margin) skips the
        # whole pair evaluation
        acc = jax.lax.cond(jnp.max(t["rad"]) > 0, forces, lambda: zero)
        for i in range(4):
            out_ref[i, :, :] = acc[i]

    return kernel


def _table_forces_kernel(
    params: SimParams, fields: tuple, g: int, rows: int, stride: int,
    t0: int, n_t: int,
):
    names = kernel_fields(params)
    cap = params.cell_capacity
    cp = pl.next_power_of_2(cap)
    tile = _tile_for(n_t)
    out = pl.pallas_call(
        _make_kernel(params, names, g, rows, stride, t0, tile, cp),
        grid=(n_t // tile,),
        in_specs=[pl.no_block_spec] * len(names),
        out_specs=pl.BlockSpec((4, cp, tile), lambda i: (0, 0, i)),
        out_shape=jax.ShapeDtypeStruct((4, cp, n_t), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret_mode(),
        name="table_forces",
    )(*fields)
    return tuple(out[i, :cap] for i in range(4))


def table_forces(
    params: SimParams, fields: dict, g: int, rows: int, stride: int,
    t0: int, n_t: int,
):
    """Pair forces on the targets of a slot-major table — the Triton
    kernel (interpret mode on the CPU).

    ``fields`` maps each :func:`kernel_fields` name to a flat array whose
    row ``slot * stride + lane`` holds slot ``slot`` of cell ``lane``
    (rows past ``cell_capacity * stride`` are never read).  The lanes form
    ``rows`` grid rows of ``g`` cells; targets are the ``n_t`` lanes from
    ``t0``.  Returns (fx, fy, |fa|, |fr|), each (cell_capacity, n_t)."""
    names = kernel_fields(params)
    return _table_forces_kernel(
        params, tuple(fields[k] for k in names), g, rows, stride, t0, n_t
    )


def table_forces_jnp(
    params: SimParams, fields: dict, g: int, rows: int, stride: int,
    t0: int, n_t: int,
):
    """:func:`table_forces` as plain jnp: the same 9-block pair math on
    broadcast (C, C, n_t) blocks, left to XLA."""
    cap = params.cell_capacity
    names = kernel_fields(params)
    planes = {k: fields[k][: cap * stride].reshape(cap, stride) for k in names}
    lane = t0 + jnp.arange(n_t, dtype=jnp.int32)
    t = _with_derived(params, {k: v[:, t0 : t0 + n_t][:, None, :]
                               for k, v in planes.items()})
    ti = jax.lax.broadcasted_iota(jnp.int32, (cap, cap, 1), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (cap, cap, 1), 1)
    acc = [jnp.zeros((cap, n_t), jnp.float32) for _ in range(4)]
    for dx, dy in OFFSETS9:
        nl = neighbor_lanes(lane, g, rows, dx, dy)
        c = _with_derived(params, {k: v[:, nl][None] for k, v in planes.items()})
        center = dx == 0 and dy == 0
        terms = _pair_terms(params, t, c, (ti != ci) if center else None)
        acc = [a + jnp.sum(b, axis=1) for a, b in zip(acc, terms)]
    return tuple(acc)


def assign_slots_slotmajor(params: SimParams, pos, mask, origin=None, cap=None):
    """(n_pad,) flat slot per bot in the (C, G*G) slot-major layout:
    ``slot = rank * G*G + cell_id`` (rank = index within the cell).
    Out-of-range value G*G*C marks dropped bots (padding / overflow).
    ``cap`` defaults to the force-visible cell capacity; the table loop
    passes its storage capacity (incl. overflow spill slots)."""
    g = params.resolved_grid_dim()
    cap = cap if cap is not None else params.cell_capacity
    n = pos.shape[0]
    cid = cell_ids(params, pos, mask, origin=origin)
    order, scid, rank, in_range, overflow = rank_cells(cid, g, cap)
    keep = in_range & (rank < cap)
    slot_sorted = jnp.where(keep, rank * (g * g) + scid, g * g * cap)
    slot = jnp.zeros((n,), jnp.int32).at[order].set(slot_sorted)
    return slot, overflow


def make_diff_pallas_collide(params: SimParams, dt: float):
    """Differentiable wrapper: kernel forward, exact XLA backward.

    The Pallas kernel has no automatic VJP.  Its math is identical (to
    float32 reassociation, tests/test_pallas.py) to the pure-XLA roll
    stencil (ops/stencil.py), which IS differentiable — so the custom VJP
    runs the kernel forward and pulls cotangents back through the stencil
    formulation (gradient studies, models/optimize.py).

    mask/payload ride as float planes so every primal arg has a float
    cotangent (they get zeros); dt/params are static closure values.
    """
    from .stencil import stencil_collide

    @jax.custom_vjp
    def collide(pos, vel, rad, maskf, payloadf):
        return pallas_stencil_collide(
            params, pos, vel, rad, maskf > 0.5, payloadf > 0.5, dt
        )

    def fwd(pos, vel, rad, maskf, payloadf):
        return collide(pos, vel, rad, maskf, payloadf), (
            pos, vel, rad, maskf, payloadf,
        )

    def bwd(res, ct):
        pos, vel, rad, maskf, payloadf = res
        _, vjp = jax.vjp(
            lambda p, v, r: stencil_collide(
                params, p, v, r, maskf > 0.5, payloadf > 0.5, dt
            ),
            pos, vel, rad,
        )
        dp, dv, dr = vjp(ct)
        return dp, dv, dr, jnp.zeros_like(maskf), jnp.zeros_like(payloadf)

    collide.defvjp(fwd, bwd)
    return collide


def pallas_stencil_collide(
    params: SimParams,
    pos: jax.Array,
    vel: jax.Array,
    rad: jax.Array,
    mask: jax.Array,
    payload: jax.Array,
    dt: float,
    slot: jax.Array | None = None,
):
    """Drop-in collide pass: scatter to table, force kernel, gather back.

    ``slot`` may be supplied by the engine (slot-reuse optimization: bots
    move ~5e-4 cells per step, so reusing assignments for a few steps is
    safe — the reference reuses its sort for *18000* steps, compensated by
    a wider scan; see config.slot_rebuild_steps).
    """
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    gg = g * g
    total = gg * cap
    if slot is None:
        slot, _overflow = assign_slots_slotmajor(params, pos, mask)

    # one wide row scatter instead of per-field scatters
    afac = attraction_scale(params, payload)
    rows = jnp.stack(
        [pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], rad, afac], axis=-1
    )  # (n_pad, 6)
    table = jnp.zeros((total, 6), jnp.float32).at[slot].set(rows, mode="drop")
    fields = {
        k: table[:, j] for j, k in enumerate(("px", "py", "vx", "vy", "rad", "afac"))
    }
    fx, fy, fa, fr = table_forces(params, fields, g, g, gg, 0, gg)

    safe_slot = jnp.minimum(slot, total - 1)
    got = mask & (slot < total)
    # one 4-wide row gather instead of four scalar gathers
    packed = jnp.stack([fx, fy, fa, fr], axis=-1).reshape(total, 4)
    out = jnp.where(got[:, None], packed[safe_slot], 0.0)
    force = out[:, :2]
    abs_a = out[:, 2]
    abs_r = out[:, 3]

    f_obs, m_obs = obstacle_forces(params, pos, vel, rad)
    force = force + f_obs
    abs_r = abs_r + m_obs

    new_vel = friction_velocity_update(params, vel, force, payload, dt)
    new_vel = jnp.where(mask[..., None], new_vel, 0.0)
    return new_vel, abs_a, abs_r
