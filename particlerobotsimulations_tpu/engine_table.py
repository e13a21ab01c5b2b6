"""Table-resident step loop for the PALLAS backend — the production hot path.

All simulation state stays resident in the slot-major cell table between
slot rebuilds, so the per-step path has no scatter into the table and no
gather back:

* state lives as flat ``(total_ext,)`` field arrays, where rows
  ``[0, C*G*G)`` are the slot-major table and the trailing ``n_pad`` rows
  are a parking strip for bots the table dropped (capacity overflow /
  padding) — parked bots keep integrating, they just exert no pair forces
  (same semantics as the bot-order engine's ``slot < total`` guard);
* phase / radius / integrate / friction run elementwise in table space
  (they are per-bot laws — the empty slots just compute masked garbage);
* the force pass (ops/pallas_stencil.table_forces) reads the flat field
  arrays directly;
* interval-gated ops (phase law every ``phase_update_interval``, centroid
  every ``centroid_int``, dead injection once) run under ``lax.cond`` so
  their cost is actually paid 1/1200 steps instead of being computed and
  thrown away;
* every ``slot_rebuild_steps`` the state is gathered to bot order with one
  wide row gather, slots are reassigned (bbox re-anchor + argsort — the
  reference's calcHash + thrust sort, particlebot_cuda.cu:162-383), and
  one wide row scatter rebuilds the table.

Op order per step matches ``engine.make_step`` (and the reference,
/root/reference/particlebot.cpp:170-300) exactly: dead injection, centroid
(pre-integrate positions), phase, radius (one-step-lag force feedback),
integrate, collide.  The RNG *streams* for phase noise and dead choice are
shaped per-slot instead of per-bot, so sampled values differ from
``engine.make_step`` while the distributions match — same relationship the
reference's host ``rand()`` has to either (documented in README deviations).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import Control, SimParams, padded_n
from .ops.forces import (
    attraction_scale,
    friction_velocity_update_xy,
    obstacle_forces,
)
from .ops.grid import OFFSETS9, cell_origin
from .ops.integrate import radius_integrate_planes
from .ops.pallas_stencil import (
    assign_slots_slotmajor,
    neighbor_lanes,
    table_forces,
)
from .ops.phase import update_phase
from .state import SimState, active_mask, payload_mask

# flat table field order.  "bid" stores each row's bot index (exact in f32
# up to 2^24) so the bot->row map can be reconstructed from the table.
TABLE_FIELDS = (
    "px", "py", "vx", "vy", "rad", "val", "afac",
    "phase", "dead", "aa", "ar", "pay", "bid",
)
N_TF = len(TABLE_FIELDS)


class TableState(NamedTuple):
    """Scan carry for the table-resident loop."""

    fields: dict            # str -> (total_ext,) f32
    origin: jax.Array       # (2,) f32 — grid anchor, fixed for the chunk
    step: jax.Array         # () int32
    key: jax.Array          # PRNG key (whole-run, folded per step)
    centroid_ring: jax.Array


def _geometry(params: SimParams):
    """(table rows, table+parking rows, n_pad) — the table uses the STORAGE
    capacity (force-visible cell_capacity + overflow spill slots)."""
    g = params.resolved_grid_dim()
    total = g * g * params.storage_capacity()
    n_pad = padded_n(params)
    return total, total + n_pad, n_pad


def _extend_slot(params: SimParams, slot: jax.Array) -> jax.Array:
    """Map dropped bots (slot == total) into the parking strip rows."""
    total, _, n_pad = _geometry(params)
    park = total + jnp.arange(n_pad, dtype=jnp.int32)
    return jnp.where(slot < total, slot, park)


def _bot_rows(params: SimParams, state: SimState):
    """(n_pad, N_TF) per-bot field rows from a bot-order SimState."""
    n_pad = state.pos.shape[0]
    mask = active_mask(params, n_pad)
    payload = payload_mask(params, n_pad)
    f32 = jnp.float32
    return jnp.stack(
        [
            state.pos[:, 0], state.pos[:, 1],
            state.vel[:, 0], state.vel[:, 1],
            state.rad,
            mask.astype(f32),
            attraction_scale(params, payload),
            state.phase,
            state.dead.astype(f32),
            state.abs_force_a,
            state.abs_force_r,
            payload.astype(f32),
            jnp.arange(n_pad, dtype=f32),
        ],
        axis=-1,
    )


def enter_table(params: SimParams, state: SimState) -> TableState:
    """Scatter a bot-order SimState into table residency (chunk entry)."""
    _, total_ext, n_pad = _geometry(params)
    mask = active_mask(params, n_pad)
    origin = cell_origin(params, state.pos, mask)
    slot, _ = assign_slots_slotmajor(
        params, state.pos, mask, origin=origin, cap=params.storage_capacity()
    )
    se = _extend_slot(params, slot)
    rows = _bot_rows(params, state)
    flat = jnp.zeros((total_ext, N_TF), jnp.float32).at[se].set(rows)
    fields = {k: flat[:, j] for j, k in enumerate(TABLE_FIELDS)}
    return TableState(
        fields=fields,
        origin=origin,
        step=state.step,
        key=state.key,
        centroid_ring=state.centroid_ring,
    )


def _slot_of_bot(params: SimParams, fields: dict) -> jax.Array:
    """(n_pad,) row index per bot, reconstructed from the bid plane.

    Occupied rows scatter their row index to their bot id; everything else
    (parked bots, padding) defaults to its parking-strip identity row."""
    total, total_ext, n_pad = _geometry(params)
    occupied = fields["val"][:total] > 0.5
    bid = jnp.where(
        occupied, fields["bid"][:total].astype(jnp.int32), n_pad  # oob -> drop
    )
    base = total + jnp.arange(n_pad, dtype=jnp.int32)
    return base.at[bid].set(
        jnp.arange(total, dtype=jnp.int32), mode="drop"
    )


def exit_table(params: SimParams, ts: TableState) -> SimState:
    """Gather table residency back to a bot-order SimState (chunk exit)."""
    slot = _slot_of_bot(params, ts.fields)
    flat = jnp.stack([ts.fields[k] for k in TABLE_FIELDS], axis=-1)
    rows = flat[slot]  # (n_pad, N_TF) — one wide row gather
    return SimState(
        pos=rows[:, 0:2],
        vel=rows[:, 2:4],
        rad=rows[:, 4],
        phase=rows[:, 7],
        dead=rows[:, 8] > 0.5,
        abs_force_a=rows[:, 9],
        abs_force_r=rows[:, 10],
        step=ts.step,
        key=ts.key,
        centroid_ring=ts.centroid_ring,
    )


def _rebuild_fields(params: SimParams, fields: dict):
    """Full slot rebuild on a fields dict: re-anchor + argsort
    reassignment via bot order.  Returns (new fields, new origin).  The
    sharded table loop (parallel/spatial_table.py) calls it replicated
    after an all-gather."""
    _, total_ext, n_pad = _geometry(params)
    slot = _slot_of_bot(params, fields)
    flat = jnp.stack([fields[k] for k in TABLE_FIELDS], axis=-1)
    rows = flat[slot]
    pos = rows[:, 0:2]
    mask = rows[:, 5] > 0.5
    origin = cell_origin(params, pos, mask)
    new_slot, _ = assign_slots_slotmajor(
        params, pos, mask, origin=origin, cap=params.storage_capacity()
    )
    se = _extend_slot(params, new_slot)
    new_flat = jnp.zeros((total_ext, N_TF), jnp.float32).at[se].set(rows)
    return {k: new_flat[:, j] for j, k in enumerate(TABLE_FIELDS)}, origin


def _rebuild(params: SimParams, ts: TableState) -> TableState:
    with jax.named_scope("slot_rebuild"):
        fields, origin = _rebuild_fields(params, ts.fields)
    return ts._replace(fields=fields, origin=origin)


def _inject_dead_table(params: SimParams, f: dict, key: jax.Array) -> jax.Array:
    """Kill n_dead occupied, not-yet-dead slots (cf. engine._inject_dead)."""
    alive = (f["val"] > 0.5) & (f["dead"] < 0.5)
    scores = jax.random.uniform(key, f["dead"].shape)
    scores = jnp.where(alive, scores, jnp.inf)
    _, kill = jax.lax.top_k(-scores, params.n_dead)
    return f["dead"].at[kill].set(1.0)


def _gates(params: SimParams, step: jax.Array):
    """Scalar (dead, cog, phase) gate predicates for a given step counter."""
    dead_gate = (
        step == params.dead_step
        if params.n_dead > 0
        else jnp.asarray(False)
    )
    return (
        dead_gate,
        step % params.centroid_steps_interval == 0,
        step % params.phase_update_steps == 0,
    )


def gate_seg(params: SimParams) -> int:
    """Gate-segment length for the amortized-cond chunk loop, or 0.

    Interval gates (centroid every ``centroid_int``, phase every
    ``phase_update_interval``, and the one-shot dead injection) can only
    fire on steps that are multiples of the gcd of their step intervals.
    When a chunk starts on a multiple of that gcd, every gate-eligible
    step is the FIRST step of a ``seg``-step segment — so the chunk can
    scan over segments whose first step carries the traced conds and
    whose remaining ``seg - 1`` steps are statically ungated.  The cond
    cost (paid even when no gate fires — cond operands defeat XLA buffer
    reuse) then amortizes to 1/seg.

    Returns 0 when the fast path does not apply: a dead-injection step
    that is not seg-aligned, or a rebuild period that does not tile the
    segment."""
    import math

    k = max(1, params.resolved_slot_rebuild_steps())
    ints = [params.centroid_steps_interval]
    if params.control == Control.LIGHT_WAVE:
        ints.append(params.phase_update_steps)
    seg = math.gcd(*ints)
    if params.n_dead > 0 and params.dead_step % seg != 0:
        return 0
    if k > 8 or seg % k != 0 or seg < k:
        return 0
    return seg


def _unroll_body_default(total_rows: int) -> bool:
    """Whether k-step rebuild blocks unroll their gateless steps inline.

    Unrolling k force-pass instances into one scan body multiplies XLA
    compile time by the body size, which grows with the table.  Large
    tables (> 2^20 rows) use an inner scan for the k-1 gateless steps
    instead — 2 step instances; the scan-boundary cost is noise at those
    step times.  PBOT_UNROLL_BODY=0/1 forces either (small-table test
    coverage of the big-table path).
    """
    env = os.environ.get("PBOT_UNROLL_BODY", "")
    if env:
        return env != "0"
    return total_rows <= (1 << 20)


def make_table_step_parts(params: SimParams, phase_fn=None):
    """(step_pre, step_post): the physics step split around the rebuild.

    ``step_pre`` runs dead injection, centroid ring, phase, radius and
    integrate (the step counter is NOT bumped); ``step_post`` runs collide
    + friction and bumps the counter.  The slot rebuild slots between the
    two — ``make_table_step`` composes them for the single-scene loop,
    while the batched loop vmaps them and runs the rebuild between them,
    so a traced rebuild gate keeps a scalar predicate.

    ``phase_fn`` (optional) replaces the phase-gate body: called as
    ``phase_fn(fields, val_mask, key) -> new phase plane`` inside the
    gated branch.  The packed scene-tiling sweep (parallel/packed.py)
    uses it to run the phase law per SCENE (per-row tile-local light
    distance + per-scene min reduction) while every other op — force
    kernel, rebuild, integrate — is the untouched single-scene path.
    ``None`` compiles the exact same program as before the hook existed."""
    params = params.validate()
    dt = params.timestep
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    gg = g * g
    total, total_ext, _ = _geometry(params)
    # the force pass sees only the first cell_capacity slots: in the
    # slot-major layout (rank * G*G + lane) those are the first
    # cap * G*G flat rows; spill rows above them exert no pair forces
    force_total = gg * cap
    f32 = jnp.float32
    cog_gate_steps = params.centroid_steps_interval

    def step_pre(
        ts: TableState,
        dead_gate,
        cog_gate,
        phase_gate,
    ) -> TableState:
        """The gates are SCALAR step predicates supplied by the caller so
        they survive vmap as real ``lax.cond``s (a batched predicate would
        decay every gate to a computed-then-discarded select).  A gate may
        also be the python bool ``False``: the op is then statically absent
        from this step instance — the segment-aligned chunk loop uses this
        to keep traced conds out of the hot scan body entirely (a traced
        cond routes its operands through the branch and defeats buffer
        reuse even when it never fires)."""
        f = dict(ts.fields)
        time = ts.step.astype(f32) * f32(dt)
        step_key = jax.random.fold_in(ts.key, ts.step)
        val = f["val"] > 0.5

        # 1. dead-cell injection (one-shot, under cond)
        if params.n_dead > 0 and dead_gate is not False:
            f["dead"] = jax.lax.cond(
                dead_gate,
                lambda: _inject_dead_table(params, f, step_key),
                lambda: f["dead"],
            )

        # 2. centroid ring (pre-integrate positions, 1/centroid_int steps)
        def write_ring():
            cx = jnp.sum(f["px"] * f["val"]) / f32(params.n_cells)
            cy = jnp.sum(f["py"] * f["val"]) / f32(params.n_cells)
            ring_idx = (ts.step // cog_gate_steps) % params.centroid_steps
            return jax.lax.dynamic_update_slice(
                ts.centroid_ring,
                jnp.stack([cx, cy])[None, :],
                (ring_idx, 0),
            )

        if cog_gate is False:
            ring = ts.centroid_ring
        else:
            ring = jax.lax.cond(cog_gate, write_ring, lambda: ts.centroid_ring)

        # 3. phase controller (1/phase_update_interval steps, under cond —
        #    the raycast + noise draw actually only run on gate steps; the
        #    (N, 2) position stack lives INSIDE the branch so off steps
        #    don't even pay the interleave)
        if params.control == Control.LIGHT_WAVE and phase_gate is not False:

            def do_phase():
                if phase_fn is not None:
                    return phase_fn(f, val, jax.random.fold_in(step_key, 1))
                pos_t = jnp.stack([f["px"], f["py"]], axis=-1)
                return update_phase(
                    params, pos_t, f["phase"], val,
                    jax.random.fold_in(step_key, 1),
                )

            f["phase"] = jax.lax.cond(phase_gate, do_phase, lambda: f["phase"])

        # 4+5. radius controller (previous step's force magnitudes) +
        #    integrate/boundary in component form (the flat px/py planes
        #    never interleave into (n, 2) on the per-step path)
        f = radius_integrate_planes(params, f, time)

        return ts._replace(fields=f, centroid_ring=ring)

    def step_post(ts: TableState) -> TableState:
        f = dict(ts.fields)

        # 7. collide: the force pass reads the flat field arrays directly
        with jax.named_scope("table_forces"):
            fx, fy, fa, fr = table_forces(params, f, g, g, gg, 0, gg)
        pad = total_ext - force_total  # spill rows + parking get zero force
        zpad = jnp.zeros((pad,), f32)
        fxf = jnp.concatenate([fx.reshape(force_total), zpad])
        fyf = jnp.concatenate([fy.reshape(force_total), zpad])
        f["aa"] = jnp.concatenate([fa.reshape(force_total), zpad])
        f["ar"] = jnp.concatenate([fr.reshape(force_total), zpad])

        # note: read geometry from f (the rebuild may have relocated rows)
        val_r = f["val"] > 0.5
        if params.circle_obstacles or params.rect_obstacles:
            pos_r = jnp.stack([f["px"], f["py"]], axis=-1)
            vel_r = jnp.stack([f["vx"], f["vy"]], axis=-1)
            f_obs, m_obs = obstacle_forces(params, pos_r, vel_r, f["rad"])
            fxf = fxf + f_obs[..., 0]
            fyf = fyf + f_obs[..., 1]
            f["ar"] = f["ar"] + m_obs

        nvx, nvy = friction_velocity_update_xy(
            params, f["vx"], f["vy"], fxf, fyf, f["pay"] > 0.5, dt
        )
        f["vx"] = jnp.where(val_r, nvx, 0.0)
        f["vy"] = jnp.where(val_r, nvy, 0.0)

        return ts._replace(fields=f, step=ts.step + 1)

    return step_pre, step_post


def make_table_step(params: SimParams, phase_fn=None):
    """One physics step on a TableState; op order == engine.make_step."""
    params = params.validate()
    step_pre, step_post = make_table_step_parts(params, phase_fn)

    def step(
        ts: TableState,
        dead_gate: jax.Array,
        cog_gate: jax.Array,
        phase_gate: jax.Array,
        rebuild_gate: jax.Array,
    ) -> TableState:
        ts = step_pre(ts, dead_gate, cog_gate, phase_gate)

        # slot rebuild (every slot_rebuild_steps): placed HERE — after
        # integrate, before collide — so the one-step-lag force carry is
        # already consumed and needn't be moved, and the collide right
        # after sees the freshest possible assignment.  rebuild_gate may
        # be a STATIC python bool: the run-chunk loop unrolls blocks of
        # k steps whose last step always rebuilds, because a traced
        # lax.cond here routes the whole TableState through the branch
        # even when it never fires.
        if rebuild_gate is True:
            ts = _rebuild(params, ts)
        elif rebuild_gate is not False:
            ts = jax.lax.cond(
                rebuild_gate,
                lambda t: _rebuild(params, t),
                lambda t: t,
                ts,
            )
        return step_post(ts)

    return step


def _chunk_schedule(step_at, step_of, k: int, seg: int, unroll_body: bool,
                    scan_unroll: int):
    """(run, block_at): the rebuild/gate schedule of a table-loop chunk,
    shared by the single-scene and batched loops, which differ only in
    ``step_at(ts, rebuild_gate, gated=True)`` (one physics step; the
    rebuild gate is a static bool or a traced scalar) and ``step_of(ts)``
    (the scalar step counter).

    Blocks of k steps whose LAST step rebuilds statically (no traced
    rebuild cond in the scan body — see the note in make_table_step).  The
    schedule is chunk-relative: chunk entry re-anchors + reassigns anyway,
    so assignment staleness stays <= k-1 steps regardless of the chunk's
    starting step.  Unrolled only for small k; a huge k (exact per-chunk
    mode or ablations) scans single steps with a traced rebuild gate."""
    unroll_blocks = 1 < k <= 8

    def plain(ts, _):
        return step_at(ts, False), None

    def plain_u(ts, _):
        return step_at(ts, False, gated=False), None

    def block_at(ts, first_gated: bool):
        """One k-step rebuild block; only its first step (a potential gate
        step in the segment schedule) checks the interval conds."""
        if unroll_body:
            for j in range(k):
                ts = step_at(ts, j == k - 1, gated=first_gated and j == 0)
        elif k > 1 and not first_gated:
            # ungated block: fold the entry step into the inner scan — one
            # fewer compiled step instance per large-table body
            ts, _ = jax.lax.scan(plain_u, ts, None, length=k - 1)
            ts = step_at(ts, True, gated=False)
        else:
            ts = step_at(ts, k == 1, gated=first_gated)
            if k > 1:
                if k > 2:
                    ts, _ = jax.lax.scan(plain_u, ts, None, length=k - 2)
                ts = step_at(ts, True, gated=False)
        return ts

    def run(ts, n_steps: int, seg_aligned: bool):
        use_seg = seg_aligned and seg > 0 and (k == 1 or unroll_blocks)
        n_segs, n_rem = divmod(n_steps, seg) if use_seg else (0, n_steps)
        if n_segs:
            bps = seg // k

            def ublock(ts, _):
                return block_at(ts, False), None

            def seg_body(ts, _):
                ts = block_at(ts, True)
                if bps > 1:
                    ts, _ = jax.lax.scan(
                        ublock, ts, None, length=bps - 1, unroll=scan_unroll
                    )
                return ts, None

            ts, _ = jax.lax.scan(seg_body, ts, None, length=n_segs)

        # remainder (and the whole chunk when not seg-aligned): traced
        # per-step gates
        if n_rem:
            if k == 1:
                def body(ts, _):
                    return step_at(ts, True), None

                ts, _ = jax.lax.scan(body, ts, None, length=n_rem)
            elif unroll_blocks:
                n_blocks, rem = divmod(n_rem, k)

                def block(ts, _):
                    if unroll_body:
                        for j in range(k):
                            ts = step_at(ts, j == k - 1)
                    else:
                        ts, _ = jax.lax.scan(plain, ts, None, length=k - 1)
                        ts = step_at(ts, True)
                    return ts, None

                if n_blocks:
                    ts, _ = jax.lax.scan(block, ts, None, length=n_blocks)
                if rem:
                    ts, _ = jax.lax.scan(plain, ts, None, length=rem)
            else:
                # k > 8: traced rebuild gate on the absolute step;
                # unrolling such blocks would bloat the compiled body
                def body(ts, _):
                    return step_at(ts, step_of(ts) % k == k - 1), None

                ts, _ = jax.lax.scan(body, ts, None, length=n_rem)
        return ts

    return run, block_at


def make_run_chunk_table(params: SimParams, phase_fn=None):
    """Drop-in replacement for engine.make_run_chunk on the PALLAS backend:
    ``run_chunk(state, n_steps, seg_aligned=False) -> state`` with
    table-resident stepping.

    ``seg_aligned`` (static) asserts that ``state.step`` is a multiple of
    ``gate_seg(params)`` (the gcd of all interval-gate periods, 200 steps
    at reference defaults).  The chunk then scans gate segments: only the
    FIRST step of each segment carries the traced interval conds, the
    other ``seg-1`` step instances are statically ungated — interval
    semantics are bit-identical (non-seg-multiple steps can never fire a
    gate) and the cond-presence cost amortizes to 1/seg.  Callers must
    pass True only when the entry step really is seg-aligned
    (Simulation.run checks host-side).

    ``phase_fn`` is the packed-sweep phase hook (see
    make_table_step_parts); it only ever runs inside gated step
    instances."""
    params = params.validate()
    step = make_table_step(params, phase_fn)
    k = max(1, params.resolved_slot_rebuild_steps())
    seg = gate_seg(params)
    total_rows = _geometry(params)[0]
    unroll_body = _unroll_body_default(total_rows)
    # small tables are dominated by fixed per-step costs (launches, scan
    # boundary): unroll the gateless inner scan to amortize them.  Larger
    # tables only pay compile time for it.
    scan_unroll = 4 if total_rows <= (1 << 13) else 1

    def step_at(ts: TableState, rebuild_gate, gated: bool = True):
        gates = _gates(params, ts.step) if gated else (False, False, False)
        return step(ts, *gates, rebuild_gate)

    schedule, _ = _chunk_schedule(
        step_at, lambda ts: ts.step, k, seg, unroll_body, scan_unroll
    )

    @functools.partial(jax.jit, static_argnums=(1, 2), donate_argnums=0)
    def run_chunk(
        state: SimState, n_steps: int, seg_aligned: bool = False
    ) -> SimState:
        ts = schedule(enter_table(params, state), n_steps, seg_aligned)
        return exit_table(params, ts)

    return run_chunk


# Missed-magnet-force budget for the speed-certified cadence: an uncovered
# closing pair may enter the magnet tail before the next rebuild; the
# certificate bounds the largest force such a pair could have been owed to
# this fraction of the plateau MAGNET_MIN_ATTR (2.5).  At 1% the miss is
# orders of magnitude below contact-range forces and transient by
# construction.
MISSED_MAGNET_FRACTION = 0.01


def certified_closing_bound(params: SimParams, k: int) -> float:
    """Max pair-closing speed (u/s) under which a ``k``-step slot-reuse
    window is SAFE, derived from the table geometry instead of folklore:

    a pair not covered by the 3x3 stale window has an axis gap > one
    binning cell ``h = cutoff()`` at assignment, hence ``dist > h``.
    Within the window (≤ k-1 steps of staleness) it closes at most
    ``c * (k-1) * dt``.  The bound guarantees two things:

    * **no contact loss** — it cannot reach touching distance
      (``2 * max radius``), and
    * **bounded magnet miss** — it cannot get close enough that the
      inverse-square tail it is owed exceeds ``MISSED_MAGNET_FRACTION`` of
      the plateau force: gap stays above
      ``sqrt(attraction / (fraction * MAGNET_MIN_ATTR))``.

    With reference defaults: h = 0.517, touch = 0.235, tail margin =
    0.044 -> bound(8) = 3.4 u/s, bound(4) = 7.9 u/s.  (The K=4 default's
    own documented currency, 2.3 u/s against 2x max bot speed ~2.2, is
    strictly more conservative than this certificate — the certificate
    quantifies what that heuristic was protecting.)"""
    from .ops.forces import MAGNET_MIN_ATTR

    h = params.cutoff()
    r_max = params.max_radius
    if params.has_payload:
        r_max = max(r_max, params.min_radius * params.rad_factor)
    touch = params.max_radius + r_max
    attr = params.attraction
    if params.has_payload and params.attraction_factor > 1.0:
        attr = attr * params.attraction_factor ** 2
    tail = (attr / (MISSED_MAGNET_FRACTION * MAGNET_MIN_ATTR)) ** 0.5
    slack = h - touch - tail
    window = max(1, k - 1) * params.timestep
    return max(0.0, slack / window)


def neighbor_rel_speed_bound(params: SimParams, fields: dict) -> jax.Array:
    """Scalar f32 upper bound on the max pair-closing speed among bots in
    each other's 3x3 cell neighborhood — the quantity the slot-reuse
    contact margin is stated in.

    Per-cell [min, max] velocity envelopes over occupied rows (incl. spill
    slots), widened to the 3x3 window with the same wrapped neighbour
    lanes the force pass reads, then ``max over cells of hypot(dvx,
    dvy)``: for ANY two bots i, j within a window, ``closing(i,j) = (v_i -
    v_j) . n <= |v_i - v_j| <= hypot(dvx, dvy)`` of that window.  Parked
    bots are excluded (they exert/feel no pair forces by construction).
    Cost: a few plane reductions + 8 gathers of (G*G,) vectors."""
    g = params.resolved_grid_dim()
    gg = g * g
    lane = jnp.arange(gg, dtype=jnp.int32)
    total = gg * params.storage_capacity()
    val = fields["val"][:total].reshape(-1, gg) > 0.5
    big = jnp.float32(1.0e9)
    dvs = []
    for comp in ("vx", "vy"):
        v = fields[comp][:total].reshape(-1, gg)
        cmax = jnp.max(jnp.where(val, v, -big), axis=0)   # (gg,)
        cmin = jnp.min(jnp.where(val, v, big), axis=0)
        wmax, wmin = cmax, cmin
        for dx, dy in OFFSETS9[1:]:
            nl = neighbor_lanes(lane, g, g, dx, dy)
            wmax = jnp.maximum(wmax, cmax[nl])
            wmin = jnp.minimum(wmin, cmin[nl])
        # windows with < 2 bots leave +-big sentinels -> clamp at 0
        dvs.append(jnp.maximum(wmax - wmin, 0.0))
    return jnp.max(jnp.sqrt(dvs[0] * dvs[0] + dvs[1] * dvs[1]))


def make_probe_chunk(params: SimParams, phase_fn=None):
    """``probe_chunk(state) -> (state_after_seg, probe_max)``: advance
    exactly one gate segment (``gate_seg(params)`` steps) on the SAME
    segment schedule the production chunk uses (interval conds traced on
    the segment's first step only — value-identical stepping, and the
    amortized-cond fast path's cost profile) while accumulating the max of
    :func:`neighbor_rel_speed_bound` sampled right after every slot
    rebuild (each sample bounds the closing speeds of the upcoming reuse
    window).  The adaptive driver opens every seg-aligned chunk with this;
    callers must enter on a seg boundary (the driver guarantees it)."""
    params = params.validate()
    step = make_table_step(params, phase_fn)
    k = max(1, params.resolved_slot_rebuild_steps())
    seg = gate_seg(params)
    if seg <= 0 or seg % k:
        raise ValueError(
            "probe chunk requires the gate-segment schedule (gate_seg > 0 "
            f"and k | seg; got seg={seg}, k={k})"
        )
    unroll_body = _unroll_body_default(_geometry(params)[0])

    def step_at(ts, rebuild, gated=True):
        gates = _gates(params, ts.step) if gated else (False, False, False)
        return step(ts, *gates, rebuild)

    # the production chunk's k-step block: only a segment's first step
    # carries the traced conds
    _, kblock = _chunk_schedule(
        step_at, lambda ts: ts.step, k, seg, unroll_body, 1
    )

    @functools.partial(jax.jit, donate_argnums=0)
    def probe_chunk(state: SimState):
        ts = enter_table(params, state)
        pm = neighbor_rel_speed_bound(params, ts.fields)

        ts = kblock(ts, True)
        pm = jnp.maximum(pm, neighbor_rel_speed_bound(params, ts.fields))

        def rest_block(carry, _):
            ts, pm = carry
            ts = kblock(ts, False)
            pm = jnp.maximum(pm, neighbor_rel_speed_bound(params, ts.fields))
            return (ts, pm), None

        if seg // k > 1:
            (ts, pm), _ = jax.lax.scan(
                rest_block, (ts, pm), None, length=seg // k - 1
            )
        return exit_table(params, ts), pm

    return probe_chunk


def make_adaptive_run_chunk(params: SimParams, phase_fn=None):
    """Speed-certified adaptive rebuild cadence — the ``slot_rebuild_steps
    = -1`` auto mode on large tables (config.adaptive_rebuild).

    Mechanism: every seg-aligned chunk opens with one probe segment (200
    steps at reference gates, on the production segment schedule) at the
    CURRENT cadence, measuring an upper bound on the max pair-closing
    speed (:func:`neighbor_rel_speed_bound`, sampled at every rebuild).
    The cadence for the NEXT chunk is K=8 iff the measured bound stays
    within :func:`certified_closing_bound` for K=8 (3.4 u/s at reference
    defaults) — a geometry-derived certificate that uncovered pairs can
    neither reach contact nor be owed more than 1% of the plateau magnet
    force within the doubled window.  The probe scalar is fetched LAZILY
    at the next chunk boundary, so the host round-trip overlaps the
    chunk's own compute instead of serializing it;
    detection latency is therefore one chunk, against a margin stated for
    worst-case closing over 8 steps and measured 2.7-3.2 u/s in steady
    phototaxis (10k) vs 20+ during transients.

    The trajectory semantics are the established chunk-boundary contract
    (chunk splits reproduce bit-for-bit; K only changes float summation
    order through slot assignment, never the pair set, while the margin
    holds).  Returned runner matches ``run_chunk(state, n_steps,
    seg_aligned=False)``; chunks that cannot take the segment schedule
    (unaligned entry, short/ragged chunks) run the base K=4 path.
    ``runner.live["k"]`` / ``runner.last_probe`` expose the live cadence
    and last measured bound for tests and telemetry."""
    import numpy as np

    base = params.validate()
    p4 = base.replace(slot_rebuild_steps=4)
    p8 = base.replace(slot_rebuild_steps=8)
    seg = gate_seg(p4)
    seg_ok = seg > 0 and gate_seg(p8) == seg
    bound8 = certified_closing_bound(base, 8)
    seg_ok = seg_ok and bound8 > 0.0
    runners: dict = {}
    probes: dict = {}
    live = {"k": 4}

    def get_runner(k):
        if k not in runners:
            runners[k] = make_run_chunk_table(
                p4 if k == 4 else p8, phase_fn=phase_fn
            )
        return runners[k]

    def get_probe(k):
        if k not in probes:
            probes[k] = make_probe_chunk(p4 if k == 4 else p8, phase_fn)
        return probes[k]

    def runner(state: SimState, n_steps: int, seg_aligned: bool = False):
        if (
            not seg_ok
            or not seg_aligned
            or n_steps < seg
            or n_steps % seg
        ):
            return get_runner(4)(state, n_steps, seg_aligned)
        if runner._pending is not None:
            # the PREVIOUS chunk's probe: long since computed on device, so
            # this fetch overlaps that chunk's remaining compute instead of
            # inserting a synchronous round-trip per chunk
            pm = float(np.asarray(jax.device_get(runner._pending)))
            runner.last_probe = pm
            live["k"] = 8 if pm <= bound8 else 4
        state, runner._pending = get_probe(live["k"])(state)
        rest = n_steps - seg
        if rest:
            state = get_runner(live["k"])(state, rest, True)
        return state

    runner.live = live
    runner.last_probe = None
    runner._pending = None
    runner.path_info = {"adaptive": True, "gate_seg": seg, "bound8": bound8}
    return runner


def make_run_chunk_table_batched(params: SimParams):
    """Batched (scene-axis) table-resident loop for sweeps / multi-chip dp.

    Scenes must advance in lockstep (all APIs that build batches start every
    scene at the same step and step them together); the interval gates use
    scene 0's counter so they stay scalar ``lax.cond``s instead of decaying
    to computed-and-discarded selects under vmap.
    """
    params = params.validate()
    step_pre, step_post = make_table_step_parts(params)
    k = max(1, params.resolved_slot_rebuild_steps())
    venter = jax.vmap(lambda s: enter_table(params, s))
    vexit = jax.vmap(lambda t: exit_table(params, t))
    # gates stay unmapped scalars -> real conds inside the vmapped halves;
    # the rebuild runs BETWEEN the vmapped halves so a traced rebuild gate
    # (k > 8) stays a scalar cond
    vpre = jax.vmap(step_pre, in_axes=(0, None, None, None))
    vpost = jax.vmap(step_post)
    vrebuild = jax.vmap(lambda t: _rebuild(params, t))
    unroll_body = _unroll_body_default(_geometry(params)[0])

    def step_at(ts: TableState, rebuild, gated: bool = True):
        gates = _gates(params, ts.step[0]) if gated else (False, False, False)
        ts = vpre(ts, *gates)
        if rebuild is True:
            ts = vrebuild(ts)
        elif rebuild is not False:
            ts = jax.lax.cond(rebuild, vrebuild, lambda t: t, ts)
        return vpost(ts)

    schedule, _ = _chunk_schedule(
        step_at, lambda ts: ts.step[0], k, gate_seg(params), unroll_body, 1
    )

    @functools.partial(jax.jit, static_argnums=(1, 2), donate_argnums=0)
    def run_chunk(
        state: SimState, n_steps: int, seg_aligned: bool = False
    ) -> SimState:
        return vexit(schedule(venter(state), n_steps, seg_aligned))

    return run_chunk
