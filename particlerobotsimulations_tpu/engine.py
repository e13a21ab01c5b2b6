"""Simulation engine: the jitted per-step pipeline and scan loop.

JAX re-design of ``Particlebot::update``
(/root/reference/particlebot.cpp:170-300).  One ``step`` call is one physics
step of ``timestep`` seconds; the op order matches the reference exactly:

  1. dead-cell injection at ``time_to_dead``   (particlebot.cpp:178-194)
  2. centroid tracking every ``centroid_int``  (particlebot.cpp:207-209)
  3. phase update every ``phase_update_interval`` + gaussian noise
                                               (particlebot.cpp:211-237)
  4. force-limited radius update (uses *previous* step's force magnitudes —
     the one-step-lag feedback loop)           (particlebot.cpp:238-242)
  5. position integrate + boundary clamp       (particlebot.cpp:246-252)
  6. neighbor collide -> new velocity + force magnitudes
                                               (particlebot.cpp:256-296)

Improvements over the reference (documented deviations, not bugs):
* interval gating by integer step counters instead of float ``mod`` — exact,
  no drift (reference gates at particlebot.cpp:207/212/256 are float).
* the min-distance reduction for the phase law runs on-device; the reference
  round-trips positions to the host every phase update
  (particlebot.cpp:214-228).
* neighbor structure is rebuilt every step (exact) instead of the
  stale-sort + 5x5 scan compensation; see ops/grid.py.
* colors are not computed in the hot loop (render-only state).

The whole loop lives inside ``lax.scan`` under ``jit`` — zero host syncs
between dumps.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import jax
import jax.numpy as jnp

from .config import Control, ForceBackend, SimParams, padded_n
from .ops.actuation import update_radius
from .ops.forces import dense_collide
from .ops.grid import cellgrid_collide
from .ops.pallas_stencil import pallas_stencil_collide
from .ops.stencil import stencil_collide
from .ops.integrate import integrate
from .ops.phase import update_phase
from .state import SimState, active_mask, payload_mask


def _collide_fn(params: SimParams, differentiable: bool = False) -> Callable:
    backend = params.resolved_backend()
    if backend == ForceBackend.DENSE:
        return dense_collide
    if backend == ForceBackend.CELLGRID:
        return cellgrid_collide
    if backend == ForceBackend.PALLAS:
        if differentiable:
            # kernel forward + XLA-stencil backward (custom VJP)
            from .ops.pallas_stencil import make_diff_pallas_collide

            diff = make_diff_pallas_collide(params, params.timestep)

            def collide(p, pos, vel, rad, mask, payload, dt, slot=None):
                return diff(
                    pos, vel, rad,
                    mask.astype(jnp.float32), payload.astype(jnp.float32),
                )

            return collide
        return pallas_stencil_collide
    return stencil_collide


def _inject_dead(params: SimParams, state: SimState, key: jax.Array) -> jax.Array:
    """Randomly kill ``n_dead`` distinct bots (particlebot.cpp:178-194).

    The reference draws with host ``rand()``; we draw a uniform score per bot
    and kill the ``n_dead`` smallest — same uniform-without-replacement
    distribution, fully on-device.
    """
    n_pad = state.pos.shape[0]
    mask = active_mask(params, n_pad)
    scores = jax.random.uniform(key, (n_pad,))
    scores = jnp.where(mask & ~state.dead, scores, jnp.inf)
    _, kill_idx = jax.lax.top_k(-scores, params.n_dead)
    return state.dead.at[kill_idx].set(True)


def make_step(
    params: SimParams, differentiable: bool = False
) -> Callable[[SimState], SimState]:
    """Build the jittable one-step transition for a fixed scenario.

    The returned ``step`` optionally accepts a precomputed cell-slot
    assignment (``step(state, slot=...)``, PALLAS backend) — used by the
    run-chunk wrappers to amortize the assignment over
    ``slot_rebuild_steps`` steps.  ``differentiable=True`` swaps the PALLAS
    collide for its custom-VJP wrapper so ``jax.grad`` flows through the
    whole step (other backends are differentiable as-is).
    """
    params = params.validate()
    dt = params.timestep
    n_pad = padded_n(params)
    collide = _collide_fn(params, differentiable)
    is_pallas = params.resolved_backend() == ForceBackend.PALLAS
    phase_gate_steps = params.phase_update_steps
    cog_gate_steps = params.centroid_steps_interval

    def step(
        state: SimState,
        slot: jax.Array | None = None,
        gates: tuple | None = None,
    ) -> SimState:
        """``gates`` optionally supplies the (dead, cog, phase) interval
        predicates as SCALARS shared by a lockstep scene batch — the
        batched runner computes them from scene 0's counter so they stay
        real ``lax.cond``s under vmap (per-scene predicates decay to
        selects that execute the phase noise draw, shadow raycast and dead
        top_k every step).  Default: derived from this state's own
        counter."""
        mask = active_mask(params, n_pad)
        payload = payload_mask(params, n_pad)
        time = state.time(dt)
        step_key = jax.random.fold_in(state.key, state.step)
        if gates is None:
            dead_gate = (
                state.step == params.dead_step if params.n_dead > 0 else None
            )
            cog_gate = state.step % cog_gate_steps == 0
            phase_gate = state.step % phase_gate_steps == 0
        else:
            dead_gate, cog_gate, phase_gate = gates

        # 1. dead-cell injection (one-shot)
        dead = state.dead
        if params.n_dead > 0:
            dead = jax.lax.cond(
                dead_gate,
                lambda d: _inject_dead(params, state, step_key),
                lambda d: d,
                dead,
            )

        # 2. centroid ring buffer (reference ring index:
        #    (int)(time / centroid_int) % centroid_steps,
        #    particlebot_cuda.cu:245)
        def write_ring(r):
            centroid = jnp.sum(
                jnp.where(mask[:, None], state.pos, 0.0), axis=0
            ) / jnp.float32(params.n_cells)
            ring_idx = (state.step // cog_gate_steps) % params.centroid_steps
            return jax.lax.dynamic_update_slice(
                r, centroid[None, :], (ring_idx, 0)
            )

        ring = jax.lax.cond(
            cog_gate, write_ring, lambda r: r, state.centroid_ring
        )

        # 3. phase controller (interval gated; FIXED_PHASE keeps the
        #    scripted/learned offsets untouched)
        if params.control == Control.LIGHT_WAVE:
            phase = jax.lax.cond(
                phase_gate,
                lambda p: update_phase(
                    params, state.pos, p, mask,
                    jax.random.fold_in(step_key, 1),
                ),
                lambda p: p,
                state.phase,
            )
        else:
            phase = state.phase

        # 4. radius controller — consumes previous collide's force magnitudes
        rad = update_radius(
            params,
            state.rad,
            phase,
            state.abs_force_a,
            state.abs_force_r,
            dead,
            mask,
            time,
            dt,
        )

        # 5. integrate + boundary
        pos, vel = integrate(params, state.pos, state.vel, rad, dt)

        # 6. collide -> next-step velocity + force magnitudes
        if is_pallas and slot is not None:
            new_vel, abs_a, abs_r = collide(
                params, pos, vel, rad, mask, payload, dt, slot=slot
            )
        else:
            new_vel, abs_a, abs_r = collide(params, pos, vel, rad, mask, payload, dt)

        return SimState(
            pos=pos,
            vel=new_vel,
            rad=rad,
            phase=phase,
            dead=dead,
            abs_force_a=abs_a,
            abs_force_r=abs_r,
            step=state.step + 1,
            key=state.key,
            centroid_ring=ring,
        )

    return step


# Chunk runners are cached per (kind, params, construction-affecting env
# knobs, backend): SimParams is frozen/hashable, and a fresh closure per
# call would defeat jax's jit cache — every repeated make_run_chunk (e.g.
# run_sweep invoked per robustness fraction, or twice in a process) would
# re-trace and re-compile the whole chunk program.  The env knobs and the
# resolved platform are part of the key because they change the traced
# program (PBOT_UNROLL_BODY at make time, the pair-math knobs at trace
# time; AUTO backend resolution by platform).
_RUN_CHUNK_CACHE: dict = {}


def _chunk_cache_key(kind: str, params: SimParams):
    return (
        kind,
        params,
        os.environ.get("PBOT_UNROLL_BODY"),
        os.environ.get("PBOT_PAIRMATH"),
        os.environ.get("PBOT_MAGMIN"),
        # jax_platforms (not jax.default_backend()) keeps key construction
        # from initializing the JAX client as a side effect — a library
        # caller may still jax.config.update("jax_platforms", ...) after
        # building a runner
        jax.config.jax_platforms,
    )


def make_run_chunk(params: SimParams) -> Callable[[SimState, int], SimState]:
    """``run_chunk(state, n_steps)`` — n_steps of physics fused in one jitted
    ``lax.scan``; n_steps is static (one compile per distinct chunk size).

    The PALLAS backend runs the table-resident loop (engine_table.py): all
    state stays in the slot-major cell table between rebuilds, eliminating
    the per-step scatter/gather plumbing entirely."""
    key = _chunk_cache_key("single", params)
    cached = _RUN_CHUNK_CACHE.get(key)
    if cached is not None:
        return cached
    run = _make_run_chunk_uncached(params)
    while len(_RUN_CHUNK_CACHE) > 16:  # bound compiled-executable retention
        # FIFO-evict the oldest runner (dicts preserve insertion order)
        # instead of clearing: a sweep alternating many param sets keeps
        # its hot runners' XLA executables
        _RUN_CHUNK_CACHE.pop(next(iter(_RUN_CHUNK_CACHE)))
    _RUN_CHUNK_CACHE[key] = run
    return run


def _make_run_chunk_uncached(params: SimParams):
    if params.validate().resolved_backend() == ForceBackend.PALLAS:
        if params.validate().adaptive_rebuild():
            from .engine_table import make_adaptive_run_chunk

            return make_adaptive_run_chunk(params)
        from .engine_table import make_run_chunk_table

        return make_run_chunk_table(params)
    step = make_step(params)
    # (the PALLAS backend early-returned above, so there is no slot carry
    # here — DENSE/STENCIL/CELLGRID need no slot reuse)

    @functools.partial(jax.jit, static_argnums=(1, 2), donate_argnums=0)
    def run_chunk(
        state: SimState, n_steps: int, seg_aligned: bool = False
    ) -> SimState:
        # seg_aligned is accepted for signature parity with the table loop
        # (engine_table.make_run_chunk_table); on these backends the
        # interval conds are noise next to the force pass, so it is a no-op.
        del seg_aligned

        def body(s, _):
            return step(s), None

        out, _ = jax.lax.scan(body, state, None, length=n_steps)
        return out

    return run_chunk


def make_run_chunk_batched(params: SimParams) -> Callable:
    """vmapped variant: state pytree carries a leading batch axis (scenes).

    LOCKSTEP REQUIRED: every scene in the batch must share the same step
    counter — the interval gates (dead/cog/phase) are derived from scene
    0's counter only, so a batch of heterogeneous counters (e.g. scenes
    resumed from different times) would silently mis-time gating for
    scenes != 0.  All batch builders in this package (parallel/sweep.py,
    cli sweep/experiment) start every scene at step 0 and advance them
    together; assemble ad-hoc batches the same way or run them unbatched.
    """
    key = _chunk_cache_key("batched", params)
    cached = _RUN_CHUNK_CACHE.get(key)
    if cached is not None:
        return cached
    run = _make_run_chunk_batched_uncached(params)
    while len(_RUN_CHUNK_CACHE) > 16:
        _RUN_CHUNK_CACHE.pop(next(iter(_RUN_CHUNK_CACHE)))
    _RUN_CHUNK_CACHE[key] = run
    return run


def _make_run_chunk_batched_uncached(params: SimParams):
    if params.validate().resolved_backend() == ForceBackend.PALLAS:
        from .engine_table import make_run_chunk_table_batched

        return make_run_chunk_table_batched(params)
    step = make_step(params)
    # (the PALLAS backend early-returned above, so there is no slot carry
    # here — DENSE/STENCIL/CELLGRID need no slot reuse)
    # scenes advance in lockstep: interval gates use scene 0's counter so
    # they stay scalar lax.conds under vmap (see make_step's gates arg)
    vstep = jax.vmap(
        lambda s, dg, cg, pg: step(s, gates=(dg, cg, pg)),
        in_axes=(0, None, None, None),
    )

    @functools.partial(jax.jit, static_argnums=(1, 2), donate_argnums=0)
    def run_chunk(
        state: SimState, n_steps: int, seg_aligned: bool = False
    ) -> SimState:
        del seg_aligned  # signature parity with the table loop; no-op here

        def body(s, _):
            s0 = s.step[0]
            dead_gate = (
                s0 == params.dead_step if params.n_dead > 0
                else jnp.asarray(False)
            )
            cog_gate = s0 % params.centroid_steps_interval == 0
            phase_gate = s0 % params.phase_update_steps == 0
            return vstep(s, dead_gate, cog_gate, phase_gate), None

        out, _ = jax.lax.scan(body, state, None, length=n_steps)
        return out

    return run_chunk
