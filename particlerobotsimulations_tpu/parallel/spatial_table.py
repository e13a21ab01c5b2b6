"""Single-scene spatial decomposition of the TABLE-resident loop.

The bot-axis `shard_map` path (parallel/spatial.py) demonstrates tensor
parallelism with dense O(N^2) pair forces — fine for its role as the small
-scene reference implementation, but it cannot scale a single large scene.
This module shards the PRODUCTION formulation instead: the slot-major cell
table's grid ROWS are partitioned across the mesh, so device ``d`` owns a
contiguous lane block (``R = G/D`` grid rows) of every ``(C, G*G)`` plane
and all per-step compute is local except:

* **forces** — each shard exchanges its boundary grid row with its ring
  neighbors (``ppermute``, which XLA hands to NCCL), then runs the force
  kernel (ops/pallas_stencil.table_forces) on the halo-extended table:
  the kernel writes only its own targets' forces, so nothing ever needs
  to travel back across the boundary;
* **slot rebuilds** — every ``slot_rebuild_steps`` the shards all-gather
  the table and run the single-chip rebuild (argsort, replicated), then
  keep their own lane blocks;
* **reductions** — ``pmin`` for the phase law's min light distance,
  ``psum`` for the centroid, an all-gathered ``top_k`` for dead-cell
  injection (reference semantics: particlebot.cpp:178-194, 212-232).

Capacity-overflow "parked" bots live in a REPLICATED parking strip: every
shard integrates them identically (they exert no pair forces), and they
are reinstated by the rebuilds / chunk entries, exactly like the
single-chip loop.

Geometry constraint: ``D | G``, so every shard owns whole grid rows;
``resolve_tp_params`` rounds the auto grid up to a compatible size.

RNG-stream deviation: phase noise and dead-injection scores are drawn from
per-shard streams (``fold_in(step_key, 1/7)`` then ``fold_in(d)``), so with
``phase_std > 0`` or ``n_dead > 0`` sharded trajectories are distribution
-identical but sample-divergent from the single-chip loop AND change with
device count.  This mirrors the relationship the single-chip table loop
already has to the per-bot engine (per-slot vs per-bot stream shapes,
engine_table module docstring) and the reference's host ``rand()`` to both.
Listed in README "Deviations"; use ``phase_std=0``/``n_dead=0`` for exact
cross-topology comparisons.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import Control, SimParams
from ..engine_table import (
    TABLE_FIELDS,
    TableState,
    _gates,
    _geometry,
    _rebuild_fields,
    enter_table,
    exit_table,
)
from ..ops.forces import friction_velocity_update_xy, obstacle_forces
from ..ops.integrate import radius_integrate_planes
from ..ops.pallas_stencil import kernel_fields, table_forces
from ..ops.phase import light_distance, update_phase
from ..state import SimState


def resolve_tp_params(params: SimParams, n_shards: int) -> SimParams:
    """Round the grid up until every shard owns whole grid rows."""
    params = params.validate()
    g = params.resolved_grid_dim()
    while g % n_shards:
        g += 1
    return params.replace(grid_dim=g)


def make_sharded_table_run(
    params: SimParams, mesh: Mesh, axis: str = "bots",
    with_stats: bool = False,
):
    """(run_chunk, resolved_params): the table-resident loop sharded over
    ``mesh``'s ``axis``.  ``run_chunk(state, n_steps)`` takes and returns a
    replicated bot-order SimState (the sharded table lives only inside).

    ``with_stats=True`` makes ``run_chunk`` return ``(state, stats)`` with
    an in-run counter accumulated inside the scan (a replicated scalar):
    ``spill_rows_max`` — the per-step maximum number of occupied
    overflow-spill rows across all shards (0 when the table has no
    spill).  Used by ``__graft_entry__.dryrun_multichip`` to PROVE the
    spill path was exercised."""
    D = int(np.prod([s for n, s in zip(mesh.axis_names, mesh.devices.shape) if n == axis]))
    params = resolve_tp_params(params, D)
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    cs = params.storage_capacity()
    gg = g * g
    L0 = gg // D                 # lanes (cells) per shard
    H = g                        # halo lanes per side: one grid row
    ext_len = L0 + 2 * H
    center_len = cs * L0         # local table rows (flat)
    total, total_ext, n_pad = _geometry(params)
    kfields = kernel_fields(params)
    k_rb = max(1, params.resolved_slot_rebuild_steps())
    dt = params.timestep
    f32 = jnp.float32
    fwd = [(i, (i + 1) % D) for i in range(D)]
    bwd = [(i, (i - 1) % D) for i in range(D)]

    def halo_exchange(x):
        """(..., L0) -> (..., L0 + 2H): ring-exchange boundary grid rows
        (shard 0's previous row is shard D-1's last — the table's modular
        wrap rides the ring)."""
        from_prev = jax.lax.ppermute(x[..., -g:], axis, fwd)
        from_next = jax.lax.ppermute(x[..., :g], axis, bwd)
        return jnp.concatenate([from_prev, x, from_next], axis=-1)

    def split_local(fields, d):
        """Global (total_ext,) fields -> this shard's local flat dict."""
        out = {}
        for k in TABLE_FIELDS:
            v = fields[k]
            center = jax.lax.dynamic_slice(
                v[:total].reshape(cs, gg), (0, d * L0), (cs, L0)
            ).reshape(center_len)
            out[k] = jnp.concatenate([center, v[total:]])
        return out

    def join_global(f):
        """All-gather shard centers -> replicated global fields dict."""
        out = {}
        for k in TABLE_FIELDS:
            c = f[k][:center_len].reshape(cs, L0)
            gathered = jax.lax.all_gather(c, axis)          # (D, cs, L0)
            glob = jnp.transpose(gathered, (1, 0, 2)).reshape(total)
            out[k] = jnp.concatenate([glob, f[k][center_len:]])
        return out

    def sharded_rebuild(f, d):
        """All-gather the shard tables, run the single-chip rebuild
        replicated, keep this shard's lane block."""
        gf, origin = _rebuild_fields(params, join_global(f))
        return split_local(gf, d), origin

    def step_local(f, step, key, ring, origin, d, rebuild, stats):
        """One physics step on the shard-local fields; op order ==
        engine_table.make_table_step (== the reference).  ``stats`` is
        either None or the spill_rows_max int32 counter (with_stats
        mode)."""
        time = step.astype(f32) * f32(dt)
        step_key = jax.random.fold_in(key, step)
        val = f["val"] > 0.5
        dead_g, cog_g, phase_g = _gates(params, step)

        # 1. dead injection (global top_k over gathered scores; parking
        #    scores come from a shared stream so the replicated strip
        #    stays replicated)
        if params.n_dead > 0:
            def inject(dead):
                kc = jax.random.fold_in(jax.random.fold_in(step_key, 7), d)
                kp = jax.random.fold_in(step_key, 8)
                scores = jnp.concatenate(
                    [
                        jax.random.uniform(kc, (center_len,)),
                        jax.random.uniform(kp, (n_pad,)),
                    ]
                )
                alive = val & (dead < 0.5)
                scores = jnp.where(alive, scores, jnp.inf)
                gc = jax.lax.all_gather(scores[:center_len], axis).reshape(-1)
                gall = jnp.concatenate([gc, scores[center_len:]])
                _, kill = jax.lax.top_k(-gall, params.n_dead)
                killed = jnp.zeros(gall.shape, bool).at[kill].set(True)
                mine = jnp.concatenate(
                    [
                        jax.lax.dynamic_slice(
                            killed, (d * center_len,), (center_len,)
                        ),
                        killed[D * center_len :],
                    ]
                )
                return jnp.where(mine, 1.0, dead)

            f["dead"] = jax.lax.cond(dead_g, inject, lambda x: x, f["dead"])

        # 2. centroid ring (pre-integrate positions; psum over shard
        #    centers + the replicated parking contribution once)
        def write_ring(r):
            cx = jax.lax.psum(
                jnp.sum(f["px"][:center_len] * f["val"][:center_len]), axis
            ) + jnp.sum(f["px"][center_len:] * f["val"][center_len:])
            cy = jax.lax.psum(
                jnp.sum(f["py"][:center_len] * f["val"][:center_len]), axis
            ) + jnp.sum(f["py"][center_len:] * f["val"][center_len:])
            c = jnp.stack([cx, cy]) / f32(params.n_cells)
            idx = (step // params.centroid_steps_interval) % params.centroid_steps
            return jax.lax.dynamic_update_slice(r, c[None, :], (idx, 0))

        ring = jax.lax.cond(cog_g, write_ring, lambda r: r, ring)

        # 3. phase law: min distance is a pmin over shard centers
        if params.control == Control.LIGHT_WAVE:
            def do_phase(p):
                pos = jnp.stack([f["px"], f["py"]], axis=-1)
                dist = light_distance(params, pos)
                dmin = jnp.minimum(
                    jax.lax.pmin(
                        jnp.min(
                            jnp.where(
                                val[:center_len], dist[:center_len], jnp.inf
                            )
                        ),
                        axis,
                    ),
                    jnp.min(
                        jnp.where(val[center_len:], dist[center_len:], jnp.inf)
                    ),
                )
                kc = jax.random.fold_in(jax.random.fold_in(step_key, 1), d)
                kp = jax.random.fold_in(step_key, 2)
                pc = update_phase(
                    params, pos[:center_len], p[:center_len],
                    val[:center_len], kc, min_d=dmin,
                )
                pp = update_phase(
                    params, pos[center_len:], p[center_len:],
                    val[center_len:], kp, min_d=dmin,
                )
                return jnp.concatenate([pc, pp])

            f["phase"] = jax.lax.cond(phase_g, do_phase, lambda p: p, f["phase"])

        # 4+5. radius controller + integrate/boundary — the shared
        # expression-shape-pinned plane form (ops/integrate.py), local
        # elementwise per shard
        f = radius_integrate_planes(params, f, time)

        # 6. slot rebuild (static schedule, between integrate and collide)
        if rebuild is True:
            f, origin = sharded_rebuild(f, d)
        elif rebuild is not False:
            f, origin = jax.lax.cond(
                rebuild,
                lambda fo: sharded_rebuild(fo[0], d),
                lambda fo: fo,
                (f, origin),
            )

        # 7. collide: halo exchange + the force pass on the extended table
        #    (targets are this shard's lanes [H, H + L0))
        ext = halo_exchange(
            jnp.stack([f[k][:center_len].reshape(cs, L0)[:cap] for k in kfields])
        )
        fx, fy, fa, fr = table_forces(
            params,
            {k: ext[j].reshape(cap * ext_len) for j, k in enumerate(kfields)},
            g, ext_len // g, ext_len, H, L0,
        )

        def expand(a):
            """(cap, L0) kernel output -> (local_len,): spill rows and
            the parking strip feel no pair forces."""
            fullc = jnp.concatenate(
                [a, jnp.zeros((cs - cap, L0), f32)], axis=0
            )
            return jnp.concatenate(
                [fullc.reshape(center_len), jnp.zeros((n_pad,), f32)]
            )

        fxf, fyf = expand(fx), expand(fy)
        f["aa"], f["ar"] = expand(fa), expand(fr)

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
        if stats is not None and cs > cap:
            # occupied overflow-spill rows across all shards, this
            # step — the max over steps certifies spill rows really held
            # bots during the run
            spill = jax.lax.psum(
                jnp.sum(
                    f["val"][:center_len].reshape(cs, L0)[cap:] > 0.5
                ).astype(jnp.int32),
                axis,
            )
            stats = jnp.maximum(stats, spill)
        return f, step + 1, ring, origin, stats

    def chunk_body(state: SimState, n_steps: int) -> SimState:
        d = jax.lax.axis_index(axis)
        ts = enter_table(params, state)  # replicated compute
        f = split_local(ts.fields, d)

        def step_at(carry, rebuild):
            f, step, ring, origin, stats = carry
            f, step, ring, origin, stats = step_local(
                f, step, ts.key, ring, origin, d, rebuild, stats
            )
            return (f, step, ring, origin, stats)

        stats0 = jnp.int32(0) if with_stats else None
        carry = (f, ts.step, ts.centroid_ring, ts.origin, stats0)
        if k_rb == 1:
            def body(c, _):
                return step_at(c, True), None

            carry, _ = jax.lax.scan(body, carry, None, length=n_steps)
        elif k_rb <= 8:
            n_blocks, rem = divmod(n_steps, k_rb)
            # mirror engine_table's compile-size guard: above 2^20 local
            # table rows, scan the k-1 plain steps instead of unrolling k
            # force-pass instances into one scan body
            unroll_body = center_len <= (1 << 20)

            def plain(c, _):
                return step_at(c, False), None

            def block(c, _):
                if unroll_body:
                    for j in range(k_rb):
                        c = step_at(c, j == k_rb - 1)
                else:
                    c, _ = jax.lax.scan(plain, c, None, length=k_rb - 1)
                    c = step_at(c, True)
                return c, None

            if n_blocks:
                carry, _ = jax.lax.scan(block, carry, None, length=n_blocks)
            for _ in range(rem):
                carry = step_at(carry, False)
        else:
            def body(c, _):
                return step_at(c, c[1] % k_rb == k_rb - 1), None

            carry, _ = jax.lax.scan(body, carry, None, length=n_steps)

        f, step, ring, origin, stats = carry
        gf = join_global(f)
        out = exit_table(
            params,
            TableState(
                fields=gf, origin=origin, step=step, key=ts.key,
                centroid_ring=ring,
            ),
        )
        if with_stats:
            # replicated scalar: spill counts are psum'd — identical on
            # every shard
            return out, {"spill_rows_max": stats}
        return out

    @functools.partial(jax.jit, static_argnums=1)
    def run_chunk(state: SimState, n_steps: int):
        fn = shard_map(
            functools.partial(chunk_body, n_steps=n_steps),
            mesh=mesh,
            in_specs=(P(),),
            out_specs=(P(), P()) if with_stats else P(),
            check_vma=False,
        )
        return fn(state)

    run_chunk.chunk_body = chunk_body  # reused by the dp x tp composition
    return run_chunk, params


def make_sharded_table_run_batched(
    params: SimParams,
    mesh: Mesh,
    axis: str = "bots",
    batch_axis: str = "data",
):
    """Composed dp x tp on the TABLE loop: a lockstep scene batch sharded
    over ``batch_axis`` while each scene's table grid rows shard over
    ``axis`` — the production formulation on a 2-D mesh.

    ``run_chunk(batch_state, n_steps)`` takes a SimState pytree with a
    leading scene axis (build it with parallel.sweep.make_batch_state on
    the RESOLVED params this returns) whose length is a multiple of the
    ``batch_axis`` size, and returns it advanced.  The per-scene chunk
    body is vmapped over each data shard's local scenes inside one
    ``shard_map`` over the full 2-D mesh; its interval/rebuild conds decay
    to selects under vmap (both branches execute), trading the single
    -scene loop's cond economics for scene throughput — the dp trade every
    batched path in this package makes."""
    run, params = make_sharded_table_run(params, mesh, axis=axis)
    body = run.chunk_body

    @functools.partial(jax.jit, static_argnums=1)
    def run_chunk(batch_state: SimState, n_steps: int) -> SimState:
        fn = shard_map(
            jax.vmap(functools.partial(body, n_steps=n_steps)),
            mesh=mesh,
            in_specs=(P(batch_axis),),
            out_specs=P(batch_axis),
            check_vma=False,
        )
        return fn(batch_state)

    return run_chunk, params
