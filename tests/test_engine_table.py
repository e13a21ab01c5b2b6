"""Table-resident PALLAS loop (engine_table) vs the per-bot step loop.

With phase_std=0 and no dead injection the two paths compute identical
physics (the only differences are float reassociation order from the table
layout), so trajectories must agree to float32 tolerance over short runs.
RNG-bearing paths (phase noise, dead choice) differ by stream shape —
distribution-level checks only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particlerobotsimulations_tpu import Config, ForceBackend, SimParams, Simulation
from particlerobotsimulations_tpu.engine import make_step
from particlerobotsimulations_tpu.engine_table import (
    make_run_chunk_table,
    make_run_chunk_table_batched,
)


def params_(**kw):
    base = dict(
        n_cells=300, n_dead=0, seed=3, config=Config.HEX,
        force_backend=ForceBackend.PALLAS, phase_std=0.0,
        light_x=-5.0, light_y=0.0,
    )
    base.update(kw)
    return SimParams(**base)


def jitter(state, scale=1e-4):
    """Break the HEX lattice's exact tangencies: gap == 0 sits on the
    overlap/magnet branch boundary, where any 1-ulp difference between two
    compiled programs flips a +/-2.5 magnet force — not a bug, but it makes
    cross-implementation comparisons on the pristine lattice meaningless."""
    noise = scale * jax.random.normal(jax.random.key(99), state.pos.shape)
    return state._replace(pos=state.pos + noise)


def run_per_bot(p, state, n):
    """Reference path: the per-bot step with the slot-reuse carry the
    round-1 engine used (reassign every slot_rebuild_steps steps)."""
    from particlerobotsimulations_tpu.config import padded_n
    from particlerobotsimulations_tpu.ops.pallas_stencil import (
        assign_slots_slotmajor,
    )
    from particlerobotsimulations_tpu.state import active_mask

    step = make_step(p)
    mask = active_mask(p, padded_n(p))
    k = max(1, p.resolved_slot_rebuild_steps())

    def assign(s):
        return assign_slots_slotmajor(p, s.pos, mask)[0]

    slot = assign(state)
    for _ in range(n):
        slot = jax.lax.cond(
            state.step % k == 0, lambda: assign(state), lambda: slot
        )
        state = step(state, slot=slot)
    return state


def test_table_loop_matches_per_bot_step():
    p = params_()
    sim = Simulation(p)
    state0 = jitter(sim.state)
    ref = run_per_bot(p, state0, 10)
    out = make_run_chunk_table(p)(state0, 10)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.rad), np.asarray(ref.rad), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(out.phase), np.asarray(ref.phase), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.centroid_ring), np.asarray(ref.centroid_ring), atol=1e-6
    )
    assert int(out.step) == 10


def test_table_loop_crosses_phase_gate():
    # run across a phase-update boundary (short interval) with obstacles so
    # the shadow raycast path is inside the gated cond
    p = params_(
        phase_update_interval=0.05,
        circle_obstacles=((-2.0, 0.0, 0.5),),
        light_shadow=1,
    )
    sim = Simulation(p)
    state0 = jitter(sim.state)
    ref = run_per_bot(p, state0, 8)
    out = make_run_chunk_table(p)(state0, 8)
    np.testing.assert_allclose(
        np.asarray(out.phase), np.asarray(ref.phase), atol=1e-4
    )


def test_seg_aligned_fast_path_matches_legacy():
    """The amortized-cond segment schedule must be physics-identical to the
    per-step traced-cond schedule: gates can only fire on seg multiples, so
    statically ungating the other steps changes nothing but the cond cost.
    Both schedules run the same compiled ops, so the check is BITWISE."""
    from particlerobotsimulations_tpu.engine_table import gate_seg

    # cog every 8 steps, phase every 12 -> seg = gcd = 4 = slot_rebuild_steps
    p = params_(n_cells=128, centroid_int=0.08, phase_update_interval=0.12)
    assert gate_seg(p.validate()) == 4
    run = make_run_chunk_table(p)

    def state0():
        # fresh per call: run_chunk donates its input buffers
        return jitter(Simulation(p).state)

    # 26 = 6 segments + 2 remainder steps; crosses cog gates at 8,16,24
    # and phase gates at 12,24
    legacy = run(state0(), 26, False)
    fast = run(state0(), 26, True)
    for field in ("pos", "vel", "rad", "phase", "centroid_ring"):
        np.testing.assert_array_equal(
            np.asarray(getattr(fast, field)),
            np.asarray(getattr(legacy, field)),
            err_msg=field,
        )
    assert int(fast.step) == 26


def test_seg_aligned_fast_path_batched():
    from particlerobotsimulations_tpu.engine_table import gate_seg
    from particlerobotsimulations_tpu.parallel.sweep import make_batch_state

    p = params_(n_cells=96, centroid_int=0.08, phase_update_interval=0.12)
    assert gate_seg(p.validate()) == 4
    run = make_run_chunk_table_batched(p)
    legacy = run(make_batch_state(p, seeds=[0, 1]), 14, False)
    fast = run(make_batch_state(p, seeds=[0, 1]), 14, True)
    for field in ("pos", "vel", "rad", "phase"):
        np.testing.assert_array_equal(
            np.asarray(getattr(fast, field)),
            np.asarray(getattr(legacy, field)),
            err_msg=field,
        )


def test_nounroll_body_matches_unrolled():
    """The large-table scan-body form (PBOT_UNROLL_BODY=0: inner scan over
    the k-1 gateless steps, with the ungated entry step FOLDED into the
    scan — the compile-containment schedule tables > 2^20 rows use) must
    reproduce the default unrolled schedule, in a calm run and in one
    where a fast mover crosses cells between rebuilds.  The two are
    different XLA programs, so tolerance-level agreement, not bitwise (FMA
    contraction flips 1-ulp roundings across program shapes)."""
    import os

    from particlerobotsimulations_tpu.engine_table import gate_seg

    # seg = gcd(32, 64) = 32, k = 4 -> one gated block + 7 ungated blocks
    p = params_(n_cells=128, centroid_int=0.32, phase_update_interval=0.64)
    assert gate_seg(p.validate()) == 32

    run_unrolled = make_run_chunk_table(p)
    os.environ["PBOT_UNROLL_BODY"] = "0"
    try:
        run_scan = make_run_chunk_table(p)
    finally:
        os.environ.pop("PBOT_UNROLL_BODY", None)

    def state0(kick: float):
        st = jitter(Simulation(p).state)
        if kick:
            import jax.numpy as jnp

            kickv = jnp.zeros_like(st.vel).at[7, 0].set(kick)
            st = st._replace(vel=st.vel + kickv)
        return st

    # 32 steps = exactly one segment.  The 1-ulp FMA seeds amplify
    # chaotically (measured: 1.5e-8 at 4 steps, 1.6e-5 at 32, 2e-2 at 70)
    # — one segment is the longest horizon where per-bot tolerances stay
    # meaningful.
    for kick in (0.0, 60.0):  # 60: a bot crosses cells every rebuild
        a = run_unrolled(state0(kick), 32, True)
        b = run_scan(state0(kick), 32, True)
        np.testing.assert_allclose(
            np.asarray(a.pos), np.asarray(b.pos), atol=1e-4,
            err_msg=f"pos kick={kick}",
        )
        # velocities amplify the seeds ~dt^-1 (100x) faster than positions
        np.testing.assert_allclose(
            np.asarray(a.vel), np.asarray(b.vel), atol=1e-2,
            err_msg=f"vel kick={kick}",
        )
        assert int(b.step) == 32


def test_gate_seg_guards():
    from particlerobotsimulations_tpu.engine_table import gate_seg

    # defaults: cog 1000 steps, phase 1200 -> seg 200 (k=4 divides it)
    assert gate_seg(params_().validate()) == 200
    # dead step off the segment lattice disables the fast path
    p = params_(n_dead=3, time_to_dead=0.57)
    assert gate_seg(p.validate()) == 0
    # dead step on the lattice keeps it
    p = params_(n_dead=3, time_to_dead=2.0)
    assert gate_seg(p.validate()) == 200


def test_table_loop_dead_injection():
    p = params_(n_cells=64, n_dead=9, time_to_dead=0.05)
    out = make_run_chunk_table(p)(Simulation(p).state, 10)
    dead = np.asarray(out.dead)[:64]
    assert dead.sum() == 9
    out2 = make_run_chunk_table(p)(out, 10)  # no re-injection
    assert np.asarray(out2.dead)[:64].sum() == 9


def test_table_loop_batched_matches_unbatched():
    p = params_(n_cells=64)
    from particlerobotsimulations_tpu.parallel.sweep import make_batch_state

    batch = jax.vmap(jitter)(make_batch_state(p, seeds=[0, 1, 2]))
    out_b = make_run_chunk_table_batched(p)(batch, 12)
    run1 = make_run_chunk_table(p)
    for i in range(3):
        solo = jitter(Simulation(p.replace(seed=i)).state)
        out1 = run1(solo, 12)
        np.testing.assert_allclose(
            np.asarray(out_b.pos[i]), np.asarray(out1.pos), atol=1e-6
        )


def test_rebuild_invariants():
    # after a slot rebuild every bot is present exactly once, sits in the
    # lane matching its true (wrapped) cell, its slot is a prefix rank of
    # that cell, and field rows are intact
    from particlerobotsimulations_tpu.engine_table import (
        _gates, _geometry, _rebuild, enter_table, make_table_step,
    )

    p = params_(n_cells=200)
    g = p.resolved_grid_dim()
    total, total_ext, n_pad = _geometry(p)
    sim = Simulation(p)
    ts = jax.jit(lambda s: enter_table(p, s))(sim.state)
    step = make_table_step(p)
    for i in range(4):  # drift positions a little
        ts = step(ts, *_gates(p, ts.step), jnp.asarray(False))

    new = jax.jit(lambda t: _rebuild(p, t))(ts)
    f = new.fields
    val = np.asarray(f["val"][:total]) > 0.5
    bid = np.asarray(f["bid"][:total])[val].astype(int)
    assert len(bid) == p.n_cells and len(np.unique(bid)) == p.n_cells

    # row lane == true wrapped cell under the re-anchored origin
    h = p.cutoff()
    o = np.asarray(new.origin)
    px = np.asarray(f["px"][:total])[val]
    py = np.asarray(f["py"][:total])[val]
    lane = (np.arange(total) % (g * g))[val]
    assert ((np.floor((px - o[0]) / h).astype(int) % g) == lane % g).all()
    assert ((np.floor((py - o[1]) / h).astype(int) % g) == lane // g).all()

    # occupied slots are a prefix of every cell (the force kernel reads
    # rad > 0 as the occupancy flag and counts on it)
    occ = (np.asarray(f["val"][:total]) > 0.5).reshape(-1, g * g)
    assert (occ[1:] <= occ[:-1]).all()

    # rows intact: same multiset of (bid -> rad) as before
    oldv = np.asarray(ts.fields["val"][:total]) > 0.5
    old_bid = np.asarray(ts.fields["bid"][:total])[oldv].astype(int)
    old_rad = np.asarray(ts.fields["rad"][:total])[oldv]
    new_rad = np.asarray(f["rad"][:total])[val]
    np.testing.assert_array_equal(
        old_rad[np.argsort(old_bid)], new_rad[np.argsort(bid)]
    )

def test_rebuild_fallback_recovers_mid_run():
    # drive the swarm > 1 cell per rebuild interval WITHIN one chunk: every
    # rebuild re-anchors the grid on the moved blob — the run continues
    # healthy with every bot still tracked
    from particlerobotsimulations_tpu.state import active_mask

    p = params_(n_cells=64)
    run = make_run_chunk_table(p)
    state = jitter(Simulation(p).state)
    mask = active_mask(p, state.pos.shape[0])
    # ~0.76 cells/step of uniform drift: > 1 cell between K=4 rebuilds
    fast = jnp.where(mask[:, None], jnp.asarray([[50.0, 0.0]]), 0.0)
    state = state._replace(vel=fast)
    before = np.asarray(state.pos)[:64].mean(0)
    state = run(state, 16)  # crosses several rebuild gates in one scan
    pos = np.asarray(state.pos)[:64]
    assert np.isfinite(pos).all()
    assert int(state.step) == 16
    # the swarm really travelled (bots weren't dropped/zeroed by a botched
    # relocation) and stayed a blob
    assert pos.mean(0)[0] - before[0] > 2.0
    assert np.linalg.norm(pos - pos.mean(0), axis=1).max() < 6.0


def test_overflow_spill_sublanes():
    # 24 bots crammed into one cell with overflow_slots=8: 16 go to the
    # force-visible sublanes, 8 to the spill rows (active but forceless),
    # nobody parks; as the overlap explosion disperses them, the slot
    # rebuilds promote the spilled rows back into force-visible slots
    from particlerobotsimulations_tpu.engine_table import (
        _geometry, enter_table, make_run_chunk_table,
    )

    p = params_(n_cells=24, grid_dim=16, overflow_slots=8, phase_std=0.0)
    assert p.storage_capacity() == 24
    sim = Simulation(p)
    rng = np.random.default_rng(0)
    crowded = jnp.asarray(
        rng.uniform(0.0, 0.4, (sim.state.pos.shape[0], 2)).astype(np.float32)
    )
    state = sim.state._replace(pos=crowded, vel=jnp.zeros_like(sim.state.vel))

    total, total_ext, n_pad = _geometry(p)
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    ts = jax.jit(lambda s: enter_table(p, s))(state)
    spilled = (
        np.asarray(ts.fields["val"][g * g * cap : total]) > 0.5
    ).sum()
    parked = (np.asarray(ts.fields["val"][total:]) > 0.5).sum()
    assert spilled > 0, "nothing spilled from the crowded cell"
    assert parked == 0, "spill room should prevent parking"

    run = make_run_chunk_table(p)
    out = run(state, 60)  # the overlap explosion disperses the pile
    pos = np.asarray(out.pos)[:24]
    assert np.isfinite(pos).all()
    ts2 = jax.jit(lambda s: enter_table(p, s))(out)
    spilled2 = (
        np.asarray(ts2.fields["val"][g * g * cap : total]) > 0.5
    ).sum()
    assert spilled2 == 0, "dispersed bots should all be force-visible again"


def test_overflow_spill_batched():
    # the vmapped (sweep/dp) loop composes with spill sublanes
    from particlerobotsimulations_tpu.engine_table import (
        make_run_chunk_table, make_run_chunk_table_batched,
    )
    from particlerobotsimulations_tpu.parallel.sweep import make_batch_state

    p = params_(n_cells=48, grid_dim=16, overflow_slots=8, phase_std=0.0)
    batch = jax.vmap(jitter)(make_batch_state(p, seeds=[0, 1]))
    out_b = make_run_chunk_table_batched(p)(batch, 12)
    run1 = make_run_chunk_table(p)
    for i in range(2):
        solo = jitter(Simulation(p.replace(seed=i)).state)
        out1 = run1(solo, 12)
        np.testing.assert_allclose(
            np.asarray(out_b.pos[i]), np.asarray(out1.pos), atol=1e-6
        )


def test_table_loop_payload_scenario():
    # object-transport style: payload bot + radius factor
    p = params_(n_cells=41, n_dead=-1, rad_factor=4.0, config=Config.RANDOM)
    sim = Simulation(p)
    state0 = jitter(sim.state)
    ref = run_per_bot(p, state0, 8)
    out = make_run_chunk_table(p)(state0, 8)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel), atol=1e-4)


def test_block_scan_rebuild_schedules():
    # round-3 block scan: the static-rebuild block path (1 < k <= 8), the
    # k == 1 always-rebuild path and the k > 8 traced-cond path must all
    # produce the same trajectory as the same schedule expressed with
    # explicit per-step traced gates — including a non-multiple-of-k
    # remainder tail (rebuilds are relabelings; with identical schedules
    # the physics is bitwise identical).
    from particlerobotsimulations_tpu.engine_table import (
        _gates, enter_table, exit_table, make_table_step,
    )

    for k, n_steps in ((4, 7), (1, 3), (12, 13)):
        p = params_(n_cells=64, slot_rebuild_steps=k)
        # wider jitter than default: 1-ulp compilation differences flip
        # overlap/magnet branches on near-tangent pairs and chaos amplifies
        # them — this test checks SCHEDULES, not kernel bitwise identity
        state = jitter(Simulation(p).state, scale=1e-3)
        # run_chunk donates its input buffers — keep a copy for the reference
        out = make_run_chunk_table(p)(jax.tree.map(jnp.copy, state), n_steps)

        # reference: per-step traced-cond loop with the matching schedule
        step = make_table_step(p)
        ts = jax.jit(lambda s: enter_table(p, s))(state)
        for j in range(n_steps):
            if k > 8:
                gate = ts.step % k == k - 1         # absolute (traced path)
            else:
                gate = jnp.asarray(j % k == k - 1)  # chunk-relative blocks
            ts = step(ts, *_gates(p, ts.step), gate)
        ref = jax.jit(lambda t: exit_table(p, t))(ts)

        # one jitted program vs n_steps separately-jitted ones: FMA
        # contraction choices differ at the ulp level (see CLAUDE.md) —
        # assert schedule equivalence at float tolerance, not bitwise
        np.testing.assert_allclose(
            np.asarray(out.pos), np.asarray(ref.pos), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(out.vel), np.asarray(ref.vel), atol=1e-4
        )
        assert int(out.step) == int(ref.step)


def test_undersized_grid_rejected():
    """A user-set grid_dim too small for the swarm would alias wrapped
    cells and overflow their capacity — Simulation must refuse it up front
    (the auto grid sizes itself correctly)."""
    # 3000 HEX bots span ~18 cells of a 16-cell table
    p = SimParams(
        n_cells=3000, n_dead=0, config=Config.HEX, grid_dim=16,
        force_backend=ForceBackend.PALLAS,
    )
    with pytest.raises(ValueError, match="grid_dim"):
        Simulation(p)
    # the same swarm on the auto grid is accepted
    Simulation(p.replace(grid_dim=0))


def test_adaptive_rebuild_cadence():
    """Speed-certified adaptive rebuild (slot_rebuild_steps = -1 auto):

    * the auto gate itself: adaptive only on large tables,
    * a calm steady-state scenario certifies K=8 (the FIRST probe sees the
      jittered-lattice relaxation transient and correctly withholds
      certification; the second certifies), and the adaptive output is
      BITWISE the manual composition of its pieces,
    * a violent scenario (random ±4 u/s velocities — local neighborhood
      Δv far above the certificate) degrades to K=4 and its output is
      BITWISE the pure-K4 composition with the same chunk boundaries,
    * the probe itself orders the two scenarios correctly.
    """
    from particlerobotsimulations_tpu.engine_table import (
        certified_closing_bound,
        make_adaptive_run_chunk,
        make_probe_chunk,
    )
    from particlerobotsimulations_tpu.state import active_mask

    p = params_(n_cells=128, grid_dim=16)  # slot_rebuild_steps default -1
    assert p.validate().resolved_slot_rebuild_steps() == 4
    assert not p.validate().adaptive_rebuild()  # small table: base path
    assert p.replace(n_cells=200_000).validate().adaptive_rebuild()
    bound8 = certified_closing_bound(p.validate(), 8)
    assert 2.0 < bound8 < 5.0  # ~3.4 at reference defaults

    state0 = jitter(Simulation(p).state)
    copy = lambda s: jax.tree.map(jnp.copy, s)

    # --- calm: transient withheld, steady state certifies K=8 ----------
    # (probe fetches are DEFERRED one chunk so the host sync overlaps
    # compute: chunk 1 probes the relaxation transient; chunk 2 acts on
    # it and probes steady state; chunk 3 acts on that and runs K=8)
    adaptive = make_adaptive_run_chunk(p)
    c1 = adaptive(copy(state0), 200, True)    # probe-only chunk
    c2 = adaptive(copy(c1), 200, True)        # acts on transient -> k=4
    transient_pm = adaptive.last_probe
    assert adaptive.live["k"] == 4 and transient_pm > bound8
    out = adaptive(copy(c2), 400, True)       # acts on steady -> k=8
    assert adaptive.live["k"] == 8, (transient_pm, adaptive.last_probe)
    calm_pm = adaptive.last_probe
    assert calm_pm <= bound8
    # bitwise vs the manual composition of the same pieces
    p4, p8 = p.replace(slot_rebuild_steps=4), p.replace(slot_rebuild_steps=8)
    s1, _ = make_probe_chunk(p4)(copy(state0))       # chunk 1 == probe only
    np.testing.assert_array_equal(np.asarray(c1.pos), np.asarray(s1.pos))
    s2, _ = make_probe_chunk(p4)(copy(c1))           # chunk 2 (still k=4)
    np.testing.assert_array_equal(np.asarray(c2.pos), np.asarray(s2.pos))
    s3, _ = make_probe_chunk(p8)(copy(c2))           # chunk 3 probes at k=8
    want = make_run_chunk_table(p8)(s3, 200, True)   # certified rest at k=8
    np.testing.assert_array_equal(np.asarray(out.pos), np.asarray(want.pos))
    np.testing.assert_array_equal(np.asarray(out.vel), np.asarray(want.vel))
    assert np.isfinite(np.asarray(out.pos[: p.n_cells])).all()

    # --- violent: degrades to (stays at) K=4 ---------------------------
    mask = active_mask(p.validate(), state0.pos.shape[0])
    wild = jax.random.uniform(
        jax.random.key(7), state0.vel.shape, minval=-4.0, maxval=4.0
    )
    state_v = state0._replace(vel=jnp.where(mask[:, None], wild, 0.0))
    adaptive_v = make_adaptive_run_chunk(p)
    v1 = adaptive_v(copy(state_v), 400, True)
    out_v = adaptive_v(copy(v1), 400, True)   # acts on the violent probe
    assert adaptive_v.live["k"] == 4
    violent_pm = adaptive_v.last_probe
    assert violent_pm > bound8
    assert violent_pm > calm_pm
    s1v, _ = make_probe_chunk(p4)(copy(state_v))
    want_v = make_run_chunk_table(p4)(s1v, 200, True)
    np.testing.assert_array_equal(np.asarray(v1.pos), np.asarray(want_v.pos))
    assert np.isfinite(np.asarray(out_v.pos[: p.n_cells])).all()

    # unaligned / ragged chunks fall back to the base K=4 production path
    out_r = adaptive_v(copy(state_v), 40, False)
    ref_r = make_run_chunk_table(p.replace(slot_rebuild_steps=4))(
        copy(state_v), 40, False
    )
    np.testing.assert_array_equal(np.asarray(out_r.pos), np.asarray(ref_r.pos))


def test_neighbor_rel_speed_bound_dominates_pairs():
    """The probe must upper-bound the true max pair closing speed: place
    two bots in adjacent cells closing head-on at a known rate and check
    the bound covers it (and is exact for this two-bot case)."""
    from particlerobotsimulations_tpu.engine_table import (
        enter_table,
        neighbor_rel_speed_bound,
    )

    p = params_(n_cells=2, config=Config.LINE, grid_dim=16).validate()
    sim = Simulation(p)
    st = sim.state
    v = jnp.zeros_like(st.vel)
    v = v.at[0].set(jnp.asarray([0.7, 0.0])).at[1].set(
        jnp.asarray([-0.7, 0.0])
    )
    ts = enter_table(p, st._replace(vel=v))
    pm = float(neighbor_rel_speed_bound(p, ts.fields))
    # true closing speed 1.4; envelope is exact here
    assert pm == pytest.approx(1.4, abs=1e-6)
