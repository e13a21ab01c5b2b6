"""Multi-device tests on the 8-virtual-CPU mesh: sweep sharding and
bot-axis spatial sharding (parallel/)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from particlerobotsimulations_tpu import ForceBackend, SimParams, Simulation, make_step
from particlerobotsimulations_tpu.parallel.spatial import make_sharded_step, shard_state
from particlerobotsimulations_tpu.parallel.sweep import (
    default_mesh,
    make_batch_state,
    run_sweep,
    shard_batch,
    sweep_summary,
)


def small_params(**kw):
    base = dict(n_cells=24, n_dead=0, seed=1, max_time=60.0)
    base.update(kw)
    return SimParams(**base)


def test_sweep_matches_single_runs(eight_devices):
    p = small_params()
    mesh = default_mesh()
    seeds = list(range(8))
    state, cents = run_sweep(p, seeds, n_steps=200, mesh=mesh, record_every=100)
    assert cents.shape == (3, 8, 2)
    # scene 3 must equal a solo run with that seed
    solo = Simulation(p.replace(seed=3))
    solo.step_chunk(200)
    np.testing.assert_allclose(cents[-1, 3], solo.centroid(), atol=1e-5)


def test_sweep_sharded_equals_unsharded(eight_devices):
    p = small_params()
    seeds = list(range(8))
    _, sharded = run_sweep(p, seeds, 100, mesh=default_mesh(), record_every=100)
    _, local = run_sweep(p, seeds, 100, mesh=None, record_every=100)
    np.testing.assert_allclose(sharded, local, atol=1e-5)


def test_sweep_strategy_choice(monkeypatch):
    """Regression-pin the execution-strategy policy: a mesh gives batched
    (the batch is the parallelism axis), one scene gives sequential,
    anything else batched — whatever the backend or scene size; AUTO never
    picks packed; the env knob forces a strategy."""
    from particlerobotsimulations_tpu.parallel.sweep import (
        choose_sweep_strategy,
    )

    monkeypatch.delenv("PBOT_SWEEP_STRATEGY", raising=False)
    p_small = small_params(
        n_cells=128, force_backend=ForceBackend.PALLAS
    ).validate()
    p_big = small_params(
        n_cells=4000, force_backend=ForceBackend.PALLAS
    ).validate()
    p = small_params()
    for q in (p, p_small, p_big):
        assert choose_sweep_strategy(q, 8, None) == "batched"
        assert choose_sweep_strategy(q, 256, None) == "batched"
        # single scene: nothing to batch
        assert choose_sweep_strategy(q, 1, None) == "sequential"
    mesh = default_mesh()
    assert choose_sweep_strategy(p_small, 8, mesh) == "batched"
    assert choose_sweep_strategy(p_small, 1, mesh) == "batched"
    monkeypatch.setenv("PBOT_SWEEP_STRATEGY", "sequential")
    assert choose_sweep_strategy(p_big, 8, None) == "sequential"
    monkeypatch.setenv("PBOT_SWEEP_STRATEGY", "packed")
    assert choose_sweep_strategy(p_small, 8, None) == "packed"
    monkeypatch.setenv("PBOT_SWEEP_STRATEGY", "batched")
    assert choose_sweep_strategy(p_small, 1, None) == "batched"
    monkeypatch.setenv("PBOT_SWEEP_STRATEGY", "sequential")
    with pytest.raises(ValueError):
        choose_sweep_strategy(p, 8, mesh)  # sequential can't shard a mesh


def test_sweep_sequential_matches_batched():
    """The two single-device execution strategies must agree scene-by-scene
    (short horizon — chaotic contact dynamics decorrelate longer runs)."""
    p = small_params()
    seeds = [0, 1, 2]
    fin_s, seq = run_sweep(p, seeds, 24, record_every=12, strategy="sequential")
    fin_b, bat = run_sweep(p, seeds, 24, record_every=12, strategy="batched")
    assert seq.shape == bat.shape == (3, 3, 2)
    np.testing.assert_allclose(seq, bat, atol=1e-5)
    # the stacked final pytrees must be layout-compatible across strategies
    assert fin_s.pos.shape == fin_b.pos.shape
    np.testing.assert_allclose(
        np.asarray(fin_s.pos), np.asarray(fin_b.pos), atol=1e-5
    )


def test_sweep_strategy_validation():
    """run_sweep rejects unknown strategy strings and the sequential+mesh
    combination (the scene batch IS the sharding axis — a sequential run
    would silently drop the requested multi-device sharding)."""
    p = small_params()
    with pytest.raises(ValueError, match="unknown sweep strategy"):
        run_sweep(p, [0, 1], 10, strategy="bogus")
    with pytest.raises(ValueError, match="incompatible with a device mesh"):
        run_sweep(p, [0, 1], 10, mesh=default_mesh(), strategy="sequential")


def test_sweep_summary_shapes():
    p = small_params()
    _, cents = run_sweep(p, [0, 1], 100, record_every=50)
    s = sweep_summary(cents, p)
    assert s["distance_mean"].shape == (3,)
    assert s["centroid_mean"].shape == (3, 2)


def test_spatial_sharding_matches_dense(eight_devices):
    # bot-axis sharded step == single-device dense step
    p = small_params(n_cells=100, phase_std=0.0, force_backend=ForceBackend.DENSE)
    sim = Simulation(p)
    sim.step_chunk(100)
    state = sim.state

    mesh = Mesh(np.array(jax.devices()[:8]), ("bots",))
    sharded_step, _ = make_sharded_step(p, mesh)
    ref_step = jax.jit(make_step(p))

    s_sharded = sharded_step(shard_state(state, mesh))
    s_ref = ref_step(state)
    np.testing.assert_allclose(
        np.asarray(s_sharded.pos), np.asarray(s_ref.pos), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s_sharded.vel), np.asarray(s_ref.vel), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s_sharded.rad), np.asarray(s_ref.rad), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(s_sharded.abs_force_r), np.asarray(s_ref.abs_force_r), atol=1e-3
    )


def test_composed_dp_tp_matches_unsharded(eight_devices):
    # (4, 2) mesh: scene batch on "data", bot axis on "bots" — must equal the
    # unsharded vmapped step scene-for-scene
    p = small_params(n_cells=64, phase_std=0.0, force_backend=ForceBackend.DENSE)
    seeds = [0, 1, 2, 3]
    batch = make_batch_state(p, seeds)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "bots"))
    step_2d, _ = make_sharded_step(p, mesh, batch_axis="data")
    st = shard_state(batch, mesh, batch_axis="data")
    ref = batch
    vstep = jax.jit(jax.vmap(make_step(p)))
    for _ in range(5):
        st = step_2d(st)
        ref = vstep(ref)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.pos)), np.asarray(jax.device_get(ref.pos)),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.vel)), np.asarray(jax.device_get(ref.vel)),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.centroid_ring)),
        np.asarray(jax.device_get(ref.centroid_ring)),
        atol=1e-5,
    )


def test_spatial_centroid_matches_engine(eight_devices):
    # the sharded step's centroid ring must match the single-chip engine's
    # (pre-integrate positions — ADVICE round-1 finding)
    p = small_params(n_cells=64, phase_std=0.0, force_backend=ForceBackend.DENSE)
    sim = Simulation(p)
    mesh = Mesh(np.array(jax.devices()[:8]), ("bots",))
    sharded_step, _ = make_sharded_step(p, mesh)
    ref_step = jax.jit(make_step(p))
    st, ref = shard_state(sim.state, mesh), sim.state
    for _ in range(3):
        st = sharded_step(st)
        ref = ref_step(ref)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.centroid_ring)),
        np.asarray(jax.device_get(ref.centroid_ring)),
        atol=1e-6,
    )


def test_spatial_fixed_phase_preserved(eight_devices):
    # Control.FIXED_PHASE: the sharded step must not overwrite scripted
    # phases (ADVICE round-1 finding)
    from particlerobotsimulations_tpu import Control

    # short phase interval so a handful of steps crosses the update gate
    # (hundreds of queued 8-way CPU collectives starve the rendezvous pool)
    p = small_params(
        n_cells=32, control=Control.FIXED_PHASE, phase_update_interval=0.05
    )
    sim = Simulation(p)
    scripted = jnp.linspace(0.0, 3.0, sim.state.phase.shape[0])
    state = sim.state._replace(phase=scripted)
    mesh = Mesh(np.array(jax.devices()[:8]), ("bots",))
    sharded_step, _ = make_sharded_step(p, mesh)
    st = shard_state(state, mesh)
    for _ in range(int(p.phase_update_steps) + 1):  # cross a phase-update step
        st = sharded_step(st)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.phase)), np.asarray(scripted), atol=0
    )


def test_spatial_dead_injection(eight_devices):
    p = small_params(n_cells=48, n_dead=9, time_to_dead=0.1, phase_std=0.0)
    sim = Simulation(p)
    mesh = Mesh(np.array(jax.devices()[:8]), ("bots",))
    sharded_step, _ = make_sharded_step(p, mesh)
    state = shard_state(sim.state, mesh)
    for _ in range(15):  # crosses dead_step = 10
        state = sharded_step(state)
    dead = np.asarray(jax.device_get(state.dead))[: p.n_cells]
    assert dead.sum() == 9
    for _ in range(10):  # no re-injection
        state = sharded_step(state)
    dead = np.asarray(jax.device_get(state.dead))[: p.n_cells]
    assert dead.sum() == 9


def test_spatial_sharding_multi_step(eight_devices):
    p = small_params(n_cells=64, phase_std=0.0)
    sim = Simulation(p)
    mesh = Mesh(np.array(jax.devices()[:8]), ("bots",))
    sharded_step, _ = make_sharded_step(p, mesh)
    state = shard_state(sim.state, mesh)
    for _ in range(50):
        state = sharded_step(state)
    pos = np.asarray(jax.device_get(state.pos))
    assert np.isfinite(pos[: p.n_cells]).all()


def test_sweep_sharded_pallas_table(eight_devices):
    # the production sweep layout at scale: the batched TABLE loop (PALLAS
    # backend) sharded over the mesh's data axis — covers the vmapped
    # enter/step/rebuild/exit chain under real shardings (the multi-chip dp
    # path the driver dry-runs)
    p = small_params(n_cells=64, phase_std=0.0, force_backend=ForceBackend.PALLAS)
    seeds = list(range(8))
    _, sharded = run_sweep(p, seeds, 100, mesh=default_mesh(), record_every=100)
    _, local = run_sweep(p, seeds, 100, mesh=None, record_every=100)
    np.testing.assert_allclose(sharded, local, atol=1e-5)


def test_sharded_table_matches_unsharded(eight_devices):
    # the sharded TABLE loop (grid rows over the mesh, ppermute halos,
    # non-Newton ext kernel) vs the single-device table loop: with
    # phase_std=0 both are deterministic; they differ only by float
    # reassociation (Newton vs non-Newton summation order)
    from particlerobotsimulations_tpu.engine_table import make_run_chunk_table
    from particlerobotsimulations_tpu.parallel.spatial_table import (
        make_sharded_table_run,
    )

    p = small_params(
        n_cells=200, phase_std=0.0, force_backend=ForceBackend.PALLAS,
        light_x=-5.0, seed=3,
    )
    mesh = default_mesh("bots")
    run, p2 = make_sharded_table_run(p, mesh, axis="bots")
    st = Simulation(p2).state
    noise = 1e-4 * jax.random.normal(jax.random.key(99), st.pos.shape)
    st = st._replace(pos=st.pos + noise)
    out = run(jax.tree.map(jnp.copy, st), 12)
    ref = make_run_chunk_table(p2)(jax.tree.map(jnp.copy, st), 12)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel), atol=1e-4)
    assert int(out.step) == 12


def test_sharded_table_fallback_recovers(eight_devices):
    # >1-cell moves per rebuild window force the exact global fallback
    # (all-gather + argsort, replicated) — the run must stay healthy with
    # every bot tracked across shard boundaries
    from particlerobotsimulations_tpu.parallel.spatial_table import (
        make_sharded_table_run,
    )
    from particlerobotsimulations_tpu.state import active_mask

    p = small_params(
        n_cells=64, phase_std=0.0, force_backend=ForceBackend.PALLAS,
        light_x=-5.0, seed=3,
    )
    run, p2 = make_sharded_table_run(p, default_mesh("bots"), axis="bots")
    st = Simulation(p2).state
    mask = active_mask(p2, st.pos.shape[0])
    st = st._replace(
        vel=jnp.where(mask[:, None], jnp.asarray([[50.0, 0.0]]), 0.0)
    )
    before = np.asarray(st.pos)[:64].mean(0)
    out = run(st, 16)
    pos = np.asarray(out.pos)[:64]
    assert np.isfinite(pos).all()
    assert pos.mean(0)[0] - before[0] > 2.0
    assert np.linalg.norm(pos - pos.mean(0), axis=1).max() < 6.0


def test_sharded_table_dead_injection(eight_devices):
    from particlerobotsimulations_tpu.parallel.spatial_table import (
        make_sharded_table_run,
    )

    p = small_params(
        n_cells=64, n_dead=9, time_to_dead=0.05, phase_std=0.0,
        force_backend=ForceBackend.PALLAS, light_x=-5.0, seed=3,
    )
    run, p2 = make_sharded_table_run(p, default_mesh("bots"), axis="bots")
    out = run(Simulation(p2).state, 10)
    assert int(np.asarray(out.dead)[:64].sum()) == 9
    out2 = run(out, 10)  # no re-injection
    assert int(np.asarray(out2.dead)[:64].sum()) == 9


def test_sharded_table_production_shape(eight_devices):
    """VERDICT r2 #2: the sharded TABLE loop at production shape — 10k bots,
    112 steps (28 rebuild windows), with a bulk y-drift that migrates
    boundary grid rows across shards throughout the run.

    The drift (6 u/s, decaying under kinetic friction) keeps per-window
    motion (0.24 u) under one cell (0.517 u): this exercises bots crossing
    shard boundaries between rebuilds, which the replicated rebuild hands
    to their new owner (the recovery path is covered by
    test_sharded_table_fallback_recovers).

    Two-tier assertion, because the contact dynamics are chaotic: the
    sharded loop's non-Newton summation order seeds ~1e-6 differences that
    amplify exponentially (measured: 5e-6 max|dpos| at 16 steps, 6e-2 at
    112), so per-bot 1e-5 agreement is asserted at 16 steps (4 rebuild
    windows + migration), while at 112 steps the MACROSCOPIC state must
    match: centroid to 2e-4, radius/speed statistics to 1e-3, plus the
    migration actually happened."""
    from particlerobotsimulations_tpu.engine_table import make_run_chunk_table
    from particlerobotsimulations_tpu.parallel.spatial_table import (
        make_sharded_table_run,
    )
    from particlerobotsimulations_tpu.state import active_mask

    p = small_params(
        n_cells=10_000, phase_std=0.0, force_backend=ForceBackend.PALLAS,
        light_x=-30.0, seed=3,
    )
    mesh = default_mesh("bots")
    run, p2 = make_sharded_table_run(p, mesh, axis="bots")
    ref_run = make_run_chunk_table(p2)
    st = Simulation(p2).state
    mask = active_mask(p2, st.pos.shape[0])
    noise = 1e-4 * jax.random.normal(jax.random.key(99), st.pos.shape)
    st = st._replace(
        pos=st.pos + noise,
        vel=jnp.where(mask[:, None], jnp.asarray([[0.0, 6.0]]), 0.0),
    )
    before_y = float(np.asarray(st.pos)[:10_000, 1].mean())
    n = 10_000

    # tier 1: strict per-bot agreement across 4 rebuild windows with
    # active cross-shard migration
    out = run(jax.tree.map(jnp.copy, st), 16)
    ref = ref_run(jax.tree.map(jnp.copy, st), 16)
    np.testing.assert_allclose(
        np.asarray(out.pos)[:n], np.asarray(ref.pos)[:n], atol=1e-5
    )
    # velocities amplify the seed differences ~dt^-1 faster than positions
    np.testing.assert_allclose(
        np.asarray(out.vel)[:n], np.asarray(ref.vel)[:n], atol=1e-3
    )

    # tier 2: 112 steps — swarm has crossed shard boundaries (drift ~5 u vs
    # ~4.1 u shard height); microstates decorrelate chaotically but the
    # macrostate must agree
    out = run(out, 96)
    ref = ref_run(ref, 96)
    pos, rpos = np.asarray(out.pos)[:n], np.asarray(ref.pos)[:n]
    vel, rvel = np.asarray(out.vel)[:n], np.asarray(ref.vel)[:n]
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    assert pos[:, 1].mean() - before_y > 3.0
    np.testing.assert_allclose(pos.mean(0), rpos.mean(0), atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(out.rad)[:n].mean(), np.asarray(ref.rad)[:n].mean(),
        rtol=1e-3,
    )
    speed = np.hypot(vel[:, 0], vel[:, 1]).mean()
    rspeed = np.hypot(rvel[:, 0], rvel[:, 1]).mean()
    np.testing.assert_allclose(speed, rspeed, rtol=2e-3)
    assert int(out.step) == 112


def test_sharded_table_overflow_spill(eight_devices):
    """Sharded rebuilds with ACTIVE overflow-spill slots: cell_capacity 8
    with 8 spill rows makes the hex blob (12-14 bots/cell) populate the
    spill slots everywhere; the sharded loop must move them across
    rebuilds (and shard boundaries)
    identically to the unsharded loop."""
    from particlerobotsimulations_tpu.engine_table import make_run_chunk_table
    from particlerobotsimulations_tpu.parallel.spatial_table import (
        make_sharded_table_run,
    )
    from particlerobotsimulations_tpu.state import active_mask

    p = small_params(
        n_cells=600, phase_std=0.0, force_backend=ForceBackend.PALLAS,
        light_x=-10.0, seed=3, cell_capacity=8, overflow_slots=8,
    )
    mesh = default_mesh("bots")
    run, p2 = make_sharded_table_run(p, mesh, axis="bots")
    assert p2.storage_capacity() == 16
    st = Simulation(p2).state
    mask = active_mask(p2, st.pos.shape[0])
    noise = 1e-4 * jax.random.normal(jax.random.key(99), st.pos.shape)
    st = st._replace(
        pos=st.pos + noise,
        vel=jnp.where(mask[:, None], jnp.asarray([[0.0, 2.0]]), 0.0),
    )
    out = run(jax.tree.map(jnp.copy, st), 12)
    ref = make_run_chunk_table(p2)(jax.tree.map(jnp.copy, st), 12)
    np.testing.assert_allclose(
        np.asarray(out.pos)[:600], np.asarray(ref.pos)[:600], atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.vel)[:600], np.asarray(ref.vel)[:600], atol=1e-4
    )


def test_composed_dp_tp_table_loop(eight_devices):
    """VERDICT r2 #2: composed dp x tp on the TABLE loop — scene batch on
    the data axis, each scene's grid rows on the bots axis of a (4, 2)
    mesh — matches the unsharded table loop scene-by-scene."""
    from particlerobotsimulations_tpu.engine_table import make_run_chunk_table
    from particlerobotsimulations_tpu.parallel.spatial_table import (
        make_sharded_table_run_batched,
    )
    from particlerobotsimulations_tpu.parallel.sweep import make_batch_state

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("data", "bots"))
    p = small_params(
        n_cells=96, phase_std=0.0, force_backend=ForceBackend.PALLAS,
        light_x=-5.0, seed=3,
    )
    run, p2 = make_sharded_table_run_batched(p, mesh)
    batch = make_batch_state(p2, seeds=[0, 1, 2, 3])
    out = run(jax.tree.map(jnp.copy, batch), 10)
    ref_run = make_run_chunk_table(p2)
    for i in (0, 3):
        single = jax.tree.map(lambda x: jnp.copy(x[i]), batch)
        ref = ref_run(single, 10)
        np.testing.assert_allclose(
            np.asarray(out.pos[i]), np.asarray(ref.pos), atol=1e-5,
            err_msg=f"scene {i}",
        )
        np.testing.assert_allclose(
            np.asarray(out.vel[i]), np.asarray(ref.vel), atol=1e-4,
            err_msg=f"scene {i}",
        )


def test_sweep_resolves_nx_fallback():
    """A sweep on Nx==0 params must compile the same actuation wave period
    as Simulation (the reference's Nx==0 -> config_size_x fallback,
    particlebot.cpp:772-773) — previously run_sweep built the step function
    from the unresolved params and ran a physically different wave."""
    from particlerobotsimulations_tpu import Config
    from particlerobotsimulations_tpu.models.placement import (
        config_size_x,
        resolve_params,
    )

    p = small_params(nx=0, config=Config.HEX, n_cells=30)
    # hex size_x (rings*2) differs from the default nx — the fallback bites
    assert config_size_x(p) not in (0, p.nx)
    assert resolve_params(p).nx == config_size_x(p)

    _, cents = run_sweep(p, [p.seed], 400, record_every=400)
    solo = Simulation(p)
    solo.step_chunk(400)
    np.testing.assert_allclose(cents[-1, 0], solo.centroid(), atol=1e-5)
