"""Packed scene-tiling sweep (parallel/packed.py).

Validation follows the repo's two-tier pattern (CLAUDE.md): tile offsets
perturb pair arithmetic by ulps, so per-bot comparisons are only meaningful
over short horizons; longer runs assert macrostate (per-scene centroids).
Initial positions are jittered for cross-implementation comparisons —
placement produces exactly-tangent pairs whose overlap/magnet branch flips
on 1-ulp offsets (tests/test_engine_table.py::jitter).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from particlerobotsimulations_tpu import Config, SimParams
from particlerobotsimulations_tpu.config import ForceBackend
from particlerobotsimulations_tpu.engine_table import make_run_chunk_table
from particlerobotsimulations_tpu.models.placement import initial_state_arrays
from particlerobotsimulations_tpu.parallel.packed import (
    _check_health,
    make_packed_phase,
    pack_scenes,
    packed_eligible,
    run_sweep_packed,
    unpack_positions,
)
from particlerobotsimulations_tpu.parallel.sweep import (
    choose_sweep_strategy,
    run_sweep,
)
from particlerobotsimulations_tpu.state import make_state

JIT = 1e-4


def scene_params(**kw):
    base = dict(
        n_cells=64, n_dead=0, seed=7, config=Config.RANDOM,
        light_x=-20.0, light_y=0.0, phase_std=0.0,
        force_backend=ForceBackend.PALLAS,
    )
    base.update(kw)
    return SimParams(**base)


def jittered_single(params, seed, n):
    p_eff, pos, vel, rad, phase, dead = initial_state_arrays(
        params.replace(seed=seed)
    )
    rng = np.random.default_rng(1000 + seed)
    pos = pos + JIT * rng.standard_normal((n, 2)).astype(np.float32)
    return p_eff, make_state(p_eff, pos, vel, rad, phase, dead, seed=seed)


def test_packed_matches_single_short():
    """Tier 1: per-bot positions match per-scene single runs to float
    tolerance over a short horizon (16 steps; includes a step-0 phase
    update, so the per-scene min-distance law is exercised)."""
    params = scene_params()
    n, steps = 64, 16
    pp, state, origins, pitch = pack_scenes(params, [0, 1], jitter_scale=JIT)
    run = make_run_chunk_table(
        pp, phase_fn=make_packed_phase(pp, origins, pitch)
    )
    local = unpack_positions(run(state, steps, False), origins, n)
    for i, s in enumerate([0, 1]):
        p_eff, st1 = jittered_single(params, s, n)
        out = make_run_chunk_table(p_eff.validate())(st1, steps, False)
        d = np.abs(np.asarray(out.pos)[:n] - local[i]).max()
        assert d < 2e-5, f"scene {i}: |dpos| {d:.2e}"


def test_packed_run_sweep_macrostate():
    """Tier 2: per-scene centroid trajectories track sequential runs over a
    longer horizon (chaos-amplified ulps bound per-bot agreement, but the
    macrostate stays close), and the health checks pass."""
    params = scene_params()
    _, cents = run_sweep_packed(params, [0, 1], 400, record_every=200)
    _, cs = run_sweep(params, [0, 1], 400, record_every=200,
                      strategy="sequential")
    assert cents.shape == cs.shape == (3, 2, 2)
    assert np.abs(cents - cs).max() < 2e-2


def test_packed_via_run_sweep_strategy():
    params = scene_params()
    st, cents = run_sweep(params, [0, 1], 60, record_every=30,
                          strategy="packed")
    assert cents.shape == (3, 2, 2)
    assert np.isfinite(cents).all()


def test_scene_assignment_and_min_d():
    """The phase hook's per-scene min reduction against a numpy oracle."""
    params = scene_params()
    pp, state, origins, pitch = pack_scenes(params, [0, 1, 2])
    B, n = 3, params.n_cells
    phase_fn = make_packed_phase(pp, origins, pitch)
    # synthetic planes: real packed positions, valid only for bot rows
    pos = np.asarray(state.pos)
    rows = pos.shape[0]
    f = {
        "px": jnp.asarray(pos[:, 0]),
        "py": jnp.asarray(pos[:, 1]),
        "phase": jnp.zeros((rows,), jnp.float32),
    }
    val = jnp.arange(rows) < B * n
    import jax

    new_phase = np.asarray(phase_fn(f, val, jax.random.key(0)))
    # oracle: per scene, phase = (min_d - dist) / (2 r_min) * rise_period
    light = np.array([pp.light_x, pp.light_y])
    for i in range(B):
        loc = pos[i * n:(i + 1) * n] - origins[i]
        dist = np.linalg.norm(loc - light, axis=-1)
        want = (dist.min() - dist) / (2 * pp.min_radius) * pp.rise_period
        got = new_phase[i * n:(i + 1) * n]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_eligibility_and_strategy_choice(monkeypatch):
    """Packed is explicit-only: AUTO never picks it, whatever the union
    size; eligibility still guards the explicit request."""
    monkeypatch.delenv("PBOT_SWEEP_STRATEGY", raising=False)
    p = scene_params()
    assert packed_eligible(p)
    assert not packed_eligible(p.replace(n_dead=3))
    assert not packed_eligible(p.replace(n_dead=-1))       # payload
    assert not packed_eligible(p.replace(light_shadow=1))
    assert not packed_eligible(
        p.replace(circle_obstacles=((0.0, 0.0, 1.0),))
    )
    assert choose_sweep_strategy(p, 256, None) == "batched"
    assert choose_sweep_strategy(p, 2, None) == "batched"
    assert choose_sweep_strategy(p, 1, None) == "sequential"
    assert (
        choose_sweep_strategy(p.replace(n_cells=2000, n_dead=3), 64, None)
        == "batched"
    )
    with pytest.raises(ValueError):
        run_sweep(p.replace(n_dead=3), [0, 1], 10, strategy="packed")


def test_packed_adaptive_runner_bitwise():
    """The packed runner's adaptive-cadence glue (phase_fn threaded through
    make_adaptive_run_chunk / make_probe_chunk) is BITWISE the manual
    composition of its pieces, phase hook included.  (The adaptive
    mechanics themselves — certification, degradation, deferred probe —
    are covered by test_engine_table.test_adaptive_rebuild_cadence; this
    pins only the packed glue.)"""
    import jax

    from particlerobotsimulations_tpu.engine_table import (
        gate_seg,
        make_adaptive_run_chunk,
        make_probe_chunk,
    )

    params = scene_params()
    pp, state, origins, pitch = pack_scenes(params, [0, 1], jitter_scale=JIT)
    phase_fn = make_packed_phase(pp, origins, pitch)
    seg = gate_seg(pp)
    copy = lambda s: jax.tree.map(jnp.copy, s)

    # first adaptive chunk == one probe segment at the base cadence
    adaptive = make_adaptive_run_chunk(pp, phase_fn=phase_fn)
    out = adaptive(copy(state), seg, True)
    p4 = pp.replace(slot_rebuild_steps=4)
    want, _ = make_probe_chunk(p4, phase_fn)(copy(state))
    np.testing.assert_array_equal(np.asarray(out.pos), np.asarray(want.pos))
    np.testing.assert_array_equal(np.asarray(out.vel), np.asarray(want.vel))
    assert np.isfinite(np.asarray(out.pos)).all()


def test_health_check_raises():
    params = scene_params()
    pp, state, origins, pitch = pack_scenes(params, [0, 1])
    n = params.n_cells

    def recs(pos):
        # (T=1, B, 2) centroid + box histories, as run_sweep_packed
        # records them
        p = pos[: 2 * n].reshape(2, n, 2)
        return (
            p.mean(axis=1)[None] - origins[None],
            p.min(axis=1)[None],
            p.max(axis=1)[None],
        )

    ok = recs(np.asarray(state.pos))
    _check_health(params, pp, origins, pitch, *ok)  # clean state passes

    # isolation violation: teleport scene 1 onto scene 0's bots (box
    # overlap -> negative pairwise gap)
    bad = np.asarray(state.pos).copy()
    bad[n:2 * n] = bad[:n]
    with pytest.raises(RuntimeError, match="isolation"):
        _check_health(params, pp, origins, pitch, *recs(bad))

    # wall-fidelity violation: a scene spread past its own world box.
    # Teleport PERPENDICULAR to the tile axis (tiles are side-by-side in
    # x) so the isolation check — which runs first and keys on the
    # Chebyshev box gap — still sees the boxes separated along x.
    far = np.asarray(state.pos).copy()
    far[0] = origins[0] + np.array([0.0, 70.0])  # scene box is +-64
    with pytest.raises(RuntimeError, match="wall fidelity"):
        _check_health(params, pp, origins, pitch * 100.0, *recs(far))

    # scene-assignment margin: a bot past pitch/2 of its origin (but
    # still inside walls and isolated) trips the Voronoi-cell check
    near = np.asarray(state.pos).copy()
    near[0] = origins[0] + np.array([0.0, 0.6 * pitch])
    with pytest.raises(RuntimeError, match="assignment margin"):
        _check_health(params, pp, origins, pitch, *recs(near))

    # grid fit: a union span past the wrapped-table anchoring budget
    g = pp.resolved_grid_dim()
    wide = np.asarray(state.pos).copy()
    wide[0] = origins[0] + np.array([0.0, (g + 1) * params.cutoff()])
    with pytest.raises(RuntimeError, match="grid fit"):
        _check_health(
            params.replace(world_half=1e6), pp, origins, pitch * 1e6,
            *recs(wide),
        )

    # a violation only in an INTERMEDIATE record is still caught
    v = recs(far)
    two = tuple(np.concatenate([a, b]) for a, b in zip(v, ok))
    with pytest.raises(RuntimeError, match="record 0"):
        _check_health(params, pp, origins, pitch * 100.0, *two)
