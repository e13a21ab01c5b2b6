"""One-command multi-device throughput harness.

The single-device harness is bench.py; this script benches the two
multi-device axes the framework ships, pre-validated on the virtual CPU
mesh:

* **dp** — the Monte-Carlo sweep layout: one full scene per device, scene
  batch sharded over the mesh's data axis (parallel/sweep.py), zero
  per-step communication.
* **tp** — the sharded TABLE loop: ONE large scene's grid rows partitioned
  across the mesh with ring-ppermute halos (parallel/spatial_table.py) —
  the single-scene scale-out axis.

Prints a line naming the devices, then one bench.py-schema JSON line per
axis:
  {"metric": ..., "value": N, "unit": "particle-steps/s"}

--dryrun runs the same code paths on an 8-virtual-CPU mesh at tiny shapes
and ASSERTS correctness against unsharded references (scene 0 of the dp
batch vs a solo run; the tp loop vs the single-device table loop), so the
first hardware run is turnkey.

Usage:
  python scripts/bench_multichip.py                 # hardware run
  python scripts/bench_multichip.py --dryrun        # virtual-mesh validation
  python scripts/bench_multichip.py --dp-bots 10000 --tp-bots 100000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync(x):
    import jax
    import numpy as np

    return np.asarray(jax.device_get(jax.block_until_ready(x)))


def _params(n_bots: int, **kw):
    from particlerobotsimulations_tpu import Config, SimParams

    base = dict(
        n_cells=n_bots,
        n_dead=0,
        seed=7,
        config=Config.HEX,  # instant deterministic packed blob at any N
        light_x=-20.0,
        light_y=0.0,
    )
    base.update(kw)
    return SimParams(**base)


def _emit(metric: str, value: float):
    print(
        json.dumps(
            {
                "metric": metric,
                "value": value,
                "unit": "particle-steps/s",
            }
        ),
        flush=True,
    )


def bench_dp(n_bots: int, steps: int, repeats: int = 3) -> float:
    """Scene batch over the mesh data axis: B = n_devices scenes of
    ``n_bots`` each.  Returns aggregate particle-steps/s."""
    import jax

    from particlerobotsimulations_tpu.engine_table import gate_seg
    from particlerobotsimulations_tpu.models.placement import resolve_params
    from particlerobotsimulations_tpu.parallel.sweep import (
        default_mesh,
        make_batch_state,
        make_run_chunk_sharded,
        shard_batch,
    )

    params = resolve_params(_params(n_bots).validate())
    batch = len(jax.devices())
    mesh = default_mesh()
    state = shard_batch(
        make_batch_state(params, seeds=list(range(batch))), mesh
    )
    run = make_run_chunk_sharded(params, mesh)
    seg = gate_seg(params)
    assert seg == 0 or steps % seg == 0, (
        f"steps ({steps}) must be a multiple of the gate segment ({seg}) "
        "for the amortized-cond fast path"
    )

    state = run(state, steps, True)  # warmup/compile at the timed scan length
    _sync(state.step)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = run(state, steps, True)
        _sync(state.step)
        best = min(best, time.perf_counter() - t0)
    pos = _sync(state.pos)[..., :n_bots, :]
    import numpy as np

    assert np.isfinite(pos).all(), "dp bench blew up"
    return n_bots * steps * batch / best


def bench_tp(n_bots: int, steps: int, repeats: int = 3) -> float:
    """One large scene's grid rows sharded over every device (table loop)."""
    import numpy as np

    from particlerobotsimulations_tpu import Simulation
    from particlerobotsimulations_tpu.parallel.spatial_table import (
        make_sharded_table_run,
    )
    from particlerobotsimulations_tpu.parallel.sweep import default_mesh

    run, params = make_sharded_table_run(
        _params(n_bots, phase_std=0.0), default_mesh("bots")
    )
    state = Simulation(params).state

    state = run(state, steps)
    _sync(state.step)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = run(state, steps)
        _sync(state.step)
        best = min(best, time.perf_counter() - t0)
    pos = _sync(state.pos)[:n_bots]
    assert np.isfinite(pos).all(), "tp bench blew up"
    return n_bots * steps / best


def dryrun() -> None:
    """Validate both bench paths on an 8-virtual-CPU mesh at tiny shapes:
    correctness against unsharded references, then the timing loop itself.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__

    __graft_entry__._ensure_devices(8)

    from particlerobotsimulations_tpu import Simulation
    from particlerobotsimulations_tpu.engine import make_run_chunk
    from particlerobotsimulations_tpu.engine_table import make_run_chunk_table
    from particlerobotsimulations_tpu.models.placement import (
        initial_state_arrays,
        resolve_params,
    )
    from particlerobotsimulations_tpu.parallel.spatial_table import (
        make_sharded_table_run,
    )
    from particlerobotsimulations_tpu.parallel.sweep import (
        default_mesh,
        make_batch_state,
        shard_batch,
    )
    from particlerobotsimulations_tpu.state import make_state

    # dp correctness: scene 3 of the sharded batch == a solo run of seed 3
    from particlerobotsimulations_tpu.parallel.sweep import (
        make_run_chunk_sharded,
    )

    params = resolve_params(_params(64).validate())
    batch = make_batch_state(params, seeds=list(range(8)))
    state = shard_batch(batch, default_mesh())
    out = make_run_chunk_sharded(params, default_mesh())(state, 100, True)
    p_eff, pos, vel, rad, phase, dead = initial_state_arrays(
        params.replace(seed=3)
    )
    solo = make_state(p_eff, pos, vel, rad, phase, dead, seed=3)
    solo = make_run_chunk(params)(solo, 100, True)
    dp_err = np.abs(
        _sync(out.pos)[3, :64] - _sync(solo.pos)[:64]
    ).max()
    assert dp_err <= 1e-5, f"dp scene-3 mismatch vs solo run: {dp_err:.2e}"

    # tp correctness: sharded table loop == single-device table loop
    run_tp, p_tp = make_sharded_table_run(
        _params(200, phase_std=0.0, light_x=-5.0), default_mesh("bots")
    )
    st = Simulation(p_tp).state
    noise = 1e-4 * jax.random.normal(jax.random.key(99), st.pos.shape)
    st = st._replace(pos=st.pos + noise)
    out_tp = run_tp(jax.tree.map(jnp.copy, st), 12)
    ref_tp = make_run_chunk_table(p_tp)(jax.tree.map(jnp.copy, st), 12)
    tp_err = np.abs(_sync(out_tp.pos) - _sync(ref_tp.pos)).max()
    assert tp_err <= 1e-5, f"tp sharded/unsharded mismatch: {tp_err:.2e}"

    # exercise the timing loops end-to-end at tiny shapes
    v_dp = bench_dp(64, steps=200, repeats=1)
    v_tp = bench_tp(200, steps=12, repeats=1)
    print(
        f"bench_multichip dryrun OK on {len(jax.devices())} virtual devices: "
        f"dp scene-3 |dpos| <= {dp_err:.1e}, tp |dpos| <= {tp_err:.1e}; "
        f"timing loops ran (dp {v_dp:.0f}, tp {v_tp:.0f} particle-steps/s "
        f"on interpret-mode CPU — numbers meaningless, plumbing certified)"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dryrun", action="store_true",
                    help="validate on an 8-virtual-CPU mesh (no hardware)")
    ap.add_argument("--dp-bots", type=int, default=10_000,
                    help="bots per scene for the dp sweep bench")
    ap.add_argument("--tp-bots", type=int, default=100_000,
                    help="bots for the sharded-table tp bench")
    ap.add_argument("--dp-steps", type=int, default=20_000,
                    help="steps per timed dp chunk (multiple of the 200-step "
                         "gate segment)")
    ap.add_argument("--tp-steps", type=int, default=2_000,
                    help="steps per timed tp chunk")
    ap.add_argument("--skip-dp", action="store_true")
    ap.add_argument("--skip-tp", action="store_true")
    args = ap.parse_args(argv)

    if args.dryrun:
        dryrun()
        return 0

    import jax

    from bench import device_line

    n_dev = len(jax.devices())
    print(device_line(), flush=True)
    if not args.skip_dp:
        v = bench_dp(args.dp_bots, args.dp_steps)
        _emit(f"dp_particle_steps_per_sec_{n_dev}x{args.dp_bots}", v)
    if not args.skip_tp:
        v = bench_tp(args.tp_bots, args.tp_steps)
        _emit(f"tp_sharded_table_particle_steps_per_sec_{args.tp_bots}", v)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
