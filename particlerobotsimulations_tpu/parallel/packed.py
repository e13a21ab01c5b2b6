"""Packed scene-tiling sweep: B small scenes in ONE table-resident sim.

The reference's parallelism is one CUDA thread per bot in a single scene
(/root/reference/particlebot_cuda.cu:29-47); its default scenario is ~500
bots (reference main.cpp:872,883).  Scenes that small leave a card
mostly idle whether they run one after another or vmapped together.  This
module *spatially multiplexes* them into one big simulation instead.  Each
scene is placed on its own tile of a 2-D grid whose pitch guarantees at
least a full neighbor-window of empty cells between blobs, so the
production force kernel — untouched — computes exactly the per-scene pair
sets (cross-scene pairs are impossible: the kernel pairs only within a
3x3 cell window and tiles are separated by more than that).

The isolation pitch makes the packed table several times sparser than an
auto-G single blob of the same bot count.  The strategy is opt-in
(``run_sweep(..., strategy="packed")``); AUTO never picks it
(parallel/sweep.choose_sweep_strategy).

What has to become scene-aware is exactly the one op with a cross-bot
reduction: the light-phase law (min distance to the light over *the
scene's* bots, /root/reference/particlebot.cpp:212-232).  That runs via
the ``phase_fn`` hook in engine_table.make_table_step_parts:

* scene assignment — nearest tile origin in union-mean-centered
  coordinates.  Phototaxis drift is common-mode across scenes (same light
  offset per tile), so subtracting the union mean cancels it exactly;
  only the per-seed differential drift (measured ±5% of a few units over
  full horizons) has to fit inside pitch/2, and the chunk-boundary health
  check enforces that with a hard error.
* per-row scene-local position ``pos - origin[sid]`` feeds the standard
  ``update_phase`` (light coordinates are scene-local, identical for all
  scenes), with ``min_d`` supplied as a per-row array: a one-hot (rows, B)
  masked min — matmul-shaped, negligible at the 1/phase_update_interval
  cadence.

Eligibility (checked by :func:`packed_eligible`): no obstacles (their
params-constant absolute coordinates cannot be shared across shifted
scenes), no shadow raycast (obstacle-dependent), no payload, no dead-cell
injection.  That is exactly the reference's default phototaxis scenario
family.  RNG streams are per-row like the rest of the table loop, so
packed trajectories match single-scene runs distributionally (and to
float tolerance for phase_std = 0 over short horizons); this is the same
documented deviation class as the batched and sharded loops.

Walls: the packed world box is auto-fitted to the union, so per-scene
walls at ±world_half do not exist inside the packed sim.  The health
check errors if any scene's local extent approaches where its own walls
would have been — scenarios that actually reach the walls must use the
sequential/batched strategies.
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Control, SimParams
from ..engine_table import gate_seg, make_run_chunk_table
from ..models.placement import initial_state_arrays, resolve_params
from ..ops.phase import update_phase
from ..state import SimState, make_state

# empty-cell separation between tiles: the force kernel pairs within a
# 3x3 cell window (+1 cell of bbox-anchor slack), so >= 4 empty cells
# makes cross-scene pairs structurally impossible
_SEP_CELLS = 4
# extra linear blob-growth slack on top of the max/min radius ratio
# (cohesion loosening during the oscillation wave)
_GROWTH_SLACK = 1.2


def packed_eligible(params: SimParams) -> bool:
    """Scenario families the packed tiling supports (see module docstring)."""
    p = params
    return (
        p.control == Control.LIGHT_WAVE
        and not p.circle_obstacles
        and not p.rect_obstacles
        and not p.light_shadow
        and p.n_dead == 0
        and not p.has_payload
    )


def _tile_grid(n_scenes: int) -> tuple[int, int]:
    bx = int(math.ceil(math.sqrt(n_scenes)))
    by = int(math.ceil(n_scenes / bx))
    return bx, by


def pack_scenes(
    params: SimParams, seeds: Sequence[int], jitter_scale: float = 0.0
):
    """Place one scene per seed and tile them into a single packed state.

    Returns ``(packed_params, packed_state, origins (B,2) f32, pitch)``.
    Scene ``i`` owns bot ids ``[i*n, (i+1)*n)`` (exit_table restores bot
    order, so per-scene unpacking is a reshape).

    ``jitter_scale`` perturbs each scene's initial positions with
    ``default_rng(1000 + seed)`` gaussian noise — for cross-implementation
    tests only: placement produces exactly-tangent pairs (gap == 0 sits on
    the overlap/magnet branch boundary), so packed-vs-single comparisons
    on pristine lattices flip ±2.5 magnet forces on 1-ulp offsets (see
    tests/test_engine_table.py::jitter).
    """
    params = resolve_params(params.validate())
    if not packed_eligible(params):
        raise ValueError(
            "scenario not packed-eligible (obstacles/shadow/payload/dead "
            "injection are per-scene state the tiled union cannot share); "
            "use the sequential or batched sweep strategy"
        )
    n, B = params.n_cells, len(seeds)
    scenes = [initial_state_arrays(params.replace(seed=int(s))) for s in seeds]
    nx = scenes[0][0].nx  # seed-independent (placement.config_size_x)

    pos_all = np.stack([sc[1] for sc in scenes])  # (B, n, 2)
    if jitter_scale:
        for i, s in enumerate(seeds):
            rng = np.random.default_rng(1000 + int(s))
            pos_all[i] = pos_all[i] + jitter_scale * rng.standard_normal(
                (n, 2)
            ).astype(np.float32)
    cbar = pos_all.reshape(-1, 2).mean(axis=0)
    half = float(np.abs(pos_all - cbar).max())  # Chebyshev about common mean
    cutoff = params.cutoff()
    # placement is at min_radius; radii oscillate up to max_radius, which
    # scales the close-packed blob linearly by the radius ratio
    growth = (params.max_radius / params.min_radius) * _GROWTH_SLACK
    pitch = 2.0 * half * growth + _SEP_CELLS * cutoff
    # cell-align the pitch so tile boundaries stay crisp in the wrapped
    # table (not required for correctness — separation is in world units)
    pitch = math.ceil(pitch / cutoff) * cutoff

    bx, by = _tile_grid(B)
    origins = np.zeros((B, 2), dtype=np.float32)
    for i in range(B):
        ix, iy = i % bx, i // bx
        origins[i] = (
            (ix - (bx - 1) / 2.0) * pitch,
            (iy - (by - 1) / 2.0) * pitch,
        )

    packed_pos = (pos_all + origins[:, None, :]).reshape(B * n, 2)
    packed_vel = np.concatenate([sc[2] for sc in scenes])
    packed_rad = np.concatenate([sc[3] for sc in scenes])
    packed_phase = np.concatenate([sc[4] for sc in scenes])
    packed_dead = np.concatenate([sc[5] for sc in scenes])

    # grid: union span in cells + drift/expansion headroom
    span_cells = int(
        np.ceil((packed_pos.max(axis=0) - packed_pos.min(axis=0)).max() / cutoff)
    )
    # growth headroom scales with the per-scene extent: the OUTERMOST
    # scenes expand outward by half*(growth-1) each side (common-mode
    # drift costs nothing — the table is bbox-anchored), + 4 cells slack.
    # _check_health re-verifies span-vs-grid at every record point.
    grow_cells = int(math.ceil(2.0 * half * (growth - 1.0) / cutoff)) + 4
    g = span_cells + 2 * _SEP_CELLS + grow_cells
    g = int(math.ceil(g / 16.0)) * 16

    # world box: cover the union with drift + expansion headroom (the
    # packed box is NOT physics — per-scene walls are asserted unreachable
    # by the health check; reference walls live at the SCENE world_half)
    wh = float(np.abs(packed_pos).max()) + max(16.0, 0.25 * pitch)

    pp = params.replace(
        n_cells=B * n, nx=nx, grid_dim=g, world_half=wh,
    ).validate()
    state = make_state(
        pp, packed_pos, packed_vel, packed_rad, packed_phase, packed_dead,
        seed=int(params.seed),
    )
    return pp, state, origins, pitch


def make_packed_phase(pp: SimParams, origins: np.ndarray, pitch: float):
    """The per-scene phase law as an engine_table ``phase_fn``.

    Replicates the reference law (phase from min light distance over the
    scene, particlebot_kernel_impl.cuh:286) per tile:

    * scene assignment is the CLOSED-FORM tile decode — round the
      union-mean-centered position to the regular origin grid (O(rows)
      arithmetic, no (rows, B) distance matrix).  Exact wherever the
      assignment-margin health check holds (|pos - u - org_c| < pitch/2
      per axis, verified at every record point by ``_check_health``);
      invalid rows decode to an arbitrary clipped tile and are masked
      out downstream.
    * per-scene min distance + broadcast-back run in 16-scene column
      chunks, so peak memory is (rows, 16) regardless of B (a 256-scene
      union would otherwise materialize multiple (rows, B) ~GB-scale
      intermediates on every phase gate)."""
    f32 = jnp.float32
    org = np.asarray(origins, np.float32)            # (B, 2)
    B = len(org)
    bx, by = _tile_grid(B)
    mox, moy = (float(m) for m in org.mean(axis=0))
    iota = jnp.arange(B, dtype=jnp.int32)
    inv_p = f32(1.0 / pitch)

    def phase_fn(f, val, key):
        px, py = f["px"], f["py"]
        w = val.astype(f32)
        wsum = jnp.maximum(jnp.sum(w), f32(1.0))
        ux = jnp.sum(px * w) / wsum                   # union bot-mean:
        uy = jnp.sum(py * w) / wsum                   # common-mode-drift-free
        # tile decode: pos - u compares to org_c = org - mean(org), i.e.
        # pos - u + mean(org) ~ org_i = ((ix - (bx-1)/2) pitch, ...)
        ix = jnp.clip(
            jnp.round((px - ux + f32(mox)) * inv_p + f32((bx - 1) / 2.0)),
            0, bx - 1,
        ).astype(jnp.int32)
        iy = jnp.clip(
            jnp.round((py - uy + f32(moy)) * inv_p + f32((by - 1) / 2.0)),
            0, by - 1,
        ).astype(jnp.int32)
        sid = jnp.minimum(iy * bx + ix, B - 1)
        ox = (ix.astype(f32) - f32((bx - 1) / 2.0)) * f32(pitch)
        oy = (iy.astype(f32) - f32((by - 1) / 2.0)) * f32(pitch)
        lx, ly = px - ox, py - oy                     # scene-local
        dx = lx - f32(pp.light_x)
        dy = ly - f32(pp.light_y)
        dist = jnp.sqrt(dx * dx + dy * dy)
        min_rows = jnp.zeros_like(dist)
        for c0 in range(0, B, 16):
            ids = iota[c0:c0 + 16]                    # static 16-col chunk
            m = (sid[:, None] == ids[None, :]) & val[:, None]
            dmin = jnp.min(
                jnp.where(m, dist[:, None], jnp.inf), axis=0
            )                                         # (chunk,) scene mins
            dmin = jnp.where(jnp.isfinite(dmin), dmin, 0.0)
            min_rows = min_rows + jnp.sum(
                m.astype(f32) * dmin[None, :], axis=1
            )
        pos_local = jnp.stack([lx, ly], axis=-1)
        return update_phase(pp, pos_local, f["phase"], val, key,
                            min_d=min_rows)

    return phase_fn


def _packed_runner(pp: SimParams, origins: np.ndarray, pitch: float):
    """Cached packed-union chunk runner.

    Routed through engine._RUN_CHUNK_CACHE (same bounded FIFO the
    sequential/batched strategies use) so repeated sweeps with the same
    scenario + seed set reuse the compiled XLA executables — the packed
    phase hook closes over ``origins``, so the cache key carries them on
    top of the standard (params, env-knob, platform) key."""
    from ..engine import _RUN_CHUNK_CACHE, _chunk_cache_key

    key = _chunk_cache_key("packed", pp) + (origins.tobytes(), pitch)
    run = _RUN_CHUNK_CACHE.get(key)
    if run is None:
        phase_fn = make_packed_phase(pp, origins, pitch)
        if pp.adaptive_rebuild():
            # the packed union is table-scale, so it gets the same speed
            # -certified K=4->8 cadence a single scene of that size would
            from ..engine_table import make_adaptive_run_chunk

            run = make_adaptive_run_chunk(pp, phase_fn=phase_fn)
        else:
            run = make_run_chunk_table(pp, phase_fn=phase_fn)
        while len(_RUN_CHUNK_CACHE) > 16:
            _RUN_CHUNK_CACHE.pop(next(iter(_RUN_CHUNK_CACHE)))
        _RUN_CHUNK_CACHE[key] = run
    return run


def run_sweep_packed(
    params: SimParams,
    seeds: Sequence[int],
    n_steps: int,
    record_every: int | None = None,
):
    """Packed-strategy sweep: same contract as run_sweep — returns
    ``(final_state, centroids (n_records, n_scenes, 2))`` with centroids in
    SCENE-LOCAL coordinates.  The final state is the packed union (callers
    needing per-scene final states should use :func:`unpack_positions`)."""
    params = resolve_params(params.validate())
    pp, state, origins, pitch = pack_scenes(params, seeds)
    record_every = record_every or params.dump_steps
    run = _packed_runner(pp, origins, pitch)
    seg = gate_seg(pp)
    B, n = len(seeds), params.n_cells
    org = jnp.asarray(origins, jnp.float32)

    def stats(s: SimState):
        # centroid + per-scene bounding box per record: the boxes feed the
        # post-run isolation/wall checks at EVERY record point, not just
        # the final state — all on device, one host sync for the sweep
        pos = s.pos[: B * n].reshape(B, n, 2)
        return (
            jnp.mean(pos, axis=1) - org,
            jnp.min(pos, axis=1),
            jnp.max(pos, axis=1),
        )

    recs = [stats(state)]
    done = 0
    while done < n_steps:
        chunk = min(record_every, n_steps - done)
        state = run(state, chunk, seg > 0 and done % seg == 0)
        done += chunk
        recs.append(stats(state))
    # one host sync for the whole sweep
    stacked = jax.device_get(jax.tree.map(lambda *xs: jnp.stack(xs), *recs))
    centroids, lo, hi = (np.asarray(x) for x in stacked)
    _check_health(params, pp, origins, pitch, centroids, lo, hi)
    return state, centroids


def unpack_positions(state: SimState, origins: np.ndarray, n: int):
    """(B, n, 2) scene-local positions from a packed final state."""
    B = len(origins)
    pos = np.asarray(jax.device_get(state.pos))[: B * n].reshape(B, n, 2)
    return pos - np.asarray(origins)[:, None, :]


def _check_health(
    params: SimParams,
    pp: SimParams,
    origins: np.ndarray,
    pitch: float,
    centroids: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
) -> None:
    """Hard post-run checks for the packing invariants, evaluated at every
    record point from the (T, B, 2) per-scene centroid and bounding-box
    histories.

    1. isolation: pairwise scene box gaps exceed the force kernel's
       pairing reach (cross-scene pairs impossible throughout the run up
       to the record cadence of this check);
    2. wall fidelity: no scene's local extent reached where ITS OWN walls
       (scene world_half) would have clamped it — if they would, the packed
       run is not equivalent to per-scene runs and must not be used;
    3. scene-assignment margin: every scene's box stays within the open
       pitch/2 Voronoi cell of its own origin in the union-mean-centered
       frame, so the phase hook's closed-form tile decode was exact;
    4. grid fit: the union span never exceeded the wrapped table
       (grid_dim cells) — past it, world cells alias onto the same table
       cell and overflow its capacity (the same invariant
       Simulation._check_grid_fits guards for single-scene runs)."""
    cutoff = params.cutoff()
    # isolation: pairwise Chebyshev gap between scene bounding boxes in
    # PACKED coordinates must exceed the force kernel's pairing reach
    # (one 3x3 cell window + one cell of bbox-anchor slack).  Boxes are
    # about the blob (which sits at origin + placement center), not the
    # origin — accretion blobs center away from the scene frame origin.
    gap_x = np.maximum(
        lo[:, :, None, 0] - hi[:, None, :, 0],
        lo[:, None, :, 0] - hi[:, :, None, 0],
    )
    gap_y = np.maximum(
        lo[:, :, None, 1] - hi[:, None, :, 1],
        lo[:, None, :, 1] - hi[:, :, None, 1],
    )
    gap = np.maximum(gap_x, gap_y)  # (T, B, B) Chebyshev box gap
    B = lo.shape[1]
    gap[:, np.arange(B), np.arange(B)] = np.inf
    iso_limit = 2.0 * cutoff
    if (gap < iso_limit).any():
        t, i, j = np.unravel_index(int(np.argmin(gap)), gap.shape)
        raise RuntimeError(
            f"packed sweep isolation violated: scenes {i} and {j} are "
            f"{gap[t, i, j]:.2f} apart at record {t} (< {iso_limit:.2f}, "
            f"pitch {pitch:.2f}); trajectories may include cross-scene "
            f"contacts — rerun with strategy='sequential' or 'batched'"
        )
    # scene world box: explicit cfg value, or the >=64 auto-fit floor a
    # per-scene run would resolve (placement.autofit_world_half adds 25%
    # headroom over the initial span, so the floor is the binding value
    # for every packed-eligible scenario scale; larger auto-fits only
    # make this check conservative, never silently permissive)
    scene_wh = params.world_half if params.world_half > 0 else 64.0
    # per-scene Chebyshev extent in SCENE-LOCAL coordinates, per record
    org = np.asarray(origins)[None, :, :]  # (1, B, 2)
    ext = np.maximum(np.abs(lo - org), np.abs(hi - org)).max(axis=-1)  # (T, B)
    wall = scene_wh - 2.0 * params.max_radius
    if (ext >= wall).any():
        t, bad = np.unravel_index(int(np.argmax(ext)), ext.shape)
        raise RuntimeError(
            f"packed sweep wall fidelity violated: scene {bad} local extent "
            f"{ext[t, bad]:.2f} at record {t} reached the scene world box "
            f"±{scene_wh:g} (packed runs have no per-scene walls) — rerun "
            f"with strategy='sequential' or 'batched'"
        )
    # scene-assignment margin: the phase hook decodes scenes by rounding
    # union-mean-centered positions to the origin grid — exact iff every
    # bot stays within pitch/2 of its own origin per axis in that frame
    u = (centroids + org).mean(axis=1)  # (T, 2) union bot-mean (equal n)
    org_cc = np.asarray(origins) - np.asarray(origins).mean(axis=0)
    dev = np.maximum(
        np.abs(lo - u[:, None, :] - org_cc[None]),
        np.abs(hi - u[:, None, :] - org_cc[None]),
    ).max(axis=-1)  # (T, B)
    if (dev >= 0.5 * pitch).any():
        t, bad = np.unravel_index(int(np.argmax(dev)), dev.shape)
        raise RuntimeError(
            f"packed sweep scene-assignment margin violated: scene {bad} "
            f"strays {dev[t, bad]:.2f} from its tile origin at record {t} "
            f"(>= pitch/2 = {0.5 * pitch:.2f}); the per-scene phase law may "
            f"have mis-assigned bots — rerun with strategy='sequential' or "
            f"'batched'"
        )
    # grid fit: union span vs the wrapped table
    g = pp.resolved_grid_dim()
    span = (hi.max(axis=1) - lo.min(axis=1)).max(axis=-1)  # (T,)
    span_cells = np.ceil(span / cutoff)
    if (span_cells > g).any():
        t = int(np.argmax(span_cells))
        raise RuntimeError(
            f"packed sweep grid fit violated: union span {span[t]:.2f} "
            f"(= {int(span_cells[t])} cells) at record {t} exceeds the "
            f"wrapped table (grid_dim {g}) — world cells would alias; "
            f"rerun with strategy='sequential' or 'batched'"
        )
