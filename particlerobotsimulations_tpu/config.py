"""Typed simulation parameters + ``.cfg`` loader.

JAX re-design of the reference's config/flag system
(/root/reference/main.cpp:594-816 ``setParam`` and the defaults at
main.cpp:833-911).  Differences from the reference, on purpose:

* Exact key matching instead of ``strncmp`` prefix matching.  The reference's
  prefix matching makes ``constraint`` shadow ``constraint_contraction``
  (main.cpp:725-733) and the ``config`` key can never change value because the
  comparison reads the key instead of the value (main.cpp:794-809).  Both are
  latent bugs we do not replicate.
* Lines shorter than 4 characters are *not* skipped (the reference skips them
  at main.cpp:923-924, which silently makes ``Nx`` unsettable).  Only blank
  lines and ``#`` comments are skipped.
* Everything is a frozen, hashable dataclass so it can be passed to jitted
  functions as a static argument: obstacle lists are tuples, enums are
  ``IntEnum``.  XLA bakes the constants into the compiled program, which is
  what you want for a fixed scenario.

All parameter names and defaults match the reference so the five shipped
``examples/*.cfg`` scenarios load unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple


class Config(enum.IntEnum):
    """Initial swarm layout (reference: particlebot_kernel.cuh:30-40)."""

    RANDOM = 0
    GRID = 1
    BLOB = 2
    BLOB_UPLEFT = 3
    HEX = 4
    LINE = 5
    LIGHTTEST_7 = 6


class Control(enum.IntEnum):
    """Actuation controller (reference: particlebot_kernel.cuh:52-55 defines
    only LIGHT_WAVE; FIXED_PHASE is a framework extension where per-bot
    phases are scripted/learned instead of derived from the light — the
    substrate for differentiable actuation optimization)."""

    LIGHT_WAVE = 0
    FIXED_PHASE = 1


class ForceBackend(enum.IntEnum):
    """Which neighbor-force implementation the engine uses.

    DENSE     masked O(N^2) pairwise forces — exact, best for small swarms.
    CELLGRID  wrapped fixed-capacity cell table with explicit candidate
              gathers (the reference's uniform grid at
              particlebot_kernel_impl.cuh:445-538, rebuilt every step instead
              of the reference's stale-sort scheme).  Kept as a readable
              reference implementation.
    STENCIL   the same cell table computed as a dense 3x3 jnp.roll stencil
              (see ops/stencil.py) — the portable scalable path on the CPU.
    PALLAS    the table-resident step loop (engine_table.py) with the
              neighbour-force Pallas kernel (ops/pallas_stencil.py) — the
              production backend for large swarms on the GPU.  The name
              stays because user cfgs select it (``force_backend PALLAS``).
    AUTO      pick per scenario size and platform (resolved_backend).
    """

    AUTO = 0
    DENSE = 1
    CELLGRID = 2
    STENCIL = 3
    PALLAS = 4


# AUTO's DENSE/PALLAS crossover on the GPU (SimParams.resolved_backend).
# Measured on an H100 (HEX phototaxis, CHANGES.md): per step the table
# loop beats DENSE at every size from 64 bots up, by ~16 us/step at 300-640
# bots and ~80 us/step at 2000, but its program takes ~15 s longer to
# compile.  Up to this size a reference-length run (example.cfg: 7200
# sim-s, 720k steps) therefore finishes sooner on DENSE unless the compile
# cache is warm; DENSE also has no cell grid for a LINE or GRID layout to
# outgrow.
GPU_DENSE_MAX_BOTS = 640


_CONFIG_NAMES = {
    "CONFIG_RANDOM": Config.RANDOM,
    "CONFIG_GRID": Config.GRID,
    "CONFIG_BLOB": Config.BLOB,
    "CONFIG_BLOB_UPLEFT": Config.BLOB_UPLEFT,
    "CONFIG_HEX": Config.HEX,
    "CONFIG_LINE": Config.LINE,
    "CONFIG_LIGHTTEST_7": Config.LIGHTTEST_7,
}


@dataclasses.dataclass(frozen=True)
class SimParams:
    """All simulation parameters (reference: particlebot_kernel.cuh:58-120
    plus the app-level knobs owned by main.cpp).

    Frozen + hashable: safe to close over in ``jax.jit`` as a static arg.
    Defaults replicate main.cpp:833-911.
    """

    # --- swarm ------------------------------------------------------------
    n_cells: int = 501
    n_dead: int = -1          # -1 => last bot is a transported payload object
    seed: int = 0
    config: Config = Config.RANDOM
    control: Control = Control.LIGHT_WAVE

    # --- robot geometry / actuation ---------------------------------------
    min_radius: float = 0.0775
    max_radius: float = 0.1175
    rise_period: float = 2.0
    nx: int = 5               # wave duty cycle: period = (nx+1)*rise_period
    constraint: float = 0.5
    constrained_contraction: int = 0
    constraint_contraction: float = 10.0

    # --- contact / magnet physics ------------------------------------------
    spring: float = 1000.0
    damping: float = 10.0
    shear: float = 40.0
    attraction: float = 3.0 * 0.000015884
    friction: float = 0.4
    gravity: float = 9.81 * 0.566
    boundary_damping: float = -1.0

    # --- payload (object transport, n_dead == -1) --------------------------
    rad_factor: float = 2.0
    mass_factor: float = 1.0
    friction_factor: float = 1.0
    attraction_factor: float = 0.0

    # --- light / phase controller ------------------------------------------
    light_x: float = -5.0
    light_y: float = 0.0
    light_shadow: int = 0     # 0 none; 1 shadow modulates last; 2 never
    phase_std: float = 0.3 * 2.0
    phase_update_interval: float = 12.0

    # --- schedule ----------------------------------------------------------
    timestep: float = 0.01
    max_time: float = 6400.0
    time_to_dead: float = 0.0
    dump_interval: float = 60.0
    sort_interval: float = 180.0
    centroid_int: float = 10.0
    centroid_steps: int = 24000
    centroid_radius: float = 0.05
    testing: int = 0

    # --- obstacles ----------------------------------------------------------
    # rectangles as (x1, x2, y1, y2); circles as (x, y, r)
    rect_obstacles: Tuple[Tuple[float, float, float, float], ...] = ()
    circle_obstacles: Tuple[Tuple[float, float, float], ...] = ()

    # --- world --------------------------------------------------------------
    # half-extent of the square world box; the integrator clamps positions at
    # +-world_half exactly like the reference's hardcoded +-64
    # (particlebot_kernel_impl.cuh:84-99, main.cpp:937-939).  64 is the
    # reference-parity default; 0 = AUTO-FIT: derived from the placement
    # extent + margin at state creation (models/placement.autofit_world_half)
    # so oversized swarms (a >=600k-bot HEX blob spans past 64) get a box
    # that fits without a hand-set value.
    world_half: float = 64.0

    # --- output / render ----------------------------------------------------
    csv_filename: str = "particle_bot_output_data.csv"
    video_filename: str = "particle_bot_output_video.avi"
    camera_x: float = 0.0
    camera_y: float = 10.0
    light_radius: float = 0.25
    display_shadow: int = 0
    display_interval: int = 600
    video_interval: int = 1

    # --- engine knobs (no reference equivalent) ------------------------------
    force_backend: ForceBackend = ForceBackend.AUTO
    # Pair interaction cutoff.  The reference's 5x5-cell scan over a
    # 2*max_radius grid (particlebot_kernel_impl.cuh:691-699) reaches between
    # 2 and ~3.5 cell sizes depending on in-cell placement; forces at such
    # gaps are far below the static-friction floor, so any cutoff >= 2 cells
    # is behaviorally equivalent.  0 => derived as 2.2 * cell_size().
    neighbor_cutoff: float = 0.0
    # Cell-grid backend geometry: table is (grid_dim^2, cell_capacity),
    # anchored to the swarm's bounding box each step (dynamic origin) and
    # wrapped modulo grid_dim — the bbox anchoring keeps table occupancy
    # high, the wrap (same trick as calcGridHash,
    # particlebot_kernel_impl.cuh:114-120, but swarm-anchored) makes
    # stragglers safe: aliased far pairs are killed by the true-distance
    # cutoff.  0 => auto-size from the expected packed-blob diameter.
    # Any size works: the force kernel's cell tile falls back to the
    # largest power of two <= ops/pallas_stencil.TILE that divides the
    # target window (an even grid_dim keeps the full tile).  The auto size
    # is a multiple of 16, so 2, 4, 8 or 16 shards of the sharded table
    # divide it as it is.
    grid_dim: int = 0
    cell_capacity: int = 16
    # Spill slots above cell_capacity (table loop only): bots ranked
    # past cell_capacity in an over-full cell live in these rows — active
    # (they integrate, actuate, count for phase/centroid) but invisible to
    # the force kernel, and automatically re-promoted by the next slot
    # rebuild when their cell has room.  Without spill room, large
    # compressed swarms (the occupancy tail pokes past capacity every few
    # steps at 250k bots) park bots in the forceless parking strip.
    # -1 => auto: 8 when n_cells > 100_000 else 0.  The threshold is set
    # from reference-density HEX phototaxis occupancy (max real occupancy
    # over 60k steps: 15/16 at 100k, exactly 16/16 at 131k — zero margin,
    # so spill stays on past 100k); unused spill rows still cost every
    # rebuild and elementwise op.  Scenarios that compress harder degrade
    # gracefully without spill — the parking strip + the dump-time
    # occupancy warning — and can set this key explicitly.
    overflow_slots: int = -1
    # Rebuild the cell-slot assignment every N steps (PALLAS backend).  The
    # argsort-based assignment is the step's one sort; bots drift ~5e-4
    # cells/step, so brief reuse cannot drop a contact unless a pair
    # closes > cell_size within the window (would need relative speed > 2.3
    # at the default 4).  The reference reuses its sort for sort_interval =
    # 180 s = 18000 steps (particlebot.cpp:256) with far weaker guarantees.
    # 1 = rebuild every step (exact).  -1 = AUTO: the base cadence 4, with
    # SPEED-CERTIFIED adaptive doubling to 8 on tables from 4096 bots up
    # (adaptive_rebuild):
    # each chunk opens with a probe segment that measures an upper bound on
    # the max pair-closing speed (local 3x3-neighborhood velocity
    # envelopes, engine_table.neighbor_rel_speed_bound); K=8 runs only
    # while the measured bound stays below the geometry-derived certificate
    # engine_table.certified_closing_bound (no contact loss + missed
    # magnet-tail force < 1% of plateau; 3.4 u/s at defaults), and any
    # violation drops back to K=4 within one 200-step segment
    # (engine_table.make_adaptive_run_chunk).
    slot_rebuild_steps: int = -1

    # ------------------------------------------------------------------ API

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)

    # Derived quantities ----------------------------------------------------

    def cell_size(self) -> float:
        """Uniform-grid cell size (reference: main.cpp:932-935)."""
        if (
            self.n_dead == -1
            and self.max_radius * 0.5 * self.rad_factor > 2 * self.max_radius
        ):
            return self.max_radius * 0.5 * self.rad_factor + 4 * self.max_radius
        return self.max_radius * 2.0

    def cutoff(self) -> float:
        if self.neighbor_cutoff > 0:
            return self.neighbor_cutoff
        return 2.2 * self.cell_size()

    def n_steps(self) -> int:
        return int(round(self.max_time / self.timestep))

    def steps_of(self, interval_seconds: float) -> int:
        """Interval in whole steps (>=1).

        The reference gates on ``time - I*floor(time/I) < dt``
        (particlebot.cpp:207,212,256) which fires on the first step of every
        interval window; with integer step counters that is
        ``step % steps_of(I) == 0``.
        """
        return max(1, int(round(interval_seconds / self.timestep)))

    @property
    def phase_update_steps(self) -> int:
        return self.steps_of(self.phase_update_interval)

    @property
    def centroid_steps_interval(self) -> int:
        return self.steps_of(self.centroid_int)

    @property
    def dump_steps(self) -> int:
        return self.steps_of(self.dump_interval)

    @property
    def dead_step(self) -> int:
        return int(round(self.time_to_dead / self.timestep))

    @property
    def has_payload(self) -> bool:
        return self.n_dead == -1

    def wave_period(self) -> float:
        return (self.nx + 1) * self.rise_period

    def resolved_backend(self) -> ForceBackend:
        """AUTO resolution by platform: on the GPU, DENSE up to
        GPU_DENSE_MAX_BOTS and the PALLAS table loop above; on the CPU,
        DENSE up to 2048 bots and the XLA stencil above.  Any other
        platform has no force path and raises."""
        if self.force_backend != ForceBackend.AUTO:
            return self.force_backend
        import jax

        platform = jax.default_backend()
        if platform == "gpu":
            if self.n_cells <= GPU_DENSE_MAX_BOTS:
                return ForceBackend.DENSE
            return ForceBackend.PALLAS
        if platform == "cpu":
            if self.n_cells <= 2048:
                return ForceBackend.DENSE
            return ForceBackend.STENCIL
        raise ValueError(
            f"force_backend AUTO has no rule for platform {platform!r}: "
            "the simulator runs on 'gpu' or 'cpu'"
        )

    def validate(self) -> "SimParams":
        if self.n_cells < 1:
            raise ValueError("n_cells must be >= 1")
        if len(self.rect_obstacles) > 10 or len(self.circle_obstacles) > 10:
            # The reference's __constant__ arrays hold at most 10 obstacles
            # (particlebot_kernel_impl.cuh:28-34).  We keep the limit for
            # scenario parity; the code itself has no such cap.
            raise ValueError("at most 10 obstacles of each kind")
        if self.min_radius <= 0 or self.max_radius < self.min_radius:
            raise ValueError("need 0 < min_radius <= max_radius")
        if self.grid_dim < 0:
            raise ValueError("grid_dim must be 0 (auto) or positive")
        if self.cell_capacity < 1:
            raise ValueError("cell_capacity must be >= 1")
        if self.slot_rebuild_steps < 1 and self.slot_rebuild_steps != -1:
            raise ValueError(
                "slot_rebuild_steps must be >= 1, or -1 (auto: base 4 + "
                "speed-certified adaptive 8 on large tables)"
            )
        if self.world_half < 0:
            raise ValueError(
                "world_half must be >= 0 (0 = auto-fit from the placement "
                "extent, resolved by Simulation/initial_state_arrays)"
            )
        if self.overflow_slots < -1:
            raise ValueError("overflow_slots must be -1 (auto) or >= 0")
        return self

    def resolved_overflow_slots(self) -> int:
        if self.overflow_slots >= 0:
            return self.overflow_slots
        return 8 if self.n_cells > 100_000 else 0

    def resolved_slot_rebuild_steps(self) -> int:
        """The BASE rebuild cadence every compiled step function uses; -1
        (auto) resolves to the validated default 4.  The speed-certified
        doubling to 8 is a chunk-driver concern, not a compile-time one —
        see :meth:`adaptive_rebuild` and
        engine_table.make_adaptive_run_chunk."""
        if self.slot_rebuild_steps == -1:
            return 4
        return self.slot_rebuild_steps

    def adaptive_rebuild(self) -> bool:
        """Whether the chunk driver should run the speed-certified adaptive
        rebuild cadence (K in {4, 8}).  Only in auto mode and only from 4k
        bots up: below that the rebuild is too small a share of the step
        to pay for the probe segment."""
        return self.slot_rebuild_steps == -1 and self.n_cells >= 4096

    def storage_capacity(self) -> int:
        """Table slots per cell: force-visible capacity + spill rows."""
        return self.cell_capacity + self.resolved_overflow_slots()

    def resolved_grid_dim(self) -> int:
        """Cell-table side length.  Auto mode sizes the wrapped, bbox-anchored
        grid to ~2x the packed-blob diameter (hex close packing of n disks of
        min_radius has diameter ~ 2.1 * min_radius * sqrt(n))."""
        if self.grid_dim:
            return self.grid_dim
        import math

        diameter = 2.1 * self.min_radius * math.sqrt(max(self.n_cells, 1))
        cells = 1.5 * diameter / self.cutoff()
        return max(16, int(math.ceil(cells / 16.0)) * 16)


# --------------------------------------------------------------------------
# .cfg parsing (format: alternating name/value lines, '#' comments;
# reference parse loop at main.cpp:923-928)
# --------------------------------------------------------------------------

def _floats(value: str) -> Tuple[float, ...]:
    return tuple(float(tok) for tok in value.replace(",", " ").split())


def parse_cfg_text(text: str, base: SimParams | None = None) -> SimParams:
    """Parse reference-format cfg text into a ``SimParams``."""
    lines = [
        ln.strip()
        for ln in text.splitlines()
        if ln.strip() and not ln.strip().startswith("#")
    ]
    if len(lines) % 2:
        raise ValueError("cfg must contain alternating name/value lines")
    kv = {lines[i]: lines[i + 1] for i in range(0, len(lines), 2)}
    return params_from_dict(kv, base=base)


def params_from_dict(kv: dict, base: SimParams | None = None) -> SimParams:
    p = base or SimParams()
    updates: dict = {}

    # obstacle assembly (reference stores them as parallel arrays,
    # main.cpp:601-676)
    def _obstacles(count_key: str, coord_keys: tuple, field: str) -> None:
        """cfg -> ``field`` update.  An explicit '<count_key> 0' clears
        obstacles inherited from the base params (the reference's obstacle
        loops iterate zero times when the count is 0); a cfg mentioning
        neither the count nor any coordinate column inherits the base
        untouched; coordinate columns without a count are ignored like the
        reference's default nobstacles=0."""
        raw = kv.pop(count_key, None)
        cols_in = {k: kv.pop(k, None) for k in coord_keys}
        if raw is None and all(v is None for v in cols_in.values()):
            return  # not mentioned: inherit
        n = int(raw) if raw is not None else 0
        if not n:
            updates[field] = ()
            return
        cols = []
        for k in coord_keys:
            if cols_in[k] is None:
                raise ValueError(f"{count_key}={n} but '{k}' missing")
            vals = _floats(cols_in[k])
            if len(vals) < n:
                raise ValueError(f"'{k}' needs {n} values")
            cols.append(vals[:n])
        updates[field] = tuple(zip(*cols))

    _obstacles("nobstacles", ("x1obs", "x2obs", "y1obs", "y2obs"), "rect_obstacles")
    _obstacles(
        "n_cir_obstacles", ("x_cir_obs", "y_cir_obs", "r_cir_obs"), "circle_obstacles"
    )

    _INT = int
    _FLT = float
    _STR = str
    field_map = {
        # cfg key -> (dataclass field, converter)
        "nCells": ("n_cells", _INT),
        "nDead": ("n_dead", _INT),
        "seed": ("seed", _INT),
        "min_radius": ("min_radius", _FLT),
        "max_radius": ("max_radius", _FLT),
        "rise_period": ("rise_period", _FLT),
        "Nx": ("nx", _INT),
        "constraint": ("constraint", _FLT),
        "constrained_contraction": ("constrained_contraction", _INT),
        "constraint_contraction": ("constraint_contraction", _FLT),
        "spring": ("spring", _FLT),
        "damping": ("damping", _FLT),
        "shear": ("shear", _FLT),
        "attraction": ("attraction", _FLT),
        "friction": ("friction", _FLT),
        "gravity": ("gravity", _FLT),
        "boundaryDamping": ("boundary_damping", _FLT),
        "radFactor": ("rad_factor", _FLT),
        "massFactor": ("mass_factor", _FLT),
        "frictionFactor": ("friction_factor", _FLT),
        "attractionFactor": ("attraction_factor", _FLT),
        "light_x": ("light_x", _FLT),
        "light_y": ("light_y", _FLT),
        "light_shadow": ("light_shadow", _INT),
        "phase_std": ("phase_std", _FLT),
        "phase_update_interval": ("phase_update_interval", _FLT),
        "timestep": ("timestep", _FLT),
        "max_time": ("max_time", _FLT),
        "time_to_dead": ("time_to_dead", _FLT),
        "dump_interval": ("dump_interval", _FLT),
        "sort_interval": ("sort_interval", _FLT),
        "centroid_int": ("centroid_int", _FLT),
        "centroid_steps": ("centroid_steps", _INT),
        "centroid_radius": ("centroid_radius", _FLT),
        "testing": ("testing", _INT),
        "csv_filename": ("csv_filename", _STR),
        "video_filename": ("video_filename", _STR),
        "camera_x": ("camera_x", _FLT),
        "camera_y": ("camera_y", _FLT),
        "light_radius": ("light_radius", _FLT),
        "display_shadow": ("display_shadow", _INT),
        "DISPLAY_INTERVAL": ("display_interval", _INT),
        "VIDEO_INTERVAL": ("video_interval", _INT),
        # engine extensions
        "force_backend": ("force_backend", lambda v: ForceBackend[v.upper()]),
        "neighbor_cutoff": ("neighbor_cutoff", _FLT),
        "grid_dim": ("grid_dim", _INT),
        "cell_capacity": ("cell_capacity", _INT),
        "overflow_slots": ("overflow_slots", _INT),
        "slot_rebuild_steps": ("slot_rebuild_steps", _INT),
        "world_half": ("world_half", _FLT),
    }

    for key, value in kv.items():
        if key == "config":
            name = value.strip()
            if name not in _CONFIG_NAMES:
                raise ValueError(f"unknown config layout '{name}'")
            updates["config"] = _CONFIG_NAMES[name]
            continue
        if key not in field_map:
            raise ValueError(f"unknown cfg key '{key}'")
        field, conv = field_map[key]
        updates[field] = conv(value)

    # NOTE: the reference derives phase_std = 0.3*rise_period only in the
    # DEFAULTS block (main.cpp:899); setParam('rise_period') (main.cpp:779)
    # never re-derives it.  A cfg that sets rise_period therefore keeps the
    # default phase_std = 0.6 unless it sets phase_std explicitly.

    return p.replace(**updates).validate()


def load_cfg(path: str, base: SimParams | None = None) -> SimParams:
    with open(path, "r", encoding="utf-8") as f:
        return parse_cfg_text(f.read(), base=base)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_n(params: SimParams, multiple: int = 128) -> int:
    """Bot-array padding to a multiple of 128 (whole warps of 32 and
    power-of-two-friendly shapes for the kernels)."""
    return round_up(params.n_cells, multiple)
