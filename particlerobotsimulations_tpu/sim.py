"""High-level simulation driver — the app layer.

Equivalent of the reference's GLUT application loop
(/root/reference/main.cpp:823-967 + the per-frame display() loop at
main.cpp:354-481), minus the interactive window: scenario setup from a
``.cfg``, the step loop in dump-interval chunks (each chunk one jitted
``lax.scan`` — the device never syncs mid-chunk), CSV metrics, checkpoints,
resume, and optional headless video rendering.
"""

from __future__ import annotations

from math import gcd as math_gcd
from typing import Callable, Optional

import jax
import numpy as np

from .config import SimParams, load_cfg
from .engine import make_run_chunk
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.csvio import CsvDumper, load_last_row
from .models.placement import initial_state_arrays
from .state import SimState, make_state


class Simulation:
    """Owns params + state and drives the step loop.

    Typical use::

        sim = Simulation.from_cfg("examples/example.cfg")
        sim.run()                      # full scenario, CSV to params.csv_filename
    """

    def __init__(self, params: SimParams, state: Optional[SimState] = None):
        if state is None:
            params, pos, vel, rad, phase, dead = initial_state_arrays(params)
            state = make_state(params, pos, vel, rad, phase, dead)
        elif params.world_half == 0:
            # auto-fit from the restored state's active rows (padding rows
            # carry sentinel positions and must not widen the box)
            from .models.placement import autofit_world_half
            from .state import active_mask

            m = np.asarray(
                jax.device_get(active_mask(params, state.pos.shape[0]))
            )
            p_act = np.asarray(jax.device_get(state.pos))[m]
            params = autofit_world_half(params, p_act)
        self.params = params
        self.state = state
        self._run_chunk = make_run_chunk(params)
        from .config import ForceBackend
        from .engine_table import gate_seg

        self._gate_seg = (
            gate_seg(params.validate())
            if params.validate().resolved_backend() == ForceBackend.PALLAS
            else 0
        )
        pos = np.asarray(jax.device_get(state.pos[: params.n_cells]))
        span = float(np.abs(pos).max()) if pos.size else 0.0
        if span >= params.world_half:
            # the integrator clamps at +-world_half exactly like the
            # reference (particlebot_kernel_impl.cuh:84-99), so bots placed
            # outside the box pile up at the walls from step 1 and every
            # measured "physics" is a wall-pileup ring, not a swarm.  An
            # undersized box is always a mis-sized scenario now that
            # world_half 0 = auto-fit exists, so fail loudly (a warning in
            # a minutes-long-compile workflow is too easy to miss)
            raise ValueError(
                f"initial swarm spans +-{span:.1f} but world_half="
                f"{params.world_half:g}: bots outside the box would be "
                "clamped to the walls every step — raise the world_half "
                "cfg key, or set world_half 0 to auto-fit the placement"
            )
        if params.validate().resolved_backend() == ForceBackend.PALLAS:
            # the wrapped table holds the swarm without aliasing only when
            # the swarm FITS the grid — an undersized user-set grid_dim
            # would fold distant cells onto one table cell and overflow
            # its capacity, so fail loudly up front
            self._check_grid_fits(pos, raise_init=True)

    # ------------------------------------------------------------ builders

    @classmethod
    def from_cfg(cls, path: str, base: SimParams | None = None, **overrides):
        params = load_cfg(path, base=base)
        if overrides:
            params = params.replace(**overrides)
        return cls(params)

    @classmethod
    def from_checkpoint(cls, path: str):
        params, state = load_checkpoint(path)
        return cls(params, state=state)

    @classmethod
    def resume_from_csv(cls, params: SimParams, csv_path: str):
        """Continue from the last complete CSV row (reference ``cont`` mode,
        main.cpp:941-956).  Phase/dead are NOT in the CSV — same fidelity gap
        as the reference; prefer checkpoints."""
        row = load_last_row(params, csv_path)
        if row is None:
            return cls(params)
        t, pos, vel, rad = row
        if params.n_dead > 0 and t >= params.time_to_dead:
            import warnings

            warnings.warn(
                f"CSV resume at t={t:g}s is at/past time_to_dead="
                f"{params.time_to_dead:g}s: the CSV stores no dead flags "
                f"(reference fidelity, particlebot.cpp:369-411) and the "
                f"one-shot injection step is already behind the resumed "
                f"counter, so the continued run has ZERO dead bots instead "
                f"of the {params.n_dead} the original run killed. Use "
                f"checkpoints (Simulation.from_checkpoint) for exact "
                f"continuation.",
                stacklevel=2,
            )
        sim = cls(params)  # placement establishes dead flags / payload
        n = params.n_cells
        new_state = sim.state._replace(
            pos=sim.state.pos.at[:n].set(pos),
            vel=sim.state.vel.at[:n].set(vel),
            rad=sim.state.rad.at[:n].set(rad),
            step=np.int32(round(t / params.timestep)),
        )
        sim.state = new_state
        return sim

    # ------------------------------------------------------------ stepping

    @property
    def time(self) -> float:
        return float(jax.device_get(self.state.step)) * self.params.timestep

    def host_view(self):
        """(pos, vel, rad) host copies, unpadded."""
        n = self.params.n_cells
        pos, vel, rad = jax.device_get(
            (self.state.pos[:n], self.state.vel[:n], self.state.rad[:n])
        )
        return np.asarray(pos), np.asarray(vel), np.asarray(rad)

    def centroid(self) -> np.ndarray:
        pos, _, _ = self.host_view()
        return pos.mean(axis=0)

    def step_chunk(self, n_steps: int, start_step: int | None = None):
        """Advance ``n_steps``.  When the caller knows the host-side step
        counter (``start_step``), chunks entered on a gate-segment boundary
        take the amortized-cond fast path (engine_table.gate_seg)."""
        aligned = (
            self._gate_seg > 0
            and start_step is not None
            and start_step % self._gate_seg == 0
        )
        self.state = self._run_chunk(self.state, n_steps, aligned)

    def health(self) -> dict:
        """Runtime diagnostics: divergence and neighbor-table overflow.

        The reference's only runtime checks are checkCudaErrors after each
        launch; here we expose physics-level health: finite state, velocity
        sanity and the cell-capacity overflow counter (dropped contacts)."""
        from .config import ForceBackend
        from .ops.pallas_stencil import assign_slots_slotmajor
        from .state import active_mask

        n = self.params.n_cells
        pos, vel, rad = self.host_view()
        out = {
            "finite": bool(np.isfinite(pos).all() and np.isfinite(vel).all()),
            "max_speed": float(np.linalg.norm(vel, axis=1).max()),
            "min_pair_distance": None,
            "cell_overflow": 0,
        }
        if n <= 4096:
            d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            out["min_pair_distance"] = float(d.min())
        if self.params.resolved_backend() != ForceBackend.DENSE:
            mask = active_mask(self.params, self.state.pos.shape[0])
            _, overflow = assign_slots_slotmajor(self.params, self.state.pos, mask)
            out["cell_overflow"] = int(jax.device_get(overflow))
        return out

    def _check_grid_fits(
        self, pos: np.ndarray, raise_init: bool = False, step_count: int = 0
    ) -> None:
        """Raise when the swarm spans more wrapped-grid cells than the table
        can hold without aliasing (PALLAS table loop only).

        A swarm wider than grid_dim cells wraps around the table: world
        cells grid_dim apart share one table cell, whose capacity then
        drops contacts, so it is an error, not a warning."""
        from .config import ForceBackend

        if self.params.resolved_backend() != ForceBackend.PALLAS:
            return
        ok = np.isfinite(pos).all(axis=1)
        if not ok.any():
            return
        p = pos[ok]
        cutoff = self.params.cutoff()
        spanned = (
            int((np.floor(p.max(axis=0) / cutoff) - np.floor(p.min(axis=0) / cutoff)).max())
            + 1
        )
        g = self.params.resolved_grid_dim()
        if spanned > g:
            where = (
                "initial state"
                if raise_init
                else f"t={step_count * self.params.timestep:g}s"
            )
            raise ValueError(
                f"swarm spans {spanned} grid cells at {where} but grid_dim="
                f"{g}: the neighbor table would alias cells. Raise grid_dim "
                f"(cfg key) or leave it 0 (auto)."
            )

    def _check_cell_overflow(self, pos: np.ndarray, step_count: int) -> None:
        """Warn (once) when physical cell occupancy exceeds cell_capacity.

        The slot-table backends (STENCIL/CELLGRID/PALLAS) hold at most
        ``cell_capacity`` bots per neighbor cell and silently drop the rest
        from pair interactions — unlike the reference, whose per-thread
        neighbor loops (particlebot_kernel_impl.cuh:657-700) have no such
        cap.  This probe is pure numpy on the already-fetched host positions
        (the direct position-binning occupancy count), so it costs no device
        dispatches."""
        from .config import ForceBackend

        if self.params.resolved_backend() == ForceBackend.DENSE:
            return
        if getattr(self, "_overflow_warned", False):
            return
        n = self.params.n_cells
        p = pos[:n]
        ok = np.isfinite(p).all(axis=1) & (np.abs(p) <= self.params.world_half).all(
            axis=1
        )
        p = p[ok]
        if p.size == 0:
            return
        bins = np.floor(p / self.params.cutoff()).astype(np.int64)
        _, counts = np.unique(bins, axis=0, return_counts=True)
        max_occ = int(counts.max())
        if max_occ > self.params.cell_capacity:
            import warnings

            self._overflow_warned = True
            warnings.warn(
                f"cell occupancy {max_occ} exceeds cell_capacity="
                f"{self.params.cell_capacity} at t="
                f"{step_count * self.params.timestep:g}s: the neighbor table "
                f"drops the excess bots' contacts. Raise cell_capacity (cfg "
                f"key) or lower the density.",
                RuntimeWarning,
                stacklevel=3,
            )

    def run(
        self,
        max_time: float | None = None,
        csv_path: str | None = None,
        echo: bool = True,
        checkpoint_path: str | None = None,
        checkpoint_every_dumps: int = 0,
        frame_callback: Optional[Callable[["Simulation"], None]] = None,
        frame_every_steps: int | None = None,
        append_csv: bool = False,
        health_check: bool = True,
    ):
        """Run to ``max_time`` (params.max_time by default), dumping CSV rows
        every ``dump_interval`` exactly like the reference display loop.

        The reference dumps *before* stepping each frame (main.cpp:359 vs
        update at main.cpp:361), so row t=0 is the initial condition and the
        last row is at the final dump boundary <= max_time.

        ``frame_callback`` fires every ``frame_every_steps`` physics steps
        (default: params.display_interval, matching the reference's
        DISPLAY_INTERVAL frame cadence at main.cpp:370).
        """
        p = self.params
        total_steps = int(round(
            (p.max_time if max_time is None else max_time) / p.timestep
        ))
        dump_steps = p.dump_steps
        csv_path = csv_path or p.csv_filename
        if frame_every_steps is None:
            frame_every_steps = p.display_interval
        frame_every_steps = max(1, frame_every_steps)
        # host-visible boundaries: finest of dump and frame cadence
        stride = (
            math_gcd(dump_steps, frame_every_steps)
            if frame_callback is not None
            else dump_steps
        )

        import os as _os

        # on append, only skip the header if the target already has content
        # (a fresh/missing file must still get one)
        has_content = (
            append_csv
            and _os.path.exists(csv_path)
            and _os.path.getsize(csv_path) > 0
        )
        out = open(csv_path, "a" if append_csv else "w", encoding="utf-8")
        dumper = CsvDumper(p, out, echo=echo)
        if has_content:
            dumper._wrote_header = True
        dumps_done = 0
        try:
            done = int(jax.device_get(self.state.step))

            start_step = done

            def boundary(step_count):
                nonlocal dumps_done
                if has_content and step_count == start_step:
                    # resuming: the row at the resume point is already in the
                    # file — don't duplicate it (a fresh/empty append target
                    # still gets its t=0 row)
                    if frame_callback is not None:
                        frame_callback(self)
                    return
                # dump only on dump-interval boundaries, like the reference's
                # gate (particlebot.cpp:309) — a max_time that is not a
                # multiple of dump_interval gets no extra final row
                if step_count % dump_steps == 0:
                    pos, vel, rad = self.host_view()
                    if health_check:
                        self._check_grid_fits(pos, step_count=step_count)
                        self._check_cell_overflow(pos, step_count)
                    if health_check and not (
                        np.isfinite(pos).all() and np.isfinite(vel).all()
                    ):
                        # the reference checks every kernel launch
                        # (checkCudaErrors, particlebot_cuda.cu:177); we
                        # check physics-level health at every dump instead
                        # of silently writing NaN rows
                        raise RuntimeError(
                            f"simulation diverged by t={step_count * p.timestep:g}s "
                            f"(non-finite positions/velocities); see "
                            f"Simulation.health() for diagnostics"
                        )
                    dumper.dump(step_count * p.timestep, pos, vel, rad)
                    dumps_done += 1
                    if (
                        checkpoint_path
                        and checkpoint_every_dumps
                        and dumps_done % checkpoint_every_dumps == 0
                    ):
                        save_checkpoint(checkpoint_path, p, self.state)
                if frame_callback is not None and step_count % frame_every_steps == 0:
                    frame_callback(self)

            boundary(done)
            while done < total_steps:
                # a resume from a non-stride-aligned step (e.g. the final
                # checkpoint of a max_time that is not dump-aligned) first
                # steps UP TO the next boundary, so dumps/frames stay on
                # the absolute dump grid instead of never firing again
                chunk = stride - done % stride if done % stride else stride
                chunk = min(chunk, total_steps - done)
                self.step_chunk(chunk, start_step=done)
                done += chunk
                boundary(done)
            if checkpoint_path:
                save_checkpoint(checkpoint_path, p, self.state)
        finally:
            out.close()
        return self
