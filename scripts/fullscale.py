"""Run every shipped reference scenario at FULL scale on the current backend
and write the results as JSON (default artifacts/fullscale_results.json).

Usage:  PYTHONPATH=. python scripts/fullscale.py [out.json]

Each examples/*.cfg runs unmodified to its full max_time (the reference runs
these as multi-hour interactive GLUT sessions; see docs/RESULTS.md for the
wall-clock comparison).  Health (finite state, zero cell overflow) is asserted
after every run.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    from particlerobotsimulations_tpu import Simulation, load_cfg

    out_path = Path(sys.argv[1]) if len(sys.argv) > 1 else (
        REPO / "artifacts" / "fullscale_results.json"
    )
    results = {}
    for cfg in sorted((REPO / "examples").glob("*.cfg")):
        params = load_cfg(str(cfg))
        light = np.array([params.light_x, params.light_y])
        sim = Simulation(params)
        d0 = float(np.linalg.norm(np.asarray(sim.centroid()) - light))
        t0 = time.perf_counter()
        sim.run()
        wall = time.perf_counter() - t0
        health = sim.health()
        assert health["finite"], f"{cfg.name}: non-finite state"
        assert health["cell_overflow"] == 0, f"{cfg.name}: cell overflow"
        d1 = float(np.linalg.norm(np.asarray(sim.centroid()) - light))
        results[cfg.stem] = {
            "bots": params.n_cells,
            "sim_seconds": params.max_time,
            "steps": params.n_steps(),
            "wall_seconds": round(wall, 1),
            "dist_to_light_start": round(d0, 3),
            "dist_to_light_end": round(d1, 3),
            "backend": params.resolved_backend().name,
        }
        print(f"{cfg.stem}: {params.n_cells} bots, {params.n_steps()} steps, "
              f"{wall:.0f}s wall, dist {d0:.2f} -> {d1:.2f} "
              f"[{results[cfg.stem]['backend']}]", flush=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(results, indent=2) + "\n")
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
