"""Config system tests: defaults, the 5 shipped example cfgs, parser errors.

Reference defaults from /root/reference/main.cpp:833-911; cfg format from
main.cpp:923-928.
"""

import math

import pytest

from particlerobotsimulations_tpu import Config, ForceBackend, SimParams, load_cfg, parse_cfg_text
from particlerobotsimulations_tpu.config import GPU_DENSE_MAX_BOTS

EXAMPLES = "examples"


def test_defaults_match_reference():
    p = SimParams()
    assert p.n_cells == 501
    assert p.n_dead == -1
    assert p.min_radius == pytest.approx(0.0775)
    assert p.max_radius == pytest.approx(0.1175)
    assert p.spring == 1000.0
    assert p.damping == 10.0
    assert p.shear == 40.0
    assert p.friction == pytest.approx(0.4)
    assert p.gravity == pytest.approx(9.81 * 0.566)
    assert p.attraction == pytest.approx(3.0 * 0.000015884)
    assert p.boundary_damping == -1.0
    assert p.constraint == 0.5
    assert p.constraint_contraction == 10.0
    assert p.rise_period == 2.0
    assert p.phase_std == pytest.approx(0.6)
    assert p.nx == 5
    assert p.timestep == 0.01
    assert p.max_time == 6400.0
    assert p.light_x == -5.0 and p.light_y == 0.0
    assert p.config == Config.RANDOM
    assert p.rad_factor == 2.0
    assert p.centroid_steps == 24000


def test_example_cfg():
    p = load_cfg(f"{EXAMPLES}/example.cfg")
    assert p.n_cells == 300
    assert p.n_dead == 0
    assert p.light_x == -2.0 and p.light_y == 4.0
    assert p.max_time == 7200.0
    assert p.seed == 5555
    assert p.csv_filename == "example_data.csv"
    assert p.camera_y == 9.0


def test_example_gap_cfg():
    p = load_cfg(f"{EXAMPLES}/example_gap.cfg")
    assert p.n_cells == 1000
    assert p.rect_obstacles == (
        (-1.2, -1.0, -8.0, -1.0),
        (-1.2, -1.0, 1.0, 8.0),
    )
    assert p.seed == 8888


def test_example_obstacle_cfg():
    p = load_cfg(f"{EXAMPLES}/example_obstacle.cfg")
    assert p.circle_obstacles == (
        (1.0, 0.5, 0.5),
        (2.0, 2.0, 0.3),
        (2.5, -2.5, 0.45),
    )


def test_example_object_transport_cfg():
    p = load_cfg(f"{EXAMPLES}/example_object_transport.cfg")
    assert p.n_dead == -1 and p.has_payload
    assert p.rad_factor == 2.0
    assert p.attraction_factor == 0.0


def test_example_dead_cells_cfg():
    p = load_cfg(f"{EXAMPLES}/example_dead_cells.cfg")
    assert p.n_dead == 20 and p.n_cells == 100


def test_cell_size_rule():
    # default payload (radFactor 2): 0.5*2*max_r = max_r  <  2*max_r -> plain
    assert SimParams().cell_size() == pytest.approx(2 * 0.1175)
    # giant payload triggers the enlarged cell (main.cpp:932-933)
    p = SimParams(rad_factor=10.0)
    assert p.cell_size() == pytest.approx(0.1175 * 0.5 * 10.0 + 4 * 0.1175)


def test_interval_steps():
    p = SimParams()
    assert p.phase_update_steps == 1200
    assert p.centroid_steps_interval == 1000
    assert p.dump_steps == 6000


def test_parser_fixes_reference_bugs():
    # 'constraint_contraction' must not clobber 'constraint'
    p = parse_cfg_text("constraint_contraction\n7.5\n")
    assert p.constraint_contraction == 7.5
    assert p.constraint == 0.5
    # 'config' value actually applies (broken upstream, main.cpp:794-809)
    p = parse_cfg_text("nCells\n10\nconfig\nCONFIG_HEX\n")
    assert p.config == Config.HEX
    # short names are not silently dropped (upstream skips lines < 4 chars)
    p = parse_cfg_text("Nx\n9\n")
    assert p.nx == 9


def test_parser_errors():
    with pytest.raises(ValueError):
        parse_cfg_text("nCellz\n100\n")
    with pytest.raises(ValueError):
        parse_cfg_text("nCells\n")
    with pytest.raises(ValueError):
        parse_cfg_text("nobstacles\n2\nx1obs\n1.0\nx2obs\n1 2\ny1obs\n1 2\ny2obs\n1 2\n")
    with pytest.raises(ValueError):
        parse_cfg_text("grid_dim\n-4\n").validate()
    # any positive grid_dim is a valid table size (the kernel's cell tile
    # adapts to it)
    assert parse_cfg_text("grid_dim\n100\n").validate().grid_dim == 100


def test_obstacle_cap_matches_reference_constant_arrays():
    rects = tuple((0.0, 1.0, 0.0, 1.0) for _ in range(11))
    with pytest.raises(ValueError):
        SimParams(rect_obstacles=rects).validate()


def test_phase_std_not_rederived_from_rise_period():
    # setParam('rise_period') in the reference (main.cpp:779) does NOT
    # re-derive phase_std; the 0.3*rise_period coupling exists only in the
    # defaults block (main.cpp:899).  A cfg setting rise_period keeps the
    # default phase_std = 0.6.
    p = parse_cfg_text("rise_period\n4\n")
    assert p.rise_period == pytest.approx(4.0)
    assert p.phase_std == pytest.approx(0.6)
    p = parse_cfg_text("rise_period\n4\nphase_std\n0.1\n")
    assert p.phase_std == pytest.approx(0.1)


def test_backend_resolution():
    assert SimParams(n_cells=300).resolved_backend() == ForceBackend.DENSE
    # large swarms resolve to the portable XLA stencil on the CPU test
    # harness (the GPU rule is pinned below)
    assert SimParams(n_cells=10000).resolved_backend() == ForceBackend.STENCIL
    assert (
        SimParams(n_cells=10000, force_backend=ForceBackend.DENSE).resolved_backend()
        == ForceBackend.DENSE
    )


@pytest.mark.parametrize(
    "platform,n,want",
    [
        ("gpu", 300, "DENSE"),
        ("gpu", GPU_DENSE_MAX_BOTS, "DENSE"),
        ("gpu", GPU_DENSE_MAX_BOTS + 1, "PALLAS"),
        ("gpu", 10_000, "PALLAS"),
        ("cpu", 2048, "DENSE"),
        ("cpu", 2049, "STENCIL"),
    ],
)
def test_auto_backend_by_platform(monkeypatch, platform, n, want):
    """AUTO resolution per platform: on the GPU the DENSE/table-loop
    crossover measured on the card; on the CPU the portable rule."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert SimParams(n_cells=n).resolved_backend() == ForceBackend[want]
    # an explicit backend is never re-resolved
    assert (
        SimParams(n_cells=n, force_backend=ForceBackend.CELLGRID)
        .resolved_backend() == ForceBackend.CELLGRID
    )


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_auto_backend_unknown_platform_raises(monkeypatch, platform):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(ValueError, match=platform):
        SimParams(n_cells=5000).resolved_backend()
    # an explicit backend still works there
    assert (
        SimParams(n_cells=5000, force_backend=ForceBackend.DENSE)
        .resolved_backend() == ForceBackend.DENSE
    )


def test_auto_overflow_slots():
    # auto spill threshold is measured (RESULTS.md): reference-density HEX
    # max real occupancy over 60k steps is 15/16 at 100k bots but exactly
    # 16/16 (zero margin) at 131k — spill is pure tax (~7%) at <= 100k and
    # insurance past it
    assert SimParams(n_cells=100_000).resolved_overflow_slots() == 0
    assert SimParams(n_cells=100_001).resolved_overflow_slots() == 8
    assert SimParams(n_cells=250_000).storage_capacity() == 24
    # explicit key overrides auto in both directions
    assert SimParams(n_cells=250_000, overflow_slots=0).storage_capacity() == 16
    assert SimParams(n_cells=1000, overflow_slots=8).storage_capacity() == 24


def test_auto_grid_dim():
    p = SimParams(n_cells=10000)
    assert p.resolved_grid_dim() % 16 == 0
    # must cover the expected packed blob (~16.4 world units at 10k bots)
    assert p.resolved_grid_dim() * p.cutoff() > 20.0
    assert SimParams(n_cells=10000, grid_dim=64).resolved_grid_dim() == 64


def test_nobstacles_zero_clears_inherited_obstacles():
    # an explicit 'nobstacles 0' must disable obstacles from the base params
    # (reference: the obstacle loops iterate zero times when nobstacles==0)
    base = SimParams(rect_obstacles=((0.0, 1.0, 0.0, 1.0),))
    p = parse_cfg_text("nobstacles\n0\n", base=base)
    assert p.rect_obstacles == ()
    base = SimParams(circle_obstacles=((0.0, 0.0, 1.0),))
    p = parse_cfg_text("n_cir_obstacles\n0\n", base=base)
    assert p.circle_obstacles == ()
    # absent keys still inherit
    p = parse_cfg_text("seed\n3\n", base=SimParams(rect_obstacles=((0.0, 1.0, 0.0, 1.0),)))
    assert len(p.rect_obstacles) == 1


def test_validate_rejects_bad_geometry():
    with pytest.raises(ValueError):
        SimParams(grid_dim=-16).validate()
    with pytest.raises(ValueError):
        SimParams(cell_capacity=0).validate()
    with pytest.raises(ValueError):
        SimParams(slot_rebuild_steps=0).validate()
    with pytest.raises(ValueError):
        SimParams(world_half=-1.0).validate()
    # 0 is the auto-fit sentinel, legal until a step function compiles
    SimParams(world_half=0.0).validate()


def test_engine_knob_cfg_keys():
    p = parse_cfg_text(
        "slot_rebuild_steps\n1\noverflow_slots\n8\nworld_half\n32\n"
    )
    assert p.slot_rebuild_steps == 1
    assert p.overflow_slots == 8
    assert p.world_half == pytest.approx(32.0)
