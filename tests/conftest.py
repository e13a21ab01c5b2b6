"""Test harness: force an 8-virtual-device CPU mesh.

Multi-device sharding tests run on spoofed CPU devices
(xla_force_host_platform_device_count) — nothing in the physics constrains
the platform.  The platform is pinned to the CPU via jax.config before any
backend initializes, so Pallas kernels run in interpret mode here; the
tests that need the card (``gpu`` marker, tests/test_gpu.py) skip, and
chip_smoke.py runs them on the card without this conftest.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
# cli.main turns on the persistent compilation cache; tests that call it
# must not leave the other tests of their worker writing and loading
# executables through a cache shared across workers
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Tiering: `pytest -m quick` runs the op/engine/parity subset (~5 min on CPU)
# that catches most physics/parity regressions; the full suite (dominated by
# interpret-mode Pallas table-loop and sharding tests) stays the default.
# Membership is by module — fast, behavior-pinning test files — minus a
# short list of individually slow tests inside them.
# ---------------------------------------------------------------------------

QUICK_MODULES = {
    "test_actuation",
    "test_cli",
    "test_config",
    "test_engine",
    "test_experiments",
    "test_forces",
    "test_golden",       # the golden-trajectory parity net (~2.5 min)
    "test_grid",
    "test_integrate",
    "test_io",
    "test_oracle",
    "test_phase",
    "test_physics_invariants",
    "test_placement",
    "test_profiling",
    "test_render",
}

# slow outliers inside otherwise-quick modules (>=1 min each)
SLOW_IN_QUICK = {
    "test_checkpoint_resume_misaligned_table_run",  # table-loop resume, ~85 s
    "test_random_config_fuzz_stays_healthy",        # long fuzz run, ~60 s
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "quick: fast op/engine/parity subset (~5 min; run with -m quick)",
    )


def pytest_collection_modifyitems(config, items):
    for item in items:
        module = item.nodeid.split("::")[0].rsplit("/", 1)[-1].removesuffix(".py")
        base_name = item.name.split("[")[0]
        if module in QUICK_MODULES and base_name not in SLOW_IN_QUICK:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs
