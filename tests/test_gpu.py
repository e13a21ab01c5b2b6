"""Tests that need the card: the force kernel compiled for the GPU and the
table loop running on it.

Every test here carries the ``gpu`` marker and asks for the ``gpu``
fixture, which skips unless JAX's default device is a GPU.  The regular
suite pins the CPU (tests/conftest.py), so they skip there.  On the card,
``chip_smoke.py`` (phase h) runs them in its own process without that
conftest; by hand:

    python -m pytest tests/test_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particlerobotsimulations_tpu import Config, ForceBackend, SimParams, Simulation
from particlerobotsimulations_tpu.engine_table import enter_table
from particlerobotsimulations_tpu.ops import pallas_stencil as ps

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


def hex_fields(n, **kw):
    p = SimParams(**{
        **dict(n_cells=n, n_dead=0, seed=7, config=Config.HEX, light_x=-20.0,
               world_half=0.0, force_backend=ForceBackend.PALLAS),
        **kw,
    })
    sim = Simulation(p)
    p = sim.params.validate()
    st = sim.state
    key = jax.random.key(1)
    st = st._replace(
        pos=st.pos + jax.random.uniform(key, st.pos.shape, minval=-2e-3,
                                        maxval=2e-3),
        vel=0.05 * jax.random.normal(jax.random.fold_in(key, 1), st.vel.shape),
    )
    return p, enter_table(p, st).fields


@pytest.mark.parametrize(
    "n,extra",
    [(2000, {}), (2000, {"n_dead": -1}), (2000, {"cell_capacity": 12})],
    ids=["plain", "payload", "cap12"],
)
def test_kernel_compiled_matches_jnp(gpu, n, extra):
    """The compiled Triton kernel against its plain-jnp twin on a real
    table (float32 reassociation of the 9-cell sums)."""
    assert not ps.interpret_mode()
    p, fields = hex_fields(n, **extra)
    g = p.resolved_grid_dim()
    gg = g * g
    k = jax.jit(lambda f: ps.table_forces(p, f, g, g, gg, 0, gg))(fields)
    j = jax.jit(lambda f: ps.table_forces_jnp(p, f, g, g, gg, 0, gg))(fields)
    for a, b in zip(k, j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-5)
    assert float(jnp.max(k[3])) > 0


def test_kernel_compiled_halo_window(gpu):
    """The sharded table's halo-extended call, compiled: a two-row band of
    targets with one neighbour row on each side gives the full-table
    call's forces on those lanes."""
    p, fields = hex_fields(2000)
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    gg = g * g
    full = jax.jit(lambda f: ps.table_forces(p, f, g, g, gg, 0, gg))(fields)
    r0, nr = g // 2 - 1, 2
    lanes = (
        (np.arange(r0 - 1, r0 + nr + 1) % g)[:, None] * g + np.arange(g)
    ).reshape(-1)
    ext = {
        k: v[: cap * gg].reshape(cap, gg)[:, lanes].reshape(-1)
        for k, v in fields.items() if k in ps.kernel_fields(p)
    }
    band = jax.jit(
        lambda f: ps.table_forces(p, f, g, nr + 2, lanes.size, g, nr * g)
    )(ext)
    for a, b in zip(full, band):
        np.testing.assert_allclose(
            np.asarray(a)[:, r0 * g:(r0 + nr) * g], np.asarray(b),
            atol=1e-4, rtol=1e-5,
        )


def test_table_loop_on_gpu(gpu):
    """The PALLAS table loop runs on the card through make_run_chunk and
    stays finite with no dropped contacts."""
    p = SimParams(
        n_cells=1000, n_dead=0, seed=3, config=Config.HEX, light_x=-5.0,
        force_backend=ForceBackend.PALLAS,
    )
    sim = Simulation(p)
    sim.step_chunk(400, start_step=0)
    h = sim.health()
    assert h["finite"] and h["cell_overflow"] == 0
    assert int(sim.state.step) == 400
