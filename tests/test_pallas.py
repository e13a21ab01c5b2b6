"""Force kernel parity vs the XLA backends (the Triton kernel in interpret
mode on the CPU; the card runs it compiled, see tests/test_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particlerobotsimulations_tpu import SimParams
from particlerobotsimulations_tpu.ops.forces import dense_collide
from particlerobotsimulations_tpu.ops.pallas_stencil import (
    assign_slots_slotmajor,
    pallas_stencil_collide,
)
from particlerobotsimulations_tpu.ops.stencil import stencil_collide

P = SimParams(n_dead=0, grid_dim=16, cell_capacity=16)


def cloud(n, n_pad, spread, seed):
    rng = np.random.default_rng(seed)
    pos = np.full((n_pad, 2), 1e6, np.float32)
    pos[:n] = rng.uniform(-spread, spread, (n, 2)).astype(np.float32)
    vel = np.zeros((n_pad, 2), np.float32)
    vel[:n] = rng.normal(0, 0.05, (n, 2)).astype(np.float32)
    rad = np.full((n_pad,), 0.0775, np.float32)
    mask = jnp.asarray(np.arange(n_pad) < n)
    return jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rad), mask


def test_slot_assignment_unique():
    pos, vel, rad, mask = cloud(60, 128, 1.0, seed=0)
    slot, overflow = assign_slots_slotmajor(P, pos, mask)
    s = np.asarray(slot)[:60]
    assert int(overflow) == 0
    assert len(np.unique(s)) == 60  # no two bots share a slot
    total = P.resolved_grid_dim() ** 2 * P.cell_capacity
    assert (s < total).all()
    # padding is dropped
    assert (np.asarray(slot)[60:] == total).all()


def test_pallas_matches_stencil_and_dense():
    n, n_pad = 96, 128
    pos, vel, rad, mask = cloud(n, n_pad, 1.2, seed=3)
    payload = jnp.zeros(n_pad, bool)
    args = (pos, vel, rad, mask, payload, 0.01)

    vp, fap, frp = jax.jit(lambda *a: pallas_stencil_collide(P, *a, 0.01))(*args[:-1])
    vs, fas, frs = jax.jit(lambda *a: stencil_collide(P, *a, 0.01))(*args[:-1])
    vd, fad, frd = jax.jit(lambda *a: dense_collide(P, *a, 0.01))(*args[:-1])

    # tolerances cover rsqrt-vs-divide float32 noise in the kernel
    np.testing.assert_allclose(np.asarray(vp), np.asarray(vs), atol=2e-6)
    np.testing.assert_allclose(np.asarray(fap), np.asarray(fas), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(frp), np.asarray(frs), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(vp), np.asarray(vd), atol=2e-6)


def test_pallas_chunking_with_slot_reuse():
    # slot assignments are carried through the scan and rebuilt every
    # slot_rebuild_steps; splitting a run into chunks must reproduce the
    # single-chunk trajectory.  Chunk re-entry re-anchors the grid origin
    # (mid-chunk rebuilds keep it fixed — translation-invariant wrap), so
    # the slot layout and hence float summation order differ: the pair SET
    # is identical, values agree to float32 reassociation tolerance.
    from particlerobotsimulations_tpu import Config, ForceBackend, Simulation

    p = SimParams(
        n_cells=48, n_dead=0, seed=5, config=Config.HEX, light_x=-5.0,
        force_backend=ForceBackend.PALLAS, grid_dim=16,
        slot_rebuild_steps=4,
    )
    a = Simulation(p)
    b = Simulation(p)
    a.step_chunk(40)
    for _ in range(5):
        b.step_chunk(8)  # multiple of slot_rebuild_steps
    # stiff contacts (k=1000) amplify the reassociation noise over 40 steps
    np.testing.assert_allclose(a.host_view()[0], b.host_view()[0], atol=1e-4)
    np.testing.assert_allclose(a.host_view()[1], b.host_view()[1], atol=2e-3)


def test_pallas_payload_factors():
    p = P.replace(n_dead=-1, attraction_factor=0.0, n_cells=2)
    n_pad = 128
    pos = np.full((n_pad, 2), 1e6, np.float32)
    pos[0] = (0.0, 0.0)
    pos[1] = (0.5, 0.0)  # inverse-square regime
    mask = jnp.asarray(np.arange(n_pad) < 2)
    payload = jnp.asarray(np.arange(n_pad) == 1)
    vel = jnp.zeros((n_pad, 2), jnp.float32)
    rad = jnp.full((n_pad,), 0.0775, jnp.float32)
    nv, fa, fr = pallas_stencil_collide(p, jnp.asarray(pos), vel, rad, mask, payload, 0.01)
    assert float(fa[0]) == 0.0 and float(fa[1]) == 0.0


def table_of(p, pos, vel, rad, mask, payload=None):
    """Slot-major kernel fields (dict of flat arrays) of a bot cloud."""
    from particlerobotsimulations_tpu.ops.forces import attraction_scale
    from particlerobotsimulations_tpu.ops.pallas_stencil import kernel_fields

    g, cap = p.resolved_grid_dim(), p.cell_capacity
    slot, overflow = assign_slots_slotmajor(p, pos, mask)
    if payload is None:
        payload = jnp.zeros(pos.shape[0], bool)
    cols = {
        "px": pos[:, 0], "py": pos[:, 1], "vx": vel[:, 0], "vy": vel[:, 1],
        "rad": jnp.where(mask, rad, 0.0),
        "afac": attraction_scale(p, payload),
    }
    names = kernel_fields(p)
    rows = jnp.stack([cols[k] for k in names], -1)
    tbl = jnp.zeros((g * g * cap, len(names)), jnp.float32).at[slot].set(
        rows, mode="drop"
    )
    return {k: tbl[:, j] for j, k in enumerate(names)}, int(overflow)


@pytest.mark.parametrize("window", ["full", "band"])
def test_ext_nonnewton_kernel_matches_newton(window):
    """The halo-extended call (the sharded table's force pass: targets are
    a window of grid rows, with one neighbour row on each side) must give
    the forces of the full-table call on the same lanes.  ``full`` wraps
    the whole table in its own edge rows; ``band`` is one shard's two-row
    window cut out of the middle of the table."""
    from particlerobotsimulations_tpu import Config, Simulation
    from particlerobotsimulations_tpu.ops.pallas_stencil import table_forces
    from particlerobotsimulations_tpu.state import active_mask

    p = SimParams(
        n_cells=300, n_dead=0, seed=2, config=Config.HEX, light_x=-5.0,
        grid_dim=16,
    ).validate()
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    gg = g * g
    st = Simulation(p).state
    n_pad = st.pos.shape[0]
    mask = active_mask(p, n_pad)
    pos = st.pos + jax.random.uniform(
        jax.random.PRNGKey(0), st.pos.shape, minval=-1e-3, maxval=1e-3
    )
    fields, _ = table_of(p, pos, st.vel, st.rad, mask)
    ref = table_forces(p, fields, g, g, gg, 0, gg)

    r0, nr = (0, g) if window == "full" else (6, 2)  # first row, rows
    planes = {k: v.reshape(cap, gg) for k, v in fields.items()}
    rows_idx = (np.arange(r0 - 1, r0 + nr + 1) % g)
    lanes = (rows_idx[:, None] * g + np.arange(g)[None, :]).reshape(-1)
    ext_len = lanes.size
    ext = {k: v[:, lanes].reshape(cap * ext_len) for k, v in planes.items()}
    out = table_forces(p, ext, g, nr + 2, ext_len, g, nr * g)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(
            np.asarray(a)[:, r0 * g : (r0 + nr) * g], np.asarray(b),
            atol=1e-4, rtol=1e-5,
        )


# Kernel parity matrix: (grid_dim, bots, cloud spread, extra params).
KERNEL_CASES = {
    "g16": (16, 96, 1.2, {}),
    "g48": (48, 600, 5.0, {}),
    "payload": (16, 96, 1.2, {"n_dead": -1, "attraction_factor": 3.0}),
    "obstacles": (16, 96, 1.2, {
        "circle_obstacles": ((0.5, 0.5, 0.3),),
        "rect_obstacles": ((-1.0, -0.6, -1.0, 1.0),),
    }),
    # a small blob in a wide grid: most kernel tiles hold no target
    "empty_tiles": (48, 40, 0.8, {}),
    # cell_capacity that is not a power of two: the kernel pads the slot
    # axis to 16 and masks the padded rows
    "cap12": (16, 96, 1.2, {"cell_capacity": 12}),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_matches_jnp_and_dense(case):
    """The Triton kernel (interpret mode) against its plain-jnp twin on the
    same table, and the whole collide pass against DENSE.  Tolerances are
    float32 reassociation of the 9-cell sums (kernel vs twin) plus the
    rsqrt-vs-divide form of the pair math (vs DENSE)."""
    from particlerobotsimulations_tpu.ops.pallas_stencil import (
        table_forces,
        table_forces_jnp,
    )

    g, n, spread, extra = KERNEL_CASES[case]
    p = P.replace(grid_dim=g, **extra)
    n_pad = 128 * ((n + 127) // 128)
    pos, vel, rad, mask = cloud(n, n_pad, spread, seed=17)
    payload = (
        jnp.asarray(np.arange(n_pad) < 3) if p.has_payload
        else jnp.zeros(n_pad, bool)
    )
    fields, overflow = table_of(p, pos, vel, rad, mask, payload)
    assert overflow == 0
    gg = g * g
    k = table_forces(p, fields, g, g, gg, 0, gg)
    j = table_forces_jnp(p, fields, g, g, gg, 0, gg)
    for a, b in zip(k, j):
        assert a.shape == (p.cell_capacity, gg)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-5)
    assert float(jnp.max(jnp.abs(k[3]))) > 0  # contacts were exercised

    vp, fap, frp = jax.jit(
        lambda *a: pallas_stencil_collide(p, *a, 0.01)
    )(pos, vel, rad, mask, payload)
    vd, fad, frd = jax.jit(
        lambda *a: dense_collide(p, *a, 0.01)
    )(pos, vel, rad, mask, payload)
    # velocities ~0.4: 1e-5 is ~25 ulp, the payload's 3x attraction
    # factor included
    np.testing.assert_allclose(np.asarray(vp), np.asarray(vd), atol=1e-5)
    np.testing.assert_allclose(np.asarray(fap), np.asarray(fad),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(frp), np.asarray(frd),
                               atol=2e-4, rtol=1e-4)


def test_kernel_full_cell():
    """Sixteen bots in one cell fill its capacity exactly: every slot row
    of the kernel's block is live, and the in-cell self-pair mask must
    still drop only the diagonal."""
    from particlerobotsimulations_tpu.ops.pallas_stencil import (
        table_forces,
        table_forces_jnp,
    )

    p = P
    n_pad = 128
    h = p.cutoff()
    rng = np.random.default_rng(4)
    pos = np.full((n_pad, 2), 1e6, np.float32)
    pos[:16] = (0.5 * h + rng.uniform(-0.2 * h, 0.2 * h, (16, 2))).astype(
        np.float32
    )
    # the rest of the cloud keeps to other cells, so nothing overflows
    pos[16:40] = rng.uniform(2.0 * h, 6.0 * h, (24, 2)).astype(np.float32)
    vel = jnp.zeros((n_pad, 2), jnp.float32)
    rad = jnp.full((n_pad,), 0.0775, jnp.float32)
    mask = jnp.asarray(np.arange(n_pad) < 40)
    pos = jnp.asarray(pos)
    fields, overflow = table_of(p, pos, vel, rad, mask)
    assert overflow == 0
    g = p.resolved_grid_dim()
    gg = g * g
    occ = (np.asarray(fields["rad"]).reshape(p.cell_capacity, gg) > 0).sum(0)
    assert occ.max() == p.cell_capacity
    k = table_forces(p, fields, g, g, gg, 0, gg)
    j = table_forces_jnp(p, fields, g, g, gg, 0, gg)
    for a, b in zip(k, j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-3, rtol=1e-5)
    vp, _, _ = pallas_stencil_collide(
        p, pos, vel, rad, mask, jnp.zeros(n_pad, bool), 0.01
    )
    vd, _, _ = dense_collide(
        p, pos, vel, rad, mask, jnp.zeros(n_pad, bool), 0.01
    )
    np.testing.assert_allclose(np.asarray(vp), np.asarray(vd), atol=1e-5)


@pytest.mark.parametrize(
    "n_t,tile", [(256, 4), (2304, 4), (96, 4), (20, 4), (6, 2), (7, 1)]
)
def test_kernel_tile_choice(monkeypatch, n_t, tile):
    """The kernel's cell tile is the largest power of two <= TILE that
    divides the target window (every window is a whole number of tiles)."""
    from particlerobotsimulations_tpu.ops import pallas_stencil as ps

    monkeypatch.setattr(ps, "TILE", 4)
    assert ps._tile_for(n_t) == tile


@pytest.mark.parametrize("with_payload", [False, True])
def test_diff_pallas_gradient_matches_stencil(with_payload):
    """make_diff_pallas_collide: kernel forward, stencil backward.  Its
    forward agrees with the stencil's to float32 reassociation and its
    gradient is the stencil's gradient."""
    from particlerobotsimulations_tpu.ops.pallas_stencil import (
        make_diff_pallas_collide,
    )

    p = P.replace(n_dead=-1) if with_payload else P
    n, n_pad = 64, 128
    pos, vel, rad, mask = cloud(n, n_pad, 1.0, seed=21)
    payload = (
        jnp.asarray(np.arange(n_pad) == 1) if with_payload
        else jnp.zeros(n_pad, bool)
    )
    maskf, payf = mask.astype(jnp.float32), payload.astype(jnp.float32)
    diff = make_diff_pallas_collide(p, 0.01)
    w = jax.random.normal(jax.random.key(3), (n_pad, 2))

    def loss_k(pos, vel):
        v, fa, fr = diff(pos, vel, rad, maskf, payf)
        return jnp.sum(v * w) + 1e-3 * jnp.sum(fr)

    def loss_s(pos, vel):
        v, fa, fr = stencil_collide(p, pos, vel, rad, mask, payload, 0.01)
        return jnp.sum(v * w) + 1e-3 * jnp.sum(fr)

    lk, gk = jax.value_and_grad(loss_k, argnums=(0, 1))(pos, vel)
    ls, gs = jax.value_and_grad(loss_s, argnums=(0, 1))(pos, vel)
    np.testing.assert_allclose(float(lk), float(ls), rtol=1e-4)
    for a, b in zip(gk, gs):
        assert np.isfinite(np.asarray(a)).all()
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_payload", [False, True])
def test_pairmath_diet_bitwise_vs_legacy(monkeypatch, with_payload):
    """The pair-math instruction diet (d2 + eps^2, payload-free afac
    fold, unguarded inv2 — ops/pallas_stencil._pair_terms) must be BITWISE
    identical to the legacy guarded forms on every reachable input.

    A 96-bot cloud at spread 1.2 exercises contact overlap (gap < 0), the
    magnet ramp (0 < gap < INT2) and the inverse-square tail
    (gap >= INT2); the payload variant keeps the afac planes live."""
    p = P.replace(n_dead=-1) if with_payload else P
    n, n_pad = 96, 128
    pos, vel, rad, mask = cloud(n, n_pad, 1.2, seed=11)
    payload = jnp.asarray(np.arange(n_pad) == 1) if with_payload else jnp.zeros(n_pad, bool)

    def run():
        # the knob is read at trace time: clear every trace cache so the
        # second run really retraces
        jax.clear_caches()
        return jax.jit(
            lambda *a: pallas_stencil_collide(p, *a, 0.01)
        )(pos, vel, rad, mask, payload)

    monkeypatch.setenv("PBOT_PAIRMATH", "legacy")
    legacy = run()
    monkeypatch.delenv("PBOT_PAIRMATH")
    # the non-legacy path also includes the magnet-select min/max collapse
    # (PBOT_MAGMIN, on by default at the reference attraction) for the
    # no-payload variant — this comparison pins the whole diet bitwise
    new = run()
    for a, b in zip(legacy, new):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_magmin_exhaustive_enumeration():
    """The magnet-select collapse ``min(max(mina, ramp), inv2)`` must pick
    the SAME float32 value as the reference three-way select
    ``where(gap < i1, mina, where(gap < i2, ramp, inv2))`` for every gap
    where the pair outputs consume mag (gap >= 0; see _pair_terms /
    _magmin_ok) at the gated attraction constant (the reference default).

    Protocol: enumerate EVERY
    float32 gap in the risky window [i1/2, 8*i2] — ~34M values spanning
    both breakpoints, where the ramp-vs-inv2 orderings are rounding-luck
    facts — and pin the unbounded tails with monotonicity edge arguments:

    * gap in [0, i1/2): ramp = mina + slope*(gap - i1) <= mina exactly
      (adding a non-positive product), so max(mina, ramp) == mina; and
      inv2 = attr/gap^2 is float-monotone nonincreasing in gap, so
      inv2 >= inv2(window left edge) >= mina (asserted) — min picks mina,
      matching the select (gap == 0 gives inv2 = +inf, which min
      discards; attr > 0 statically so 0/0 NaN is impossible).
    * gap > 8*i2: ramp is float-monotone nondecreasing (mina + a
      nonneg-slope product of float-monotone factors) and inv2
      float-monotone nonincreasing, so inv2 <= inv2(edge) <= ramp(edge)
      <= ramp (edge ordering asserted with margin) — min picks inv2,
      matching the select.
    """
    i1, i2 = np.float32(0.0009), np.float32(0.0019)
    mina = np.float32(2.5)
    attr = np.float32(3.0 * 0.000015884)  # the gated value (_magmin_ok)

    lo, hi = np.float32(i1 / 2), np.float32(8 * i2)
    gaps = np.arange(
        np.float32(lo).view(np.int32), np.float32(hi).view(np.int32) + 1,
        dtype=np.int32,
    ).view(np.float32)

    def ramp_inv2(gap):
        # EXACTLY the kernel's op order (_pair_terms)
        slope = (attr * np.float32(1.0 / (0.0019 * 0.0019)) - mina) * (
            np.float32(1.0 / (0.0019 - 0.0009))
        )
        ramp = mina + slope * (gap - i1)
        with np.errstate(divide="ignore"):
            inv2 = attr / (gap * gap)
        return ramp, inv2

    ramp, inv2 = ramp_inv2(gaps)
    select = np.where(gaps < i1, mina, np.where(gaps < i2, ramp, inv2))
    minmax = np.minimum(np.maximum(mina, ramp), inv2)
    np.testing.assert_array_equal(select, minmax)

    # tail pins: left edge (gap in [0, i1/2) region) and right edge
    r_lo, v_lo = ramp_inv2(lo)
    assert v_lo >= mina and r_lo <= mina
    r_hi, v_hi = ramp_inv2(hi)
    assert v_hi <= r_hi and v_hi < np.float32(0.25) * r_hi  # wide margin
    # and the slope factors really are nonnegative (monotonicity premise)
    assert attr * np.float32(1.0 / (0.0019 * 0.0019)) - mina > 0


@pytest.mark.parametrize(
    "extra",
    [{}, {"n_dead": -1, "attraction_factor": 3.0}, {"cell_capacity": 12}],
    ids=["plain", "payload", "cap12"],
)
def test_kernel_lowers_for_cuda(monkeypatch, extra):
    """The kernel lowers through the Triton route for the card (lowering is
    host-side Python, so this runs without one): catches operations that
    the Triton lowering refuses before any run on the card."""
    from particlerobotsimulations_tpu.ops import pallas_stencil as ps

    monkeypatch.setattr(ps, "interpret_mode", lambda: False)
    p = P.replace(**extra)
    pos, vel, rad, mask = cloud(96, 128, 1.2, seed=5)
    fields, _ = table_of(p, pos, vel, rad, mask)
    g = p.resolved_grid_dim()
    gg = g * g
    lowered = (
        jax.jit(lambda f: ps.table_forces(p, f, g, g, gg, 0, gg))
        .trace(fields)
        .lower(lowering_platforms=("cuda",))
    )
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text or "triton" in text.lower()
