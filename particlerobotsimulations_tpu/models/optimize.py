"""Differentiable simulation: gradient-based actuation optimization.

A capability the CUDA reference fundamentally lacks: because every physics
op here is a pure jittable function, the whole ``lax.scan`` step loop is
differentiable end-to-end.  This module optimizes the per-bot actuation
*phase offsets* directly — replacing the hand-designed light-distance phase
law (particlebot_kernel_impl.cuh:286) with phases learned by backprop
through the contact dynamics.

The stick-slip friction and piecewise magnet law are almost-everywhere
differentiable (piecewise-smooth ``where`` branches); gradients are exact
within each regime.  Memory for long horizons is handled with
``jax.checkpoint`` on the step function (rematerialization instead of
storing every intermediate).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimParams
from ..engine import make_step
from ..state import SimState, active_mask


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _guard_leaf(x, clip):
    return x


def _guard_fwd(x, clip):
    return x, None


def _guard_bwd(clip, _, ct):
    ct = jnp.nan_to_num(ct)
    if clip is not None:
        ct = jnp.clip(ct, -clip, clip)
    return (ct,)


_guard_leaf.defvjp(_guard_fwd, _guard_bwd)


def _grad_guard(state: SimState, clip: float | None) -> SimState:
    """Identity forward; backward sanitizes cotangents.

    Two pathologies of backprop through the contact dynamics:

    * NaN: the stick-slip law normalizes by |v| and its kinetic branch
      zeroes velocities EXACTLY, so stuck bots (|v| == 0, common by
      design) make the unselected ``v / |v|`` branch NaN — forward
      ``where`` masks it, but the chain rule's 0 * NaN poisons the
      backward pass (measured: an unguarded 1500-step rollout gradient
      is all-NaN).  Zeroing is the correct subgradient at the stick kink.
    * Explosion: the DEM spring (k=1000 at dt=0.01) makes per-step
      Jacobians expansive along contact modes, so long-horizon cotangents
      overflow float32 (measured: 3.4e38 by 1500 steps).  ``clip`` bounds
      them per step — standard BPTT clipping; biased but usable.

    Applied once per step so a pathology born in step k cannot
    contaminate steps k-1..0."""
    return jax.tree.map(
        lambda x: _guard_leaf(x, clip)
        if jnp.issubdtype(x.dtype, jnp.inexact)
        else x,
        state,
    )


def make_phase_rollout(
    params: SimParams, n_steps: int, ct_clip: float | None = 1.0e4
) -> Callable[[jax.Array, SimState], jax.Array]:
    """Returns ``rollout(phase0, state0) -> final centroid x`` (jittable,
    differentiable in ``phase0``).

    The phase controller is frozen (no light-law updates, no noise) so the
    optimized offsets are the only actuation schedule.  ``ct_clip`` bounds
    per-step cotangents in the backward pass (see _grad_guard); None
    disables clipping (NaN sanitization always applies).
    """
    from ..config import Control

    # Every backend is differentiable: DENSE/CELLGRID/STENCIL natively, the
    # PALLAS kernel via its custom VJP (kernel forward, XLA-stencil
    # backward — ops/pallas_stencil.make_diff_pallas_collide), so gradient
    # studies scale to 10k+ bots on the production backend.
    frozen = params.replace(
        control=Control.FIXED_PHASE,
        phase_std=0.0,
    )
    step = jax.checkpoint(make_step(frozen, differentiable=True))
    n = params.n_cells

    def rollout(phase0: jax.Array, state0: SimState) -> jax.Array:
        state = state0._replace(phase=phase0)

        def body(s, _):
            return _grad_guard(step(s), ct_clip), None

        final, _ = jax.lax.scan(body, state, None, length=n_steps)
        mask = active_mask(params, final.pos.shape[0])
        centroid_x = jnp.sum(
            jnp.where(mask, final.pos[:, 0], 0.0)
        ) / jnp.float32(n)
        return centroid_x

    return rollout


def optimize_phases(
    params: SimParams,
    state0: SimState,
    n_steps: int = 400,
    iters: int = 20,
    lr: float = 0.5,
    minimize: bool = True,
    phase0: jax.Array | None = None,
    ct_clip: float | None = 1.0e4,
):
    """Gradient-descend per-bot phase offsets to drive the swarm centroid
    (minimize=True pushes it toward -x, i.e. the usual light direction).

    Returns (optimized phases, per-iteration objective history).
    Uses optax Adam when available, plain SGD otherwise.
    """
    rollout = make_phase_rollout(params, n_steps, ct_clip=ct_clip)
    sign = 1.0 if minimize else -1.0

    def loss(ph):
        return sign * rollout(ph, state0)

    value_and_grad = jax.jit(jax.value_and_grad(loss))

    n_pad = state0.pos.shape[0]
    if phase0 is None:
        # start from a small random spread so the wave has something to shape
        phase0 = 0.1 * jax.random.normal(jax.random.key(0), (n_pad,))
    ph = jnp.asarray(phase0, jnp.float32)

    try:
        import optax

        opt = optax.adam(lr)
        opt_state = opt.init(ph)

        def apply(ph, opt_state, g):
            updates, opt_state = opt.update(g, opt_state)
            return optax.apply_updates(ph, updates), opt_state

    except ImportError:  # pragma: no cover
        opt_state = None

        def apply(ph, opt_state, g):
            return ph - lr * g, opt_state

    history = []
    best_v, best_ph = float("inf"), ph
    for _ in range(iters):
        v, g = value_and_grad(ph)
        v = float(v)
        history.append(v)
        if v < best_v:
            best_v, best_ph = v, ph
        ph, opt_state = apply(ph, opt_state, g)
    # reuse the compiled value_and_grad for the final point: a separate
    # jit(loss) would trace+compile a second full rollout just to drop
    # the gradient
    final_v = float(value_and_grad(ph)[0])
    history.append(final_v)
    if final_v < best_v:
        best_v, best_ph = final_v, ph
    # the objective is non-convex and the late iterates can overshoot:
    # return the best evaluated point, not the last
    return np.asarray(best_ph), np.asarray(history)
