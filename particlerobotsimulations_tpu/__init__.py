"""particlerobotsimulations_tpu — JAX particle-robot swarm simulator.

A from-scratch JAX/XLA re-design of richa-batra/ParticleRobotSimulations
(CUDA/OpenGL): hundreds to tens of thousands of 2-D disk robots whose radii
oscillate with a light-distance phase offset, producing swarm phototaxis,
obstacle negotiation, dead-cell robustness and payload transport.

Compute path: jitted JAX (vectorized masked pair forces, cell-table
neighbor search, a Pallas force kernel for the GPU), ``lax.scan`` step
loops, ``vmap`` over scene batches and ``shard_map`` over device meshes for
Monte-Carlo sweeps and sharded large scenes.
"""

from .config import (
    Config,
    Control,
    ForceBackend,
    SimParams,
    load_cfg,
    parse_cfg_text,
)
from .engine import make_run_chunk, make_run_chunk_batched, make_step
from .sim import Simulation
from .state import SimState, active_mask, make_state, payload_mask

__version__ = "0.1.0"

__all__ = [
    "Config",
    "Control",
    "ForceBackend",
    "SimParams",
    "SimState",
    "Simulation",
    "active_mask",
    "load_cfg",
    "make_run_chunk",
    "make_run_chunk_batched",
    "make_state",
    "make_step",
    "parse_cfg_text",
    "payload_mask",
    "__version__",
]
