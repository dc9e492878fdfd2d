"""lsc_dr_planner_tpu — batched decentralized multi-agent trajectory planner.

A from-scratch JAX/XLA/Pallas re-design of the LSC-DR planner
(decentralized, deadlock-free multi-agent trajectory planning with Linear
Safe Corridors, Safe Flight Corridors, and MAPF-based deadlock resolution;
reference behavior: qwerty35/lsc_dr_planner).

Design stance (accelerator-first, not a port):
  * agents are a batch axis — every pipeline stage is a batched tensor op
  * the per-agent convex QP is solved for all agents at once by a batched
    ADMM (OSQP-style) solver instead of per-agent CPLEX calls
  * the static world is preprocessed into dense occupancy / blocked masks /
    integral images so corridor construction is O(1) box queries
  * multi-device scaling is jax.sharding/shard_map over agent & scenario axes
"""

__version__ = "0.1.0"

import jax as _jax

# The QP solver's Cholesky/KKT algebra needs true float32 matmuls: on
# the GPU, XLA's default lets float32 products run in TF32 (~10 mantissa
# bits), which destroys ADMM convergence. The affected matrices are
# tiny, so the precision cost is negligible.
_jax.config.update("jax_default_matmul_precision", "float32")

from lsc_dr_planner_tpu.config import Param, PlannerMode, GoalMode, MAPFMode
from lsc_dr_planner_tpu.mission import Mission

__all__ = [
    "Param",
    "PlannerMode",
    "GoalMode",
    "MAPFMode",
    "Mission",
    "__version__",
]
