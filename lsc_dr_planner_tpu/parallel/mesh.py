"""Multi-chip scale-out: agents and scenarios over a device mesh.

The reference plans its agents sequentially in one process
(multi_sync_simulator.cpp:354-374) and has no distributed backend; its
inter-agent information interface is exactly the per-neighbor state +
previous trajectory broadcast (agent_manager.cpp:184-199, SURVEY §2.6).

Design: the fleet's planning step is one SPMD program. Agent-axis
leaves are sharded over the mesh's 'agents' axis; the neighbor exchange
(the prev-traj tensor gather `x[order]`) becomes XLA collectives over
the device links. Scenario batches (Monte-Carlo missions) shard
over a second 'scenarios' axis. World tables are replicated (read-only
broadcast).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsc_dr_planner_tpu.planner.pipeline import (
    FleetArrays,
    FleetPlanner,
    StepInputs,
    StepOutputs,
)


def make_mesh(n_devices: Optional[int] = None, axis: str = "agents") -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devs), (axis,))


def _spec_for(leaf_name: str, ndim: int, axis: str):
    """Agent-leading leaves shard on dim 0; scalars/world data replicate."""
    if leaf_name.startswith("dynobs") or ndim == 0:
        return P()
    return P(axis, *([None] * (ndim - 1)))


def shard_step_inputs(mesh: Mesh, fleet: FleetArrays, inp: StepInputs,
                      axis: str = "agents"):
    """Place fleet/step arrays with the agent axis sharded over the mesh."""

    def place(named, value):
        if value is None:  # optional leaves (occ_known in global-map mode)
            return None
        spec = _spec_for(named, value.ndim, axis)
        return jax.device_put(value, NamedSharding(mesh, spec))

    fleet_sharded = FleetArrays(
        *[place(n, v) for n, v in zip(FleetArrays._fields, fleet)]
    )
    inp_sharded = StepInputs(
        *[
            place(n, v) if n != "planner_seq" else v
            for n, v in zip(StepInputs._fields, inp)
        ]
    )
    return fleet_sharded, inp_sharded


def make_sharded_step(planner: FleetPlanner, mesh: Mesh, axis: str = "agents"):
    """jit the planner step with agent-axis output shardings; XLA inserts
    the collectives for the neighbor gathers."""
    out_specs = StepOutputs(
        desired_ctrl=P(axis),
        current_goal=P(axis),
        sfc_lo=P(axis),
        sfc_hi=P(axis),
        sfc_initialized=P(axis),
        qp_converged=P(axis),
        qp_residual=P(axis),
        qp_iterations=P(axis),
        obs_pred_ctrl=P(axis),
        initial_ctrl=P(axis),
        qp_y=P(axis),
    )
    out_shardings = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), out_specs,
        is_leaf=lambda x: isinstance(x, P),
    )
    return jax.jit(planner._step_impl, out_shardings=out_shardings)
