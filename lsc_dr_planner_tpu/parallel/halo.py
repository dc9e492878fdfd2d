"""SURVEY §5.8 neighborhood halo exchange — spatially-tiled neighbor
communication over the device mesh.

The reference's inter-agent interface is a range-limited broadcast: each
step every agent receives `{position, velocity, goal, radius, downwash,
prev_traj}` from neighbors within L∞ `communication_range`
(multi_sync_simulator.cpp:305-352, agent_manager.cpp:184-199). The
plain sharded step (parallel/mesh.py) realizes this with XLA-inserted
all-gathers: every device receives the FULL fleet's candidate state —
O(A) bytes per device per step, which caps scale-out.

Halo design:

  * Agents are assigned to devices by SPATIAL TILE: the host sorts the
    fleet along one axis (`spatial_permutation`) so device i holds a
    contiguous slab of the world. Any in-range neighbor of an agent in
    slab i then lives in slab i−h..i+h for a hop count h with
    slab_width·h ≥ communication_range.
  * Inside `shard_map`, each device `ppermute`s its local block to the
    2·h ring neighbors and receives theirs — O(A/d · h) bytes over the
    device links
    instead of O(A) — then runs the same top-k nearest-in-range
    selection the global gather uses, over its (2h+1)·A/d candidates.
  * The rest of the pipeline (LSC/SFC/goal LP/ADMM QP) is per-agent
    local and runs unchanged on the local block
    (`FleetPlanner._step_impl(..., neighbors=...)`).

Equivalence: when every in-range neighbor lies within h hops (the host
checks slab widths; `required_hops`), the candidate set contains every
in-range agent, so the top-k selection — and therefore the entire step
— matches the global-gather path exactly (tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsc_dr_planner_tpu.planner.pipeline import (
    FleetArrays,
    FleetPlanner,
    NeighborData,
    StepInputs,
)


def spatial_permutation(pos: np.ndarray, sort_axis: int = 0) -> np.ndarray:
    """Host-side agent permutation: sort by one coordinate so equal-count
    contiguous index blocks are spatial slabs. Returns `perm` such that
    `x_sorted = x[perm]` for every agent-axis leaf."""
    return np.argsort(np.asarray(pos)[:, sort_axis], kind="stable")


def required_hops(pos: np.ndarray, n_shards: int, comm_range: float,
                  sort_axis: int = 0) -> int:
    """Minimum ring hop count h such that every in-range neighbor of an
    agent in slab i lies in slabs i−h..i+h, for THIS fleet layout
    (agents assumed already sorted along sort_axis)."""
    x = np.sort(np.asarray(pos)[:, sort_axis])
    A = len(x)
    # shard_map (and shard_step_inputs) require an evenly divisible agent
    # axis; with a ragged split the Al-strided slab starts below would
    # drift from the actual layout and under-estimate the hop bound,
    # silently dropping in-range neighbors
    if A % n_shards != 0:
        raise ValueError(
            f"agent count {A} must divide evenly into {n_shards} shards "
            "(pad the fleet or change the mesh)"
        )
    Al = A // n_shards
    # slab boundaries (first coordinate of each slab)
    starts = x[np.arange(n_shards) * Al]
    h = 1
    for i in range(n_shards):
        lo = starts[i] - comm_range
        hi = (x[-1] if i == n_shards - 1 else starts[i + 1]) + comm_range
        first = int(np.searchsorted(starts, lo, side="right")) - 1
        last = int(np.searchsorted(starts, hi, side="right")) - 1
        h = max(h, i - max(first, 0), min(last, n_shards - 1) - i)
    return h


def make_halo_step(planner: FleetPlanner, mesh: Mesh, hops: int = 1,
                   axis: str = "agents"):
    """jit+shard_map step: neighbor candidates from ±`hops` ring
    exchanges of the local agent block instead of a fleet all-gather.

    Inputs must be sharded with `mesh.shard_step_inputs` AND the agent
    axis must be spatially sorted (`spatial_permutation`) with
    `hops >= required_hops(...)` for exact reference semantics.
    """
    d = mesh.devices.size
    p = planner.param
    OA = planner.O_agents

    def shard_fn(fleet_l: FleetArrays, inp_l: StepInputs):
        Al = inp_l.pos.shape[0]
        my = jax.lax.axis_index(axis)
        ids_l = my * Al + jnp.arange(Al)  # global agent ids of this slab

        cand = NeighborData(
            prev_ctrl=inp_l.prev_ctrl,
            has_prev=inp_l.has_prev,
            pos=inp_l.pos,
            vel=inp_l.vel,
            radius=fleet_l.radius,
            downwash=fleet_l.downwash,
            goal=inp_l.current_goal,
            valid=jnp.ones((Al,), bool),
        )

        def ring(x, shift):
            perm = [(i, (i + shift) % d) for i in range(d)]
            return jax.lax.ppermute(x, axis, perm)

        blocks = [cand]
        block_ids = [ids_l]
        block_ok = [jnp.ones((Al,), bool)]
        for h in range(1, hops + 1):
            for sgn in (+1, -1):
                blocks.append(jax.tree_util.tree_map(
                    partial(ring, shift=sgn * h), cand
                ))
                block_ids.append(ring(ids_l, sgn * h))
                # the slabs form a LINE, not a torus: mask blocks whose
                # ring transfer wrapped around (source slab out of range)
                src = my - sgn * h
                block_ok.append(jnp.broadcast_to(
                    (src >= 0) & (src < d), (Al,)
                ))

        def cat(*leaves):
            return jnp.concatenate(leaves, axis=0)

        cand_all = jax.tree_util.tree_map(cat, *blocks)  # [(2h+1)·Al, ...]
        cand_ids = jnp.concatenate(block_ids)
        cand_ok = jnp.concatenate(block_ok)

        # top-k needs at least OA candidates: pad with dead slots
        C = (2 * hops + 1) * Al
        if C < OA:
            padn = OA - C
            cand_all = jax.tree_util.tree_map(
                lambda x: jnp.concatenate(
                    [x, jnp.zeros((padn,) + x.shape[1:], x.dtype)], axis=0
                ),
                cand_all,
            )
            cand_ids = jnp.concatenate(
                [cand_ids, jnp.full((padn,), -1, cand_ids.dtype)]
            )
            cand_ok = jnp.concatenate([cand_ok, jnp.zeros((padn,), bool)])

        # same selection semantics as FleetPlanner._neighbor_slots:
        # OA nearest other agents within L∞ communication range
        dist = jnp.max(
            jnp.abs(inp_l.pos[:, None] - cand_all.pos[None, :]), axis=-1
        )  # [Al, C]
        self_or_dead = (ids_l[:, None] == cand_ids[None, :]) | ~cand_ok[None, :]
        dist = jnp.where(self_or_dead, 1e9, dist)
        if p.communication_range > 0:
            dist = jnp.where(dist < p.communication_range, dist, 1e9)
        neg_top, order = jax.lax.top_k(-dist, OA)
        valid = -neg_top < 1e8

        nd = NeighborData(
            prev_ctrl=cand_all.prev_ctrl[order],
            has_prev=cand_all.has_prev[order],
            pos=cand_all.pos[order],
            vel=cand_all.vel[order],
            radius=cand_all.radius[order],
            downwash=cand_all.downwash[order],
            goal=cand_all.goal[order],
            valid=valid,
        )
        return planner._step_impl(fleet_l, inp_l, neighbors=nd)

    from lsc_dr_planner_tpu.parallel.mesh import _spec_for

    fleet_specs = FleetArrays(*[
        P(axis) for _ in FleetArrays._fields
    ])

    def inp_spec(name, leaf):
        if leaf is None:
            return None
        return _spec_for(name, np.ndim(leaf), axis)

    def make_in_specs(inp: StepInputs):
        return StepInputs(*[
            inp_spec(n, v) if n != "planner_seq" else P()
            for n, v in zip(StepInputs._fields, inp)
        ])

    cache = {}

    def step(fleet_s, inp_s):
        # in_specs depend on which optional StepInputs leaves are present
        # (e.g. occ_known / qp_y0 flipping between None and an array), so
        # the jitted shard_map is keyed on that presence tuple — one
        # frozen entry would miss-shard later calls
        key = tuple(v is None for v in inp_s)
        if key not in cache:
            in_specs = (fleet_specs, make_in_specs(inp_s))
            cache[key] = jax.jit(
                jax.shard_map(
                    shard_fn, mesh=mesh, in_specs=in_specs,
                    out_specs=P(axis), check_vma=False,
                )
            )
        return cache[key](fleet_s, inp_s)

    return step
