"""Per-stage pipeline profile across fleet sizes, on the default device.

Runs the bench workload (bench.build_fleet) at A in {128, 256, 512,
1024} and prints per-stage wall times from compiled-prefix differences
(FleetPlanner.measure_stage_times). A second sweep holds the WORLD
fixed at the A=1024 extent while shrinking the fleet, separating
"more agents" from "bigger grid" effects.

Usage: python tools/stage_profile.py [--sizes 128,1024] [--fixed-world]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile(A, steps=3, world_side_override=None):
    import jax
    import numpy as np

    import bench

    if world_side_override is not None:
        # keep agent count A but the world of a side=world_side_override
        # fleet
        p, planner, fleet, inp = _build_fixed_world(A, world_side_override)
    else:
        p, planner, fleet, inp = bench.build_fleet(A)
    step = bench.make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, out = step(inp)
    jax.block_until_ready(out)
    st = planner.measure_stage_times(fleet, inp, repeats=steps)
    st = {k: round(v * 1e3, 2) for k, v in st.items()}
    st["A"] = A
    st["grid_cells"] = int(np.prod(planner.world.occ.shape))
    return st


def _build_fixed_world(A, side):
    """bench.build_fleet but with the world extent of a side² fleet."""
    import numpy as np
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.config import GoalMode, Param
    from lsc_dr_planner_tpu.ops import trajectory
    from lsc_dr_planner_tpu.planner.pipeline import (
        FleetArrays, FleetPlanner, StepInputs,
    )
    from lsc_dr_planner_tpu.world.grid import build_grid_world

    rng = np.random.default_rng(0)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    lattice = np.stack([gx, gy], -1).reshape(-1, 2)[:A] * 1.2
    lattice -= lattice.mean(0)
    pos2 = lattice + rng.uniform(-0.2, 0.2, (A, 2))
    goal2 = -pos2 + rng.uniform(-0.2, 0.2, (A, 2))
    half = 0.6 * side + 2.0
    wmin = np.array([-half, -half, 0.0])
    wmax = np.array([half, half, 1.0])
    n_trees = int(0.25 * (2 * half) ** 2)
    keep = np.concatenate([pos2, goal2], 0)
    trees = []
    for _ in range(n_trees * 3):
        if len(trees) >= n_trees:
            break
        c = rng.uniform(-half + 0.5, half - 0.5, 2)
        if np.min(np.linalg.norm(keep - c, axis=-1)) > 0.6:
            trees.append([c[0], c[1], 0.5, 0.3, 0.3, 1.0])
    boxes = np.asarray(trees) if trees else np.zeros((0, 6))
    p = Param(goal_mode=GoalMode.GRID_BASED_PLANNER, world_use_octomap=True,
              world_dimension=2, communication_range=3.0, max_obstacles=16)
    world = build_grid_world(boxes, wmin, wmax, p.world_resolution, 0.15)
    planner = FleetPlanner(p, world, A, max_dynobs=0, agent_radius=0.15)
    f32 = jnp.float32
    pos = np.concatenate([pos2, np.full((A, 1), p.world_z_2d)], 1)
    goal = np.concatenate([goal2, np.full((A, 1), p.world_z_2d)], 1)
    fleet = FleetArrays(
        radius=jnp.full((A,), 0.15, f32), downwash=jnp.full((A,), 2.0, f32),
        max_vel=jnp.ones((A, 3), f32), max_acc=jnp.full((A, 3), 2.0, f32),
        nominal_velocity=jnp.full((A,), 1.0, f32),
    )
    posj = jnp.asarray(pos, f32)
    ctrl = trajectory.const_vel_ctrl(posj, jnp.zeros((A, 3), f32), p.M, p.n, p.dt)
    inp = StepInputs(
        pos=posj, vel=jnp.zeros((A, 3), f32), acc=jnp.zeros((A, 3), f32),
        prev_ctrl=ctrl, has_prev=jnp.zeros((A,), bool),
        is_disturbed=jnp.zeros((A,), bool),
        desired_goal=jnp.asarray(goal, f32), current_goal=posj,
        next_waypoint=posj,
        sfc_lo=jnp.zeros((A, p.M, 3), jnp.int32),
        sfc_hi=jnp.zeros((A, p.M, 3), jnp.int32),
        sfc_initialized=jnp.zeros((A,), bool),
        planner_seq=jnp.int32(1),
        dynobs_pos=jnp.zeros((0, 3), f32), dynobs_vel=jnp.zeros((0, 3), f32),
        dynobs_radius=jnp.zeros((0,), f32), dynobs_downwash=jnp.zeros((0,), f32),
        dynobs_max_acc=jnp.zeros((0,), f32), dynobs_valid=jnp.zeros((0,), bool),
    )
    return p, planner, fleet, inp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="128,256,512,1024")
    ap.add_argument("--fixed-world", action="store_true",
                    help="hold the world at the A=1024 extent for all sizes")
    args = ap.parse_args()
    from lsc_dr_planner_tpu import runtime

    runtime.setup_compile_cache()
    sizes = [int(s) for s in args.sizes.split(",")]
    for A in sizes:
        st = profile(A, world_side_override=32 if args.fixed_world else None)
        st["fixed_world"] = args.fixed_world
        print(json.dumps(st), flush=True)


if __name__ == "__main__":
    main()
