"""Benchmark: full planning-pipeline throughput on one chip.

Prints ONE JSON line (last line): {"metric", "value", "unit",
"vs_baseline"} — aggregate agent-steps/s through the FULL fused
pipeline (obstacle prediction → initial traj → LSC → SFC → goal LP →
QP) on EVOLVING state: every timed step advances the fleet along the
previous solution, so constraints shift and the warm-started ADMM does
real work (no converged-resolve inflation).

Baseline: the reference plans one agent-step in 8.26 ms average on
forest10 (CPLEX, sequential → ≈121 agent-steps/s on the authors' CPU;
BASELINE.md). One agent-step here = one agent through all six stages,
so the ratio is apples-to-apples.

Secondary diagnostics (printed as earlier lines): p50/p99 full-step
latency at A ∈ {128, 1024} vs the 0.2 s replanning budget, QP
convergence rate, and a QP-only rate with per-solve SHIFTED warm starts.

Workload: a forest-like random box world (reference world/forest
density scaled to fleet extent) with a jittered agent lattice flying to
antipodal goals; waypoints advance with the simulator's real gating
semantics (goal-LP convergence + comm-range reachability), standing in
for the host MAPF layer on this open-field instance.
"""

import json
import time

import numpy as np


def build_fleet(A: int, seed: int = 0, dim: int = 2):
    """Agent lattice + forest world + planner, all on the default device.
    `dim` 3 plans in 3-D (agents start at the 2-D flight height)."""
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.config import GoalMode, Param
    from lsc_dr_planner_tpu.mission import lattice_forest
    from lsc_dr_planner_tpu.ops import qp, trajectory
    from lsc_dr_planner_tpu.planner.pipeline import (
        FleetArrays, FleetPlanner, StepInputs,
    )
    from lsc_dr_planner_tpu.world.grid import build_grid_world

    pos2, goal2, boxes, half = lattice_forest(A, seed)
    wmin = np.array([-half, -half, 0.0])
    wmax = np.array([half, half, 1.0])

    p = Param(
        goal_mode=GoalMode.GRID_BASED_PLANNER,
        world_use_octomap=True,
        world_dimension=dim,
        communication_range=3.0,
        max_obstacles=16,
    )
    world = build_grid_world(boxes, wmin, wmax, p.world_resolution, 0.15)
    planner = FleetPlanner(p, world, A, max_dynobs=0, agent_radius=0.15,
                           max_vel_hint=1.0)

    f32 = jnp.float32
    pos = np.concatenate([pos2, np.full((A, 1), p.world_z_2d)], 1)
    goal = np.concatenate([goal2, np.full((A, 1), p.world_z_2d)], 1)
    fleet = FleetArrays(
        radius=jnp.full((A,), 0.15, f32),
        downwash=jnp.full((A,), 2.0, f32),
        max_vel=jnp.ones((A, 3), f32),
        max_acc=jnp.full((A, 3), 2.0, f32),
        nominal_velocity=jnp.full((A,), 1.0, f32),
    )
    posj = jnp.asarray(pos, f32)
    ctrl = trajectory.const_vel_ctrl(
        posj, jnp.zeros((A, 3), f32), p.M, p.n, p.dt
    )
    inp = StepInputs(
        pos=posj,
        vel=jnp.zeros((A, 3), f32),
        acc=jnp.zeros((A, 3), f32),
        prev_ctrl=ctrl,
        has_prev=jnp.zeros((A,), bool),
        is_disturbed=jnp.zeros((A,), bool),
        desired_goal=jnp.asarray(goal, f32),
        current_goal=posj,
        next_waypoint=posj,
        sfc_lo=jnp.zeros((A, p.M, 3), jnp.int32),
        sfc_hi=jnp.zeros((A, p.M, 3), jnp.int32),
        sfc_initialized=jnp.zeros((A,), bool),
        planner_seq=jnp.int32(1),
        dynobs_pos=jnp.zeros((0, 3), f32),
        dynobs_vel=jnp.zeros((0, 3), f32),
        dynobs_radius=jnp.zeros((0,), f32),
        dynobs_downwash=jnp.zeros((0,), f32),
        dynobs_max_acc=jnp.zeros((0,), f32),
        dynobs_valid=jnp.zeros((0,), bool),
        qp_y0=jnp.zeros((A, qp.n_rows(planner.qp_cfg)), f32),
    )
    return p, planner, fleet, inp


def make_evolve_step(p, planner, fleet):
    """One fused device step: full pipeline + ideal dynamics + waypoint
    walk with the simulator's gating semantics (goal-LP convergence +
    comm-range reachability — sim/simulator.py::decentralized_mapp)."""
    import jax
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.ops import trajectory

    def step_fn(inp):
        out = planner._step_impl(fleet, inp)
        pos, vel, acc = trajectory.state_at(
            out.desired_ctrl, p.multisim_time_step, p.dt
        )
        if p.world_dimension == 2:
            pos = pos.at[:, 2].set(p.world_z_2d)

        # waypoint walk: one grid step toward the goal, gated exactly
        # like the simulator (advance only when the goal LP has converged
        # onto the current waypoint AND the new waypoint stays within
        # half the comm range of every previous-trajectory segment start)
        wp = inp.next_waypoint
        cand = wp + jnp.clip(
            inp.desired_goal - wp, -p.grid_resolution, p.grid_resolution
        )
        seg_pts = jnp.concatenate(
            [out.desired_ctrl[:, :, 0], out.desired_ctrl[:, -1:, -1]], axis=1
        )  # [A, M+1, 3]
        reach = jnp.max(
            jnp.abs(cand[:, None] - seg_pts), axis=(-2, -1)
        ) < 0.5 * p.communication_range - 1e-5
        conv = (
            jnp.linalg.norm(out.current_goal - wp, axis=-1) < 1e-5
        )
        wp = jnp.where((reach & conv)[:, None], cand, wp)

        new_inp = inp._replace(
            pos=pos, vel=vel, acc=acc,
            prev_ctrl=out.desired_ctrl,
            has_prev=jnp.ones_like(inp.has_prev),
            current_goal=out.current_goal,
            next_waypoint=wp,
            sfc_lo=out.sfc_lo, sfc_hi=out.sfc_hi,
            sfc_initialized=out.sfc_initialized,
            planner_seq=inp.planner_seq + 1,
            qp_y0=out.qp_y,  # dual warm start across steps
        )
        return new_inp, out

    return jax.jit(step_fn)


def bench_pipeline(A: int, steps: int = 50, warmup: int = 3):
    """Full-pipeline agent-steps/s + latency percentiles at fleet size A."""
    p, planner, fleet, inp = build_fleet(A)
    step = make_evolve_step(p, planner, fleet)

    for _ in range(warmup):  # compile + prime prev_ctrl/SFC state
        inp, out = step(inp)
    out.qp_converged.block_until_ready()

    lat = []
    conv_sum = 0.0
    for _ in range(steps):
        t0 = time.perf_counter()
        inp, out = step(inp)
        out.qp_converged.block_until_ready()
        lat.append(time.perf_counter() - t0)
        conv_sum += float(np.asarray(out.qp_converged).mean())
    lat = np.asarray(lat)
    return {
        "A": A,
        "steps": steps,
        "agent_steps_per_s": A * steps / lat.sum(),
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "qp_convergence": conv_sum / steps,
        "dist_to_goal_max": float(
            np.max(np.linalg.norm(
                np.asarray(inp.pos) - np.asarray(inp.desired_goal), axis=-1
            ))
        ),
    }


def bench_qp_shifted(A: int = 1024, steps: int = 20):
    """QP-only rate with per-solve SHIFTED warm starts: each timed solve
    starts from the previous solution shifted one segment with a moved
    goal — the planner's actual steady-state warm start, never a
    converged-input resolve."""
    import jax
    import jax.numpy as jnp

    p, planner, fleet, inp = build_fleet(A)
    step = make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)  # realistic mid-flight state

    @jax.jit
    def solve_shifted(inp_, k):
        # move every goal a little each call → constraints shift
        delta = 0.05 * jnp.stack(
            [jnp.cos(0.7 * k + jnp.arange(A)), jnp.sin(1.3 * k + jnp.arange(A)),
             jnp.zeros(A)], axis=-1
        )
        inp2 = inp_._replace(current_goal=inp_.current_goal + delta)
        out = planner._step_impl(fleet, inp2)
        return out.qp_converged

    conv = solve_shifted(inp, jnp.float32(0.0))
    conv.block_until_ready()
    t0 = time.perf_counter()
    for k in range(steps):
        conv = solve_shifted(inp, jnp.float32(k + 1.0))
    conv.block_until_ready()
    dt = time.perf_counter() - t0
    return {"A": A, "qp_shifted_solves_per_s": A * steps / dt,
            "convergence": float(np.asarray(conv).mean())}


def main():
    from lsc_dr_planner_tpu import runtime

    runtime.setup_compile_cache()
    runtime.require_gpu()
    where = {**runtime.device_info(), "card": runtime.card_info()}

    results = {}
    for A in (128, 1024):
        r = bench_pipeline(A)
        results[A] = r
        print(json.dumps({"diagnostic": "pipeline", **where, **r}))

    qp_r = bench_qp_shifted(1024)
    print(json.dumps({"diagnostic": "qp_shifted", **where, **qp_r}))

    r = results[1024]
    baseline = 121.0  # reference: ~121 sequential agent-steps/s (BASELINE.md)
    rate = r["agent_steps_per_s"]
    assert r["qp_convergence"] > 0.9, (
        f"bench workload convergence too low: {r['qp_convergence']}"
    )
    print(json.dumps({
        "metric": "pipeline_agent_steps_per_s_per_chip",
        "value": rate,
        "unit": "agent-steps/s (full 6-stage pipeline)",
        "vs_baseline": rate / baseline,
        **where,
    }))


if __name__ == "__main__":
    main()
