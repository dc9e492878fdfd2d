"""Reference-envelope DLSC validation.

The reference's own DLSC experiments (paper arXiv:2209.09447; sub-step
prediction `Segment::subSegment`, /root/reference/src/trajectory.cpp:
14-49, driven at traj_planner.cpp:298-305) run in OPEN worlds — no
octomap, no SFC, no DR waypoint layer — with agents swapping positions
under sub-step replanning ts < dt. This harness reproduces that
envelope: circle swaps and random antipodal fleets, DLSC ts = 0.1 s
with dt = 0.2 s, static goals, communication range disabled (the
comm-range waypoint box is a DR-layer construct; without the DR layer
`next_waypoint` is never maintained — in the reference too, see
tests/test_modes.py).

Success per mission = all agents reach goals, collision-free, zero
dynamic-limit excess. One JSON row per mission.

Usage:
    python tools/dlsc_openworld.py [--platform cpu|gpu] [--out log/...]
"""

import argparse
import json
import os
import sys
import time

_PLATFORM = "cpu"
if "--platform" in sys.argv:
    _PLATFORM = sys.argv[sys.argv.index("--platform") + 1]
if _PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if _PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")

from lsc_dr_planner_tpu import runtime  # noqa: E402

runtime.setup_compile_cache()
if _PLATFORM == "gpu":
    runtime.require_gpu()

import numpy as np  # noqa: E402


def circle_mission(A, radius, seed=0):
    from lsc_dr_planner_tpu.mission import generate_random_mission

    m = generate_random_mission(
        A, [-radius - 2, -radius - 2, 0.0], [radius + 2, radius + 2, 2.5],
        seed=seed, min_separation=0.0,
    )
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(A) / A
    for i, a in enumerate(m.agents):
        jit = rng.uniform(-0.05, 0.05, 2)
        a.start = np.array([radius * np.cos(ang[i]) + jit[0],
                            radius * np.sin(ang[i]) + jit[1], 0.6])
        a.goal = np.array([-a.start[0], -a.start[1], 0.6])
    return m


def random_swap_mission(A, half, seed):
    from lsc_dr_planner_tpu.mission import generate_random_mission

    m = generate_random_mission(
        A, [-half, -half, 0.0], [half, half, 2.5], seed=seed,
        min_separation=1.0,
    )
    return m


def run_one(mission, name, max_iter=1000):
    from lsc_dr_planner_tpu.config import GoalMode, Param, PlannerMode
    from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator

    # PRIOR_BASED goal planning: symmetric open-world swaps (the circle
    # cases) deadlock under plain static goals by design — the DLSC
    # paper's open-world experiments resolve them with priority-based
    # goal yielding (reference goalPlanningWithPriority,
    # src/traj_planner.cpp:481-538), which is the scheme validated here.
    p = Param(
        world_dimension=2, world_use_octomap=False,
        communication_range=-1.0, goal_mode=GoalMode.PRIOR_BASED,
        planner_mode=PlannerMode.DLSC, multisim_time_step=0.1,
        multisim_max_planner_iteration=max_iter, profile_stages=False,
    )
    sim = MultiSyncSimulator(p, mission, log_dir=os.path.join("log", "dlsc_open"))
    t0 = time.time()
    r = sim.run()
    r["mission"] = name
    r["wall_s"] = round(time.time() - t0, 1)
    r["success"] = bool(
        not r["is_collided"] and not r["qp_failed"]
        and np.isfinite(r["total_flight_time"])
        and r["vel_excess_ratio"] == 0.0 and r["acc_excess_ratio"] == 0.0
    )
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--out", default="log/benchmark/dlsc_openworld.jsonl")
    args = ap.parse_args()

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["mission"])
                except Exception:
                    pass

    cases = []
    for A in (8, 16, 24):
        cases.append((f"circle{A}", circle_mission(A, 0.22 * A + 1.8,
                                                   seed=A)))
    for s in range(4):
        A = 10 + 4 * s
        cases.append((f"swap{A}_s{s}",
                      random_swap_mission(A, 1.1 * np.sqrt(A) + 2.0,
                                          seed=100 + s)))

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    import subprocess
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))).stdout.strip()
    except Exception:
        commit = "unknown"
    for name, m in cases:
        if name in done:
            continue
        r = run_one(m, name)
        r["git_commit"] = commit
        r["platform"] = _PLATFORM
        with open(args.out, "a") as f:
            f.write(json.dumps(r) + "\n")
        print(f"{name}: flight={r['total_flight_time']:.1f}s "
              f"safety={r['safety_ratio_agent']:.3f} "
              f"{'OK' if r['success'] else 'FAIL'}", flush=True)


if __name__ == "__main__":
    main()
