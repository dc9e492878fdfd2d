"""Pod-config Monte-Carlo throughput: A agents × S scenarios in one
vmapped device call per step, host MAPF threaded across scenarios
(BASELINE.json pod config: 1024 agents × 256 scenarios; this measures
the single-chip slice A×S and reports the host/device split so the
S-axis cost is visible). Sweeps S and prints one JSON row per value.

Usage: python tools/mc_pod_bench.py [--A 1024] [--S 8,32,64] [--steps 5]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_one(A, S, steps, mission, param):
    from lsc_dr_planner_tpu import runtime
    from lsc_dr_planner_tpu.sim.montecarlo import MonteCarloSimulator

    t0 = time.perf_counter()
    mc = MonteCarloSimulator(param, mission, n_scenarios=S, max_noise=0.25,
                             log_dir=os.path.join(runtime.REPO_ROOT, "log",
                                                  "mc_pod"))
    t_build = time.perf_counter() - t0

    mc.step(0)  # warm-up + compile
    t0 = time.perf_counter()
    phases = {"host": 0.0, "stack": 0.0, "device": 0.0, "apply": 0.0}
    conv = []
    for it in range(1, steps + 1):
        mc.step(it)
        for k in phases:
            phases[k] += mc.phase_times[k]
        conv.append(mc.last_qp_convergence)
    dt = (time.perf_counter() - t0) / steps
    row = {
        "A": A, "S": S, "steps": steps, "built_s": round(t_build, 1),
        "step_s": round(dt, 3),
        "agent_scenario_steps_per_s": round(A * S / dt, 1),
        "qp_convergence_min": round(min(conv), 5),
        "qp_convergence_mean": round(sum(conv) / len(conv), 5),
        "phases_s": {k: round(v / steps, 3) for k, v in phases.items()},
    }
    del mc
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--A", type=int, default=1024)
    ap.add_argument("--S", default="8")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from lsc_dr_planner_tpu import runtime
    from lsc_dr_planner_tpu.config import Param
    from lsc_dr_planner_tpu.mission import generate_random_mission

    runtime.setup_compile_cache()

    A = args.A
    half = max(6.0, 0.7 * float(np.sqrt(A)))
    mission = generate_random_mission(
        A, [-half, -half, 0], [half, half, 2.5], seed=0,
    )
    # straggler rescue stays ENABLED: the scenario step flattens the
    # S × A axes into one QP batch, so the rescue compaction runs once
    # over the whole flattened batch (montecarlo.py) instead of
    # duplicating its working set per vmap lane (the r4 OOM).
    param = Param(world_use_octomap=False, communication_range=3.0,
                  profile_stages=False)
    for S in [int(s) for s in args.S.split(",")]:
        row = bench_one(A, S, args.steps, mission, param)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
