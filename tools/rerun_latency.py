"""N-rerun latency distribution for one mission: reruns the mission N
times and records the full per-run max/p99/p50 step-latency
distribution, so a tail-latency claim rests on a sample rather than on
one run.

Usage: python tools/rerun_latency.py [--mission forest10_16] [--n 10]
       [--platform gpu|cpu]
"""

import argparse
import json
import os
import sys
import time

_PLATFORM = "gpu"
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mission", default="forest10_16")
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--out", default="log/benchmark/rerun_latency.jsonl")
    args = ap.parse_args()

    from lsc_dr_planner_tpu.config import Param
    from lsc_dr_planner_tpu.mission import Mission
    from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator

    REF = "/root/reference"
    idx = args.mission.split("_")[-1]
    mf = f"{REF}/missions/forest10/{args.mission}.json"
    wf = f"{REF}/world/forest/forest{idx}.csv"

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    for run in range(args.n):
        p = Param(world_dimension=2, world_use_octomap=True,
                  communication_range=3.0, profile_stages=False,
                  multisim_max_planner_iteration=600)
        m = Mission.load(mf, world_file=wf, world_dimension=2,
                         world_z_2d=p.world_z_2d)
        sim = MultiSyncSimulator(p, m, log_dir=os.path.join("log", "rerun_lat"))
        t0 = time.time()
        r = sim.run()
        row = {
            "mission": args.mission, "run": run,
            "platform": _PLATFORM,
            "flight_time": r["total_flight_time"],
            "plan_p50_ms": r["planning_time_p50_ms"],
            "plan_p99_ms": r["planning_time_p99_ms"],
            "plan_max_ms": r["planning_time_max_ms"],
            "collided": r["is_collided"],
            "wall_s": round(time.time() - t0, 1),
        }
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
