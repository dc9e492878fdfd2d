"""Full reference-benchmark runner: the 90 missions of forest10 +
maze10_sparse + maze10_dense (the reference's test_all_* launch files,
/root/reference/launch/test_all_forest.launch etc.).

Idempotent with a time budget: already-completed missions (tracked in
log/benchmark/<set>.jsonl) are skipped, so repeated invocations resume
where the previous one stopped. Appends one summary row per mission to
log/benchmark/summary_<set>.csv in the reference schema
(multi_sync_simulator.cpp:658-709) plus a JSON line per mission.

Run from a clean checkout pinned at a commit (rows record the commit)
so live-tree edits cannot contaminate a sweep:

    python tools/run_benchmark.py --set forest10 [--platform gpu]
    python tools/run_benchmark.py --set maze10_sparse
    python tools/run_benchmark.py --set maze10_dense
"""

import argparse
import json
import os
import sys
import time

# --platform must take effect before jax backend init: pre-scan argv
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

REF = "/root/reference"
try:
    import subprocess
    GIT_COMMIT = subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ).stdout.strip()
except Exception:
    GIT_COMMIT = "unknown"
SETS = {
    "forest10": (f"{REF}/missions/forest10", f"{REF}/world/forest"),
    "maze10_sparse": (f"{REF}/missions/maze10_sparse", f"{REF}/world/maze/sparse"),
    "maze10_dense": (f"{REF}/missions/maze10_dense", f"{REF}/world/maze/dense"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", required=True, choices=sorted(SETS))
    ap.add_argument("--budget", type=float, default=1e9,
                    help="stop starting new missions after this many seconds")
    ap.add_argument("--log-dir", default="log/benchmark")
    ap.add_argument("--max-iter", type=int, default=600)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"],
                    help="cpu (local) or gpu (fails without one)")
    ap.add_argument("--planner", default="lsc", choices=["lsc", "dlsc"])
    ap.add_argument("--timestep", type=float, default=None,
                    help="multisim_time_step (DLSC sub-step replanning "
                         "when < dt; default = dt)")
    args = ap.parse_args()

    from lsc_dr_planner_tpu.config import Param
    from lsc_dr_planner_tpu.mission import Mission, enumerate_mission_set_natural
    from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator

    from lsc_dr_planner_tpu.config import PlannerMode

    planner_mode = PlannerMode[args.planner.upper()]
    suffix = "" if planner_mode == PlannerMode.LSC else f"_{args.planner}"
    os.makedirs(args.log_dir, exist_ok=True)
    done_path = os.path.join(args.log_dir, f"{args.set}{suffix}.jsonl")
    done = set()
    if os.path.exists(done_path):
        with open(done_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["mission"])
                except Exception:
                    pass

    mission_dir, world_dir = SETS[args.set]
    pairs = enumerate_mission_set_natural(mission_dir, world_dir)
    t0 = time.time()
    ran = 0
    for mf, wf in pairs:
        name = os.path.basename(mf)
        if name in done:
            continue
        if time.time() - t0 > args.budget:
            print(f"# budget reached after {ran} missions", flush=True)
            return 0
        ts = args.timestep
        param = Param(
            world_dimension=2, world_use_octomap=True,
            communication_range=3.0, multisim_save_result=False,
            multisim_max_planner_iteration=args.max_iter,
            profile_stages=False,  # avoid 6 prefix compiles per world
            planner_mode=planner_mode,
            multisim_time_step=(ts if ts is not None else 0.2),
        )
        mission = Mission.load(mf, world_file=wf, world_dimension=2,
                               world_z_2d=param.world_z_2d)
        sim = MultiSyncSimulator(param, mission, log_dir=args.log_dir)
        r = sim.run()
        r["mission"] = name
        r["git_commit"] = GIT_COMMIT
        r["world"] = os.path.basename(wf)
        r["set"] = args.set
        # reference-schema summary row (one per mission)
        sim.save_result = True
        sim.file_name_param = (
            f"{args.set}_{param.planner_mode_str()}_{sim.A}agents"
        )
        sim._write_summary_csv()
        with open(done_path, "a") as f:
            f.write(json.dumps(r) + "\n")
        ok = (not r["is_collided"] and not r["qp_failed"]
              and np.isfinite(r["total_flight_time"]))
        print(f"{name}: flight={r['total_flight_time']:.1f}s "
              f"dist={r['total_flight_distance']:.1f}m "
              f"safety={r['safety_ratio_agent']:.3f} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        ran += 1
    print(f"# set {args.set} complete ({ran} new)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
