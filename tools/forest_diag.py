"""Forest quality diagnosis: run one mission on CPU and report per-agent
goal-reach times plus waypoint-layer statistics.

Usage: python tools/forest_diag.py [mission_idx] [--set forest10]
"""

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("idx", type=int, nargs="?", default=1)
    ap.add_argument("--set", default="forest10")
    ap.add_argument("--max-iter", type=int, default=400)
    ap.add_argument("--no-commit-ecbs", action="store_true")
    ap.add_argument("--layer", default="auto")
    ap.add_argument("--hl-nodes", type=int, default=5000)
    args = ap.parse_args()

    from lsc_dr_planner_tpu import runtime
    from lsc_dr_planner_tpu.config import Param

    runtime.setup_compile_cache()
    from lsc_dr_planner_tpu.mission import Mission
    from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator

    REF = "/root/reference"
    sets = {
        "forest10": (f"{REF}/missions/forest10/forest10_{args.idx}.json",
                     f"{REF}/world/forest/forest{args.idx}.csv"),
        "maze10_dense": (f"{REF}/missions/maze10_dense/maze10_{args.idx}.json",
                         f"{REF}/world/maze/dense/maze{args.idx}.csv"),
        "maze10_sparse": (f"{REF}/missions/maze10_sparse/maze10_{args.idx}.json",
                          f"{REF}/world/maze/sparse/maze{args.idx}.csv"),
    }
    mf, wf = sets[args.set]
    param = Param(world_dimension=2, world_use_octomap=True,
                  communication_range=3.0, multisim_save_result=False,
                  multisim_max_planner_iteration=args.max_iter,
                  mapf_commit_ecbs=not args.no_commit_ecbs,
                  mapf_layer=args.layer, mapf_hl_nodes=args.hl_nodes)
    mission = Mission.load(mf, world_file=wf, world_dimension=2,
                           world_z_2d=param.world_z_2d)
    sim = MultiSyncSimulator(param, mission, log_dir=os.path.join("log", "forest_diag"))

    A = sim.A
    reach_step = np.full(A, -1)
    wp_advance = np.zeros(A, int)

    prev_wp = sim.next_waypoint.copy()
    it = 0
    while it < args.max_iter - 1 and not sim.is_finished():
        if sim.planner_seq > 0 or it > 0:
            sim.do_step()
        sim.decentralized_mapp()
        ok = sim.plan()
        if not ok:
            print("QP FAILED")
            break
        sim.save_simulation_result()
        moved = np.linalg.norm(sim.next_waypoint - prev_wp, axis=-1) > 1e-9
        wp_advance += moved
        prev_wp = sim.next_waypoint.copy()
        d = np.linalg.norm(sim.pos - sim.desired_goal, axis=-1)
        for i in range(A):
            if reach_step[i] < 0 and d[i] <= param.goal_threshold:
                reach_step[i] = it
            elif reach_step[i] >= 0 and d[i] > param.goal_threshold:
                reach_step[i] = -1  # left the goal again
        it += 1

    print(f"mission={os.path.basename(mf)} flight_time={sim.total_flight_time}"
          f" steps={it} safety={sim.safety_ratio_agent:.3f}"
          f" collided={sim.is_collided}"
          f" mapf_max_ms={sim.planning_time.mapf_time.max*1e3:.1f}")
    t = np.where(reach_step >= 0, reach_step * param.multisim_time_step, np.inf)
    order = np.argsort(t)
    print("per-agent reach times (s):",
          " ".join(f"a{i}:{t[i]:.1f}" for i in order))
    print("waypoint advances per agent:",
          " ".join(f"a{i}:{wp_advance[i]}" for i in range(A)))
    # event summary
    from collections import Counter
    c = Counter(e[1] for e in sim.events)
    print("events:", dict(c))
    gates = [e for e in sim.events if e[1] in ("gates", "gates_ps")]
    import numpy as _np
    tot = {"comm": 0, "lp": 0, "done": 0, "order": 0, "ncand": 0, "adv": 0}
    for _, _, (gsz, gb, ncand, nadv) in gates:
        for k, v in gb.items():
            tot[k] += v
        tot["ncand"] += ncand
        tot["adv"] += nadv
    print("gate blocks:", tot)
    solves = [e for e in sim.events if e[1] == "solve"]
    print(f"solves: {len(solves)} (first 30: "
          f"{[(e[0], e[2][0], e[2][1]) for e in solves[:30]]})")


if __name__ == "__main__":
    main()
