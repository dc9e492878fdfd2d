"""QP convergence forensics: classify the
non-converged agents in the bench workload — primal infeasibility
(which constraint family?) vs iteration cap — from the solver's own
qp_residual / qp_iterations outputs.

Usage: python tools/qp_forensics.py [--A 1024] [--steps 8] [--cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--A", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import bench
    from lsc_dr_planner_tpu.ops import qp, trajectory

    from lsc_dr_planner_tpu import runtime

    runtime.setup_compile_cache()
    p, planner, fleet, inp = bench.build_fleet(args.A)
    step = bench.make_evolve_step(p, planner, fleet)

    full = jax.jit(planner._step_impl)
    for k in range(args.steps):
        out = full(fleet, inp)
        res = np.asarray(out.qp_residual)
        its = np.asarray(out.qp_iterations)
        conv = np.asarray(out.qp_converged)
        bad = np.nonzero(~conv)[0]
        row = {
            "step": k,
            "conv_rate": round(float(conv.mean()), 4),
            "n_bad": int(len(bad)),
            "res_p50": round(float(np.percentile(res, 50)), 5),
            "res_max": round(float(res.max()), 4),
            "iters_p50": int(np.percentile(its, 50)),
            "iters_max": int(its.max()),
        }
        if len(bad):
            row["bad_residuals"] = [round(float(res[i]), 4)
                                    for i in bad[:10]]
            row["bad_iters"] = [int(its[i]) for i in bad[:10]]
        print(json.dumps(row), flush=True)
        inp, _ = step(inp)

    # slow-vs-infeasible classification: re-solve the LAST evolved state
    # with 5× the iteration budget — residuals that stay flat are primal
    # infeasibility (failsafe by design, reference traj_planner.cpp:
    # 795-797); residuals that drop are pure iteration-budget shortfall
    if len(bad):
        from lsc_dr_planner_tpu.planner.pipeline import FleetPlanner

        p2 = p.replace(qp_max_iter=1000)
        planner2 = FleetPlanner(p2, planner.world, args.A, max_dynobs=0,
                                agent_radius=0.15, max_vel_hint=1.0)
        out2 = jax.jit(planner2._step_impl)(fleet, inp)
        res2 = np.asarray(out2.qp_residual)
        conv2 = np.asarray(out2.qp_converged)
        print(json.dumps({
            "note": "same state re-solved at max_iter=1000",
            "conv_rate_1000": round(float(conv2.mean()), 4),
            "bad_res_200_vs_1000": [
                [round(float(res[i]), 4), round(float(res2[i]), 4)]
                for i in bad[:10]
            ],
            "still_bad": int(np.sum(~conv2)),
        }))


if __name__ == "__main__":
    main()
