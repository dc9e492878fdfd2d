"""Smoke test of the planner's main path on the GPU, in one process.

    python3 chip_smoke.py               # phases a-c on one card
    python3 chip_smoke.py --four-cards  # phase d only, on four cards

Phases (each prints one JSON line; any failure exits non-zero):

  a. the bench's open-forest fleet step at A = 1024 (M = 10, n = 5,
     dt = 0.2 s, 3 m comm range, 16 neighbour slots): compile, memory
     analysis, 3 warm-up and 20 evolving steps, p50/p99 step time,
     QP convergence and ADMM iterations (informational, not a benchmark);
  b. the ADMM Triton kernel against the plain XLA loop on the same
     A = 1024 QP batch, taken from the fleet after 3 steps, 2-D and 3-D;
  c. a seeded 10-agent forest mission through `MultiSyncSimulator` to
     completion (goals reached, safety ratio ≥ 1, no dynamic-limit
     excess, native MAPF), then 5 simulator steps of a seeded A = 1024
     forest mission;
  d. (--four-cards) the all-gather (`parallel/mesh.py`) and halo
     (`parallel/halo.py`) sharded steps at A = 1024 over four cards,
     each compared field-wise with the single-card step.

The last line is `{"ok": true, "device": {...}}` with the device as JAX
reports it. Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

A_FLEET = 1024


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok, what) -> None:
    """Fail the phase (and the run) unless `ok`; kept under `python -O`."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _timed_steps(step, inp, n):
    """Run `n` evolving steps; returns (inp, last out, per-step seconds)."""
    lat = []
    out = None
    for _ in range(n):
        t0 = time.perf_counter()
        inp, out = step(inp)
        out.qp_converged.block_until_ready()
        lat.append(time.perf_counter() - t0)
    return inp, out, np.asarray(lat)


def phase_a(card: str) -> None:
    import jax

    from bench import build_fleet, make_evolve_step
    from lsc_dr_planner_tpu.ops import qp

    t0 = time.perf_counter()
    p, planner, fleet, inp = build_fleet(A_FLEET)
    step = make_evolve_step(p, planner, fleet)
    compiled = step.lower(inp).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()

    inp, _, _ = _timed_steps(compiled, inp, 3)
    inp, out, lat = _timed_steps(compiled, inp, 20)
    conv = np.asarray(out.qp_converged)
    iters = np.asarray(out.qp_iterations)
    ctrl = np.asarray(out.desired_ctrl)
    emit("a_fleet_step", A=A_FLEET, qp_loop=qp.default_loop(),
         setup_and_compile_s=compile_s,
         memory={k: getattr(mem, k) for k in (
             "argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "generated_code_size_in_bytes")},
         steps=20, p50_ms=float(np.percentile(lat, 50) * 1e3),
         p99_ms=float(np.percentile(lat, 99) * 1e3),
         qp_convergence=float(conv.mean()),
         admm_iters_mean=float(iters.mean()),
         admm_iters_max=int(iters.max()),
         peak_bytes_in_use=(jax.devices()[0].memory_stats() or {}).get(
             "peak_bytes_in_use"),
         card=card)
    require(np.isfinite(ctrl).all(), "non-finite control points")
    require(ctrl.shape == (A_FLEET, p.M, p.n + 1, 3), ctrl.shape)
    require(conv.mean() > 0.9, f"QP convergence {conv.mean()}")


def _qp_batch(dim: int):
    """The A = 1024 bench fleet's QP batch after 3 evolving steps."""
    import jax

    from bench import build_fleet, make_evolve_step

    p, planner, fleet, inp = build_fleet(A_FLEET, dim=dim)
    step = make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)
    d = jax.jit(functools.partial(planner._step_impl, defer_qp=True))(
        fleet, inp)
    return planner, d.qp_inp


def _objective64(cfg, qp_inp, x):
    """Each agent's QP cost of control points x [A, dim, M, N], in
    float64 on the host: jerk + terminal ‖c_{m,n} − g‖². The solver's own
    float32 objective drops the ‖g‖² constant and carries ~0.1 of
    rounding noise at positions of ~20 m, more than the tolerance."""
    from lsc_dr_planner_tpu.ops import bernstein

    Q = bernstein.jerk_cost_matrix(cfg.n, cfg.phi, 1, cfg.dt)
    x = np.asarray(x, np.float64)
    jerk = cfg.control_input_weight * np.einsum("admi,ij,admj->a", x, Q, x)
    g = np.asarray(qp_inp.goal, np.float64)
    mask = np.asarray(qp_inp.terminal_mask, np.float64)
    end = np.sum((x[..., -1] - g[:, :, None]) ** 2, axis=1)  # [A, M]
    return jerk + cfg.terminal_weight * np.sum(mask * end, axis=1)


def _compare(cfg, qp_inp, ref, ker, tol):
    """Kernel result `ker` against the XLA loop's `ref` (host arrays).
    Returns a summary and each agent's objective excess over the
    np.allclose(rtol=2e-2, atol=2e-2) bound (≤ 2e-2 passes)."""
    conv = ref.converged & ker.converged
    obj_ref = _objective64(cfg, qp_inp, ref.x)
    excess = np.abs(obj_ref - _objective64(cfg, qp_inp, ker.x)) \
        - 2e-2 * np.abs(obj_ref)
    return dict(
        converged_xla=int(ref.converged.sum()),
        converged_kernel=int(ker.converged.sum()),
        same_converged_set=bool(np.array_equal(ref.converged,
                                               ker.converged)),
        worst_kernel_residual=float(np.max(
            ker.primal_residual[ker.converged], initial=0.0)),
        max_abs_dx=float(np.max(np.abs(ref.x - ker.x)[conv], initial=0.0)),
        worst_objective_excess=float(excess.max()),
        objective_over_tol=int((excess > 2e-2).sum()),
        finite=bool(np.isfinite(ker.x).all())), excess


def phase_b(card: str) -> None:
    """Kernel vs XLA loop on the same QP batch, twice: with the planner's
    exit gates, and with every gate shut for a fixed 400 iterations.

    With the gates on, an agent whose gate test sits at the threshold can
    stop one chunk earlier in one path than in the other (the iterates
    agree to float32 precision, the decision flips): both stops are
    certified ε-optimal points, but not like-for-like. The objective and
    |Δx| tolerances are therefore asserted on the agents both paths stop
    at the same iteration, and on every agent in the fixed-iteration run;
    the all-agent numbers are printed beside the XLA loop's own spread
    under a 1-ulp goal perturbation."""
    import jax
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.ops import qp

    rows, failures = [], []
    for dim in (2, 3):
        planner, qp_inp = _qp_batch(dim)
        cfg, tol = planner.qp_cfg, planner.feas_tol
        fixed = cfg._replace(max_iter=400, rescue_iter=0)
        res, times = {}, {}
        for loop in ("xla", "triton"):
            solve = jax.jit(functools.partial(qp.solve, cfg, feas_tol=tol,
                                              loop=loop))
            out = solve(qp_inp)
            out.x.block_until_ready()
            t = []
            for _ in range(5):
                t0 = time.perf_counter()
                solve(qp_inp).x.block_until_ready()
                t.append(time.perf_counter() - t0)
            res[loop] = jax.tree_util.tree_map(np.asarray, out)
            times[loop] = float(np.median(t) * 1e3)
            # gates shut: a negative feasibility gate is never met
            shut = jax.jit(functools.partial(qp.solve, fixed, feas_tol=-1.0,
                                             loop=loop))(qp_inp)
            shut = jax.tree_util.tree_map(np.asarray, shut)
            res[loop + "_fixed"] = shut._replace(
                converged=shut.primal_residual < tol)
        nudged = qp_inp._replace(goal=jnp.nextafter(qp_inp.goal, jnp.inf))
        res["xla_ulp"] = jax.tree_util.tree_map(np.asarray, jax.jit(
            functools.partial(qp.solve, cfg, feas_tol=tol, loop="xla"))(
            nudged))

        gated, gated_excess = _compare(cfg, qp_inp, res["xla"],
                                       res["triton"], tol)
        fx, _ = _compare(fixed, qp_inp, res["xla_fixed"],
                         res["triton_fixed"], tol)
        spread, _ = _compare(cfg, qp_inp, res["xla"], res["xla_ulp"], tol)
        same_stop = res["xla"].iterations == res["triton"].iterations
        same = same_stop & res["xla"].converged & res["triton"].converged
        gated["max_abs_dx_same_stop"] = float(np.max(
            np.abs(res["xla"].x - res["triton"].x)[same], initial=0.0))
        checks = {
            "finite": gated["finite"] and fx["finite"],
            "same_converged_set": gated["same_converged_set"],
            "residual": gated["worst_kernel_residual"] < tol,
            "dx_same_stop": gated["max_abs_dx_same_stop"] < 0.1,
            "objective_same_stop": bool(np.all(
                gated_excess[same_stop] <= 2e-2)),
            "fixed_same_set": fx["same_converged_set"],
            "fixed_dx": fx["max_abs_dx"] < 0.1,
            "fixed_objective": fx["objective_over_tol"] == 0,
        }
        rows.append(dict(
            dim=dim, feas_tol=tol, solve_ms_xla=times["xla"],
            solve_ms_kernel=times["triton"],
            iters_xla=int(res["xla"].iterations.max()),
            iters_kernel=int(res["triton"].iterations.max()),
            same_stop_agents=int(same_stop.sum()), gated=gated,
            fixed400=fx, xla_ulp_spread=spread, checks=checks))
        failures += [f"{dim}-D {k}" for k, ok in checks.items() if not ok]
    emit("b_qp_kernel", A=A_FLEET, results=rows, card=card)
    require(not failures, failures)


def phase_c(card: str) -> None:
    from lsc_dr_planner_tpu.config import GoalMode, MAPFMode, Param
    from lsc_dr_planner_tpu.mission import (
        lattice_forest_mission, make_mission, random_world,
    )
    from lsc_dr_planner_tpu.runtime import REPO_ROOT
    from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator

    log_dir = os.path.join(REPO_ROOT, "log", "chip_smoke")
    rng = np.random.default_rng(7)
    half = 5.0
    mission = None
    while mission is None:
        mission = make_mission(rng, 10, random_world(rng, "forest", half),
                               half)
    param = Param(world_dimension=2, world_use_octomap=True,
                  goal_mode=GoalMode.GRID_BASED_PLANNER,
                  mapf_mode=MAPFMode.PIBT, communication_range=3.0,
                  multisim_max_planner_iteration=600, profile_stages=False)
    t0 = time.perf_counter()
    sim = MultiSyncSimulator(param, mission, log_dir=log_dir,
                             save_result=False)
    r = sim.run()
    small = dict(wall_s=time.perf_counter() - t0, finished=sim.is_finished(),
                 **{k: r[k] for k in (
                     "total_flight_time", "safety_ratio_agent",
                     "safety_ratio_obs", "vel_excess_ratio",
                     "acc_excess_ratio", "is_collided", "qp_failed",
                     "planner_seq", "mapf_backend", "planning_time_p50_ms",
                     "planning_time_p99_ms")})

    t0 = time.perf_counter()
    big = MultiSyncSimulator(param, lattice_forest_mission(A_FLEET, seed=0),
                             log_dir=log_dir, save_result=False)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    rb = big.run(max_iterations=6)  # the loop stops one short: 5 steps
    fleet = dict(A=A_FLEET, setup_s=setup, wall_s=time.perf_counter() - t0,
                 **{k: rb[k] for k in (
                     "planner_seq", "is_collided", "qp_failed",
                     "mapf_backend", "safety_ratio_agent",
                     "safety_ratio_obs", "planning_time_p50_ms")})
    emit("c_missions", mission_10=small, mission_1024=fleet, card=card)
    require(small["finished"] and np.isfinite(r["total_flight_time"]), r)
    require(min(r["safety_ratio_agent"], r["safety_ratio_obs"]) >= 1.0, r)
    require(r["vel_excess_ratio"] == 0 and r["acc_excess_ratio"] == 0, r)
    require(not r["is_collided"] and not r["qp_failed"], r)
    require(sim.mapf_backend == "native", sim.mapf_backend)
    require(rb["planner_seq"] >= 5, rb["planner_seq"])
    require(not rb["is_collided"] and not rb["qp_failed"], rb)
    require(big.mapf_backend == "native", big.mapf_backend)


def phase_d(card: str) -> None:
    """All-gather and halo sharded steps over four cards against the
    single-card step, from the same mid-flight fleet state.

    Fields are compared as tests/test_parallel.py does. The QP's exit
    gates are float32-noise-driven (PERF.md), so an agent whose inputs
    differ in the last bit across shardings can stop one chunk apart:
    `desired_ctrl` is therefore asserted on the agents whose ADMM
    iteration counts agree, and the others are counted and printed."""
    import jax

    from bench import build_fleet, make_evolve_step
    from lsc_dr_planner_tpu.parallel import halo
    from lsc_dr_planner_tpu.parallel import mesh as meshmod

    n_dev = 4
    require(len(jax.devices()) >= n_dev, jax.devices())
    p, planner, fleet, inp = build_fleet(A_FLEET)
    step = make_evolve_step(p, planner, fleet)
    for _ in range(3):
        inp, _ = step(inp)
    # spatial slabs for the halo path (a permutation of the same fleet)
    perm = halo.spatial_permutation(np.asarray(inp.pos))
    take = lambda x: x if x is None or np.ndim(x) == 0 else x[perm]
    fleet = jax.tree_util.tree_map(take, fleet)
    inp = type(inp)(*[
        v if n.startswith("dynobs") or n == "planner_seq" else take(v)
        for n, v in zip(type(inp)._fields, inp)
    ])
    mesh = meshmod.make_mesh(n_dev)
    hops = halo.required_hops(np.asarray(inp.pos), n_dev,
                              p.communication_range)

    def timed(fn, *args):
        out = fn(*args)
        out.desired_ctrl.block_until_ready()
        t = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn(*args).desired_ctrl.block_until_ready()
            t.append(time.perf_counter() - t0)
        return jax.tree_util.tree_map(np.asarray, out), out, float(
            np.median(t) * 1e3)

    ref, _, t_single = timed(jax.jit(planner._step_impl), fleet, inp)
    fleet_s, inp_s = meshmod.shard_step_inputs(mesh, fleet, inp)
    variants = {
        "allgather": meshmod.make_sharded_step(planner, mesh),
        "halo": halo.make_halo_step(planner, mesh, hops=hops),
    }
    skip = {"qp_iterations", "qp_residual", "qp_y"}
    local = A_FLEET // n_dev
    rows, failures = [], []
    for name, fn in variants.items():
        got, live, t_ms = timed(fn, fleet_s, inp_s)
        shards = [(s.device.id, s.data.shape[0])
                  for s in live.desired_ctrl.addressable_shards]
        same_stop = ref.qp_iterations == got.qp_iterations
        worst = {}
        for field in type(ref)._fields:
            if field in skip:
                continue
            a, b = getattr(ref, field), getattr(got, field)
            if field == "desired_ctrl":
                a, b = a[same_stop], b[same_stop]
            if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
                worst[field] = int(np.sum(a != b))
                ok = worst[field] == 0
            else:
                worst[field] = float(np.max(np.abs(a - b), initial=0.0))
                ok = np.allclose(a, b, rtol=1e-4, atol=2e-4)
            if not ok:
                failures.append(f"{name} {field}")
        flipped = ~same_stop
        rows.append(dict(
            variant=name, step_ms=t_ms, shards=shards,
            fully_replicated=bool(live.desired_ctrl.sharding
                                  .is_fully_replicated),
            field_max_abs_diff=worst,
            qp_stop_differs=int(flipped.sum()),
            desired_ctrl_diff_where_stop_differs=float(np.max(
                np.abs(ref.desired_ctrl - got.desired_ctrl)[flipped],
                initial=0.0))))
        if sorted(shards) != [(d.id, local) for d in mesh.devices.flat]:
            failures.append(f"{name} placement {shards}")
    emit("d_four_cards", A=A_FLEET, devices=n_dev, halo_hops=hops,
         single_card_step_ms=t_single, results=rows, card=card)
    require(not failures, failures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase d (needs four GPUs)")
    args = ap.parse_args(argv)

    import jax

    from lsc_dr_planner_tpu import runtime

    cache = runtime.setup_compile_cache()
    print(f"jax {jax.__version__}", flush=True)
    print(f"devices {jax.devices()}", flush=True)
    card = runtime.card_info()
    print(f"card {card}", flush=True)
    print(f"compile cache {cache}", flush=True)
    runtime.require_gpu()

    if args.four_cards:
        phase_d(card)
    else:
        phase_a(card)
        phase_b(card)
        phase_c(card)
    print(json.dumps({"ok": True, "device": runtime.device_info()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
