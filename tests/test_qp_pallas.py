"""ADMM Triton kernel (ops/qp_pallas.py) against the XLA loop.

On the CPU the kernel runs in interpret mode; its GPU lowering is
checked by lowering for CUDA (no card needed), and the compiled kernel
is compared on the card by the `chip`-marked test. The contract is the
one the planner relies on: identical converged set, feasible rows at
the gate, and near-optimal objectives. Exact iterate equality is NOT
expected — float reduction order differs, and a gate decision that
flips by one chunk moves the exit to another ε-optimal iterate.
"""

import functools

import jax
import numpy as np
import pytest

from lsc_dr_planner_tpu.config import GoalMode, Param


def _mini_qp(A=5, seed=0, dim=2, **overrides):
    """A realistic batched QP from the planner (a ring of crossing agents
    with active LSC rows)."""
    import jax.numpy as jnp

    from lsc_dr_planner_tpu.ops import trajectory
    from lsc_dr_planner_tpu.planner.pipeline import (
        FleetArrays, FleetPlanner, StepInputs,
    )
    from lsc_dr_planner_tpu.world.grid import build_grid_world

    rng = np.random.default_rng(seed)
    kw = dict(world_use_octomap=False, goal_mode=GoalMode.STATIC,
              communication_range=3.0, max_obstacles=6,
              qp_max_iter=400, qp_rescue_iter=1600, world_dimension=dim)
    kw.update(overrides)
    p = Param(**kw)
    # ring of agents stepping clockwise: active LSC rows between
    # neighbors, goals ~1 m out — a well-conditioned instance both
    # solvers certify (far-goal cold starts are the straggler regime
    # and converge past the iteration budget in BOTH paths)
    radius = max(1.6, 0.45 * A / (2 * np.pi))
    ang = 2 * np.pi * np.arange(A) / A
    pos2 = radius * np.stack([np.cos(ang), np.sin(ang)], -1) \
        + rng.uniform(-0.05, 0.05, (A, 2))
    ang2 = ang + min(0.7, 1.0 / radius)
    goal2 = radius * np.stack([np.cos(ang2), np.sin(ang2)], -1) \
        + rng.uniform(-0.05, 0.05, (A, 2))
    half = radius + 4.0
    world = build_grid_world(np.zeros((0, 6)), [-half, -half, 0],
                             [half, half, 1.5], p.world_resolution, 0.15)
    planner = FleetPlanner(p, world, A, max_dynobs=0, agent_radius=0.15)
    f32 = jnp.float32
    z = rng.uniform(0.5, 0.7, (A, 1)) if dim == 3 else np.full(
        (A, 1), p.world_z_2d)
    pos = np.concatenate([pos2, z], 1)
    goal = np.concatenate([goal2, z], 1)
    fleet = FleetArrays(
        radius=jnp.full((A,), 0.15, f32), downwash=jnp.full((A,), 2.0, f32),
        max_vel=jnp.ones((A, 3), f32), max_acc=jnp.full((A, 3), 2.0, f32),
        nominal_velocity=jnp.full((A,), 1.0, f32),
    )
    posj = jnp.asarray(pos, f32)
    ctrl = trajectory.const_vel_ctrl(posj, jnp.zeros((A, 3), f32), p.M,
                                     p.n, p.dt)
    inp = StepInputs(
        pos=posj, vel=jnp.zeros((A, 3), f32), acc=jnp.zeros((A, 3), f32),
        prev_ctrl=ctrl, has_prev=jnp.zeros((A,), bool),
        is_disturbed=jnp.zeros((A,), bool),
        desired_goal=jnp.asarray(goal, f32), current_goal=jnp.asarray(goal, f32),
        next_waypoint=posj,  # waypoint box must contain the pinned start
        sfc_lo=jnp.zeros((A, p.M, 3), jnp.int32),
        sfc_hi=jnp.zeros((A, p.M, 3), jnp.int32),
        sfc_initialized=jnp.zeros((A,), bool),
        planner_seq=jnp.int32(1),
        dynobs_pos=jnp.zeros((0, 3), f32), dynobs_vel=jnp.zeros((0, 3), f32),
        dynobs_radius=jnp.zeros((0,), f32), dynobs_downwash=jnp.zeros((0,), f32),
        dynobs_max_acc=jnp.zeros((0,), f32), dynobs_valid=jnp.zeros((0,), bool),
    )
    d = planner._step_impl(fleet, inp, defer_qp=True)
    return planner.qp_cfg, d.qp_inp, planner.feas_tol


def _solve(cfg, qp_inp, feas_tol, loop):
    from lsc_dr_planner_tpu.ops import qp

    return jax.tree_util.tree_map(np.asarray, jax.jit(functools.partial(
        qp.solve, cfg, feas_tol=feas_tol, loop=loop))(qp_inp))


def _assert_equivalent(ref, out, feas_tol, all_converged=True):
    if all_converged:
        # both paths must certify every agent on this feasible instance
        assert ref.converged.all(), ref.primal_residual
    np.testing.assert_array_equal(ref.converged, out.converged)
    conv = out.converged
    assert np.all(out.primal_residual[conv] < feas_tol)
    # matching objectives to exit-time slop
    assert np.allclose(ref.objective[conv], out.objective[conv],
                       rtol=2e-2, atol=2e-2), (ref.objective, out.objective)
    # trajectories agree to solver tolerance
    assert np.max(np.abs(ref.x - out.x)[conv], initial=0.0) < 0.1


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("A", [5, 8])
def test_kernel_interpret_matches_xla(dim, A):
    cfg, qp_inp, feas_tol = _mini_qp(A=A, dim=dim)
    ref = _solve(cfg, qp_inp, feas_tol, "xla")
    out = _solve(cfg, qp_inp, feas_tol, "interpret")
    _assert_equivalent(ref, out, feas_tol)


def test_kernel_serves_the_rescue_batch():
    """A > 64 agents with a short main loop: the 64 worst stragglers are
    compacted into one rescue batch, which the kernel also serves."""
    cfg, qp_inp, feas_tol = _mini_qp(A=72, qp_max_iter=16,
                                     qp_rescue_iter=1600)
    ref = _solve(cfg, qp_inp, feas_tol, "xla")
    out = _solve(cfg, qp_inp, feas_tol, "interpret")
    # the rescue ran: some agents needed more than the main loop's cap
    assert ref.iterations.max() > cfg.max_iter
    assert out.iterations.max() > cfg.max_iter
    _assert_equivalent(ref, out, feas_tol, all_converged=False)


def test_kernel_matches_xla_at_fixed_iterations():
    """With every exit gate shut (a negative feasibility gate is never
    met), both loops run the same 8 iterations and must agree to float32
    precision."""
    cfg, qp_inp, _ = _mini_qp(A=4)
    cfg = cfg._replace(max_iter=8, rescue_iter=0)
    ref = _solve(cfg, qp_inp, -1.0, "xla")
    out = _solve(cfg, qp_inp, -1.0, "interpret")
    np.testing.assert_allclose(out.x, ref.x, atol=2e-6, rtol=0)
    np.testing.assert_allclose(out.y, ref.y, atol=2e-6, rtol=0)
    np.testing.assert_allclose(out.z, ref.z, atol=2e-6, rtol=0)


@pytest.mark.parametrize("loop", ["xla", "triton", "interpret"])
def test_loop_is_an_explicit_argument(loop):
    """`solve(loop=...)` picks the path at trace time: the kernel paths
    contain one pallas_call per loop run (main + rescue), the XLA path
    none; the CPU backend defaults to the XLA loop."""
    from lsc_dr_planner_tpu.ops import qp

    cfg, qp_inp, feas_tol = _mini_qp(A=3)
    jaxpr = str(jax.make_jaxpr(functools.partial(
        qp.solve, cfg, feas_tol=feas_tol, loop=loop))(qp_inp))
    assert jaxpr.count("pallas_call[") == (0 if loop == "xla" else 2)
    assert qp.default_loop() == "xla"
    with pytest.raises(ValueError):
        qp.solve(cfg, qp_inp, loop="pallas")


@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_lowers_for_cuda(dim):
    """The Triton lowering (power-of-two blocks, supported primitives)
    runs without a card: lower the GPU path for the CUDA platform."""
    from lsc_dr_planner_tpu.ops import qp

    cfg, qp_inp, feas_tol = _mini_qp(A=3, dim=dim, max_obstacles=16)
    lowered = jax.jit(functools.partial(
        qp.solve, cfg, feas_tol=feas_tol, loop="triton")).trace(
        qp_inp).lower(lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in lowered.as_text()


@pytest.mark.chip
def test_compiled_kernel_matches_xla_on_gpu():
    """The compiled Triton kernel against the XLA loop on the card."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (the compiled Triton kernel)")
    for dim in (2, 3):
        cfg, qp_inp, feas_tol = _mini_qp(A=64, dim=dim)
        ref = _solve(cfg, qp_inp, feas_tol, "xla")
        out = _solve(cfg, qp_inp, feas_tol, "triton")
        _assert_equivalent(ref, out, feas_tol)
