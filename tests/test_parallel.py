"""Multi-chip sharding tests on the virtual 8-device CPU mesh
(conftest.py forces --xla_force_host_platform_device_count=8).

Validates that the sharded SPMD step is numerically equivalent to the
single-device step, that scenario-axis sharding works for Monte-Carlo
batches, and that the scaling harness runs at every mesh size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lsc_dr_planner_tpu.parallel import mesh as meshmod

import __graft_entry__ as graft


requires_8dev = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual mesh"
)


def _tree_allclose(a, b, rtol=1e-4, atol=2e-4):
    """Field-wise comparison of StepOutputs. The ADMM's early-exit chunk
    count (qp_iterations) and final residual may legitimately differ by
    one chunk across shardings (reduction-order float differences near
    the tolerance threshold); everything consumed downstream must match.
    qp_y (the dual warm-start hint for the NEXT solve) shares that
    iteration-count sensitivity — it biases convergence speed, never the
    constraint set, so cross-sharding equality is not required."""
    skip = {"qp_iterations", "qp_residual", "qp_y"}
    for name in type(a)._fields:
        if name in skip:
            continue
        la = np.asarray(getattr(a, name))
        lb = np.asarray(getattr(b, name))
        if la.dtype == bool or np.issubdtype(la.dtype, np.integer):
            np.testing.assert_array_equal(la, lb, err_msg=name)
        else:
            np.testing.assert_allclose(la, lb, rtol=rtol, atol=atol,
                                       err_msg=name)


@requires_8dev
@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_step_matches_unsharded(n_devices):
    """make_sharded_step over an N-device mesh ≡ the single-device step
    (same program semantics; XLA inserts the collectives for the
    neighbor gathers)."""
    A = 2 * n_devices
    planner, fleet, inp = graft._build(n_agents=A)

    ref = jax.jit(planner._step_impl)(fleet, inp)

    mesh = meshmod.make_mesh(n_devices)
    fleet_s, inp_s = meshmod.shard_step_inputs(mesh, fleet, inp)
    step = meshmod.make_sharded_step(planner, mesh)
    out = step(fleet_s, inp_s)

    # shardings really applied?
    shd = out.desired_ctrl.sharding
    assert not shd.is_fully_replicated
    _tree_allclose(ref, out)


@requires_8dev
def test_sharded_step_second_iteration():
    """Feed sharded outputs back as inputs (prev_ctrl/SFC state) — the
    steady-state loop — and compare against the unsharded loop."""
    A = 16
    planner, fleet, inp = graft._build(n_agents=A)
    step1 = jax.jit(planner._step_impl)

    def advance(i, o):
        return i._replace(
            prev_ctrl=o.desired_ctrl,
            has_prev=jnp.ones_like(i.has_prev),
            current_goal=o.current_goal,
            sfc_lo=o.sfc_lo, sfc_hi=o.sfc_hi,
            sfc_initialized=o.sfc_initialized,
            planner_seq=i.planner_seq + 1,
        )

    o_ref = step1(fleet, inp)
    o_ref2 = step1(fleet, advance(inp, o_ref))

    mesh = meshmod.make_mesh(8)
    fleet_s, inp_s = meshmod.shard_step_inputs(mesh, fleet, inp)
    sstep = meshmod.make_sharded_step(planner, mesh)
    o_s = sstep(fleet_s, inp_s)
    o_s2 = sstep(fleet_s, advance(inp_s, o_s))

    _tree_allclose(o_ref2, o_s2, rtol=2e-5, atol=2e-5)


@requires_8dev
def test_scenario_axis_sharding():
    """vmapped scenario batches shard over the mesh: S scenario replicas
    of the fleet step, scenario axis split across devices, equivalent to
    the unsharded vmap (the Monte-Carlo scaling surface)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    S = 8
    planner, fleet, inp = graft._build(n_agents=4)
    # S perturbed replicas
    keys = np.arange(S, dtype=np.float32)[:, None, None] * 0.01

    def stack(leaf):
        return jnp.stack([leaf] * S)

    binp = jax.tree_util.tree_map(stack, inp)
    binp = binp._replace(desired_goal=binp.desired_goal + keys)

    vstep = jax.jit(jax.vmap(planner._step_impl, in_axes=(None, 0)))
    ref = vstep(fleet, binp)

    mesh = meshmod.make_mesh(8, axis="scenarios")

    def shard_leaf(name, v):
        if v is None or v.ndim == 0:
            return v
        return jax.device_put(v, NamedSharding(mesh, P("scenarios")))

    binp_s = type(binp)(*[
        shard_leaf(n, v) for n, v in zip(type(binp)._fields, binp)
    ])
    out = vstep(fleet, binp_s)
    _tree_allclose(ref, out)


@requires_8dev
def test_scaling_harness_smoke():
    """The scaling harness used for the scaling table runs at every
    mesh size and reports monotone-nonincreasing... no: virtual CPU
    devices give no real speedup — assert only that it measures."""
    from lsc_dr_planner_tpu.parallel.scaling import measure_scaling

    rows = measure_scaling(device_counts=(1, 2), A_per_device=2, steps=2)
    assert len(rows) == 2
    for r in rows:
        assert r["steps_per_s"] > 0


@requires_8dev
def test_halo_step_matches_unsharded():
    """SURVEY §5.8 halo exchange: the spatially-tiled ppermute neighbor
    exchange must reproduce the global-gather step exactly when every
    in-range neighbor lies within the hop radius. Line formation with
    strictly distinct pairwise distances so the top-k neighbor ordering
    is unique (slot-for-slot comparable)."""
    from lsc_dr_planner_tpu.ops import trajectory
    from lsc_dr_planner_tpu.parallel import halo

    d, A = 4, 16
    planner, fleet, inp = graft._build(n_agents=A)
    p = planner.param

    # irregular line: |x_j - x_i| = (j-i)(0.4 + 0.012(i+j)) — all
    # pairwise distances distinct; width fits the graft world
    i = np.arange(A, dtype=np.float64)
    x = 0.4 * i + 0.012 * i * i
    x -= x.mean()
    pos = np.stack([x, 0.02 * np.sin(i), np.full(A, 0.6)], axis=1)
    pos = jnp.asarray(pos, jnp.float32)
    ctrl = trajectory.const_vel_ctrl(
        pos, jnp.zeros((A, 3), jnp.float32), p.M, p.n, p.dt
    )
    inp = inp._replace(
        pos=pos, prev_ctrl=ctrl, current_goal=pos, next_waypoint=pos,
        desired_goal=pos + jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
    )

    hops = halo.required_hops(np.asarray(pos), d, p.communication_range)
    assert hops <= 2  # slabs ~1.7 m wide, R = 3 m

    ref = jax.jit(planner._step_impl)(fleet, inp)

    mesh = meshmod.make_mesh(d)
    fleet_s, inp_s = meshmod.shard_step_inputs(mesh, fleet, inp)
    hstep = halo.make_halo_step(planner, mesh, hops=hops)
    out = hstep(fleet_s, inp_s)
    _tree_allclose(ref, out)


@requires_8dev
def test_halo_required_hops():
    """required_hops grows as slabs narrow relative to the comm range."""
    from lsc_dr_planner_tpu.parallel import halo

    pos = np.zeros((16, 3))
    pos[:, 0] = np.linspace(0.0, 30.0, 16)  # 2 m spacing, slab ~7.5 m
    assert halo.required_hops(pos, 4, 3.0) == 1
    pos[:, 0] = np.linspace(0.0, 7.5, 16)  # 0.5 m spacing, slab ~1.9 m
    assert halo.required_hops(pos, 4, 3.0) == 2
