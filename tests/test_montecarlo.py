"""Monte-Carlo scenario-batched simulation tests."""

import numpy as np

from lsc_dr_planner_tpu.config import Param
from lsc_dr_planner_tpu.mission import generate_random_mission
from lsc_dr_planner_tpu.sim.montecarlo import MonteCarloSimulator


def test_montecarlo_lockstep(tmp_path):
    m = generate_random_mission(3, [-3, -3, 0], [3, 3, 2.5], seed=4,
                                min_separation=1.5)
    p = Param(world_use_octomap=False, multisim_max_planner_iteration=80,
              qp_max_iter=120)
    mc = MonteCarloSimulator(p, m, n_scenarios=3, max_noise=0.5,
                             log_dir=str(tmp_path))
    results = mc.run()
    assert len(results) == 3
    for r in results:
        assert not r["is_collided"]
        assert r["safety_ratio_agent"] >= 1.0
    # scenario 0 is noise-free; perturbed scenarios differ
    g0 = mc.sims[0].desired_goal
    g1 = mc.sims[1].desired_goal
    assert np.linalg.norm(g0 - g1) > 1e-6


def test_montecarlo_sharded_scenarios(tmp_path):
    """Scenario batch sharded over the virtual 8-device mesh produces
    the same per-scenario results as the unsharded Monte-Carlo run."""
    import jax
    import numpy as np
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    from jax.sharding import Mesh

    from lsc_dr_planner_tpu.config import Param
    from lsc_dr_planner_tpu.mission import generate_random_mission
    from lsc_dr_planner_tpu.sim.montecarlo import MonteCarloSimulator

    m = generate_random_mission(3, [-3, -3, 0], [3, 3, 2.5], seed=2,
                                min_separation=1.5)
    p = Param(world_use_octomap=False, multisim_max_planner_iteration=40,
              qp_max_iter=60)

    ref = MonteCarloSimulator(p, m, n_scenarios=8, max_noise=0.2,
                              log_dir=str(tmp_path))
    r_ref = ref.run(max_iterations=8)

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("scenarios",))
    shd = MonteCarloSimulator(p, m, n_scenarios=8, max_noise=0.2,
                              log_dir=str(tmp_path), mesh=mesh)
    r_shd = shd.run(max_iterations=8)

    # sharded reductions reorder floats; the ADMM's early exit can shift
    # by a chunk, so trajectories drift at 1e-3-scale over steps —
    # equivalence here is behavioral, not bitwise
    for a, b in zip(ref.sims, shd.sims):
        np.testing.assert_allclose(a.pos, b.pos, atol=0.02)
        assert a.is_collided == b.is_collided
    assert [r["is_collided"] for r in r_ref] == [
        r["is_collided"] for r in r_shd
    ]


def test_replica_shares_statics_and_matches_fresh_build(tmp_path):
    """A share_static_from replica must behave exactly like a freshly
    built simulator over the same mission (the statics are pure
    preprocessing), while actually sharing the heavy objects."""
    import numpy as np

    from lsc_dr_planner_tpu.config import Param
    from lsc_dr_planner_tpu.mission import generate_random_mission
    from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator

    m = generate_random_mission(4, [-3, -3, 0], [3, 3, 2.5], seed=11,
                                min_separation=1.2)
    p = Param(world_use_octomap=False, multisim_max_planner_iteration=30,
              qp_max_iter=60)
    base = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    fresh = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    replica = MultiSyncSimulator(p, m, log_dir=str(tmp_path),
                                 share_static_from=base)
    assert replica.planner is base.planner
    assert replica.coarse is base.coarse
    assert replica.world is base.world

    for it in range(4):
        for sim in (fresh, replica):
            if it > 0:
                sim.do_step()
            sim.decentralized_mapp()
            assert sim.plan()
    np.testing.assert_array_equal(fresh.pos, replica.pos)
    np.testing.assert_array_equal(fresh.desired_ctrl, replica.desired_ctrl)


def test_montecarlo_chunked_non_pow2(tmp_path):
    """S > 32 runs through 32-wide chunks of the flattened S×A QP; a
    non-divisible scenario count (e.g. 40) must pad its bucket to a
    multiple of 32 instead of capping at S (regression: reshape error
    at S=40)."""
    p = Param(world_use_octomap=False, communication_range=3.0,
              profile_stages=False, qp_max_iter=60, qp_rescue_iter=80)
    m = generate_random_mission(3, [-4, -4, 0], [4, 4, 2.5], seed=0)
    mc = MonteCarloSimulator(p, m, n_scenarios=40, max_noise=0.2,
                             log_dir=str(tmp_path))
    for it in range(2):
        mc.step(it)
    assert 0.0 <= mc.last_qp_convergence <= 1.0
    assert all(np.isfinite(sim.pos).all() for sim in mc.sims)
