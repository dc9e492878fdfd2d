"""End-to-end simulator tests (small, fast configurations)."""

import numpy as np
import pytest

from lsc_dr_planner_tpu.config import GoalMode, Param, PlannerMode
from lsc_dr_planner_tpu.mission import Mission, generate_random_mission
from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator


def _mini_mission(n=4, seed=3):
    m = generate_random_mission(
        n, [-3, -3, 0], [3, 3, 2.5], seed=seed, min_separation=1.2
    )
    return m


def _param(**kw):
    defaults = dict(
        world_use_octomap=False,
        multisim_max_planner_iteration=150,
        qp_max_iter=150,
    )
    defaults.update(kw)
    return Param(**defaults)


def test_lsc_dr_mini_mission_completes(tmp_path):
    m = _mini_mission()
    p = _param()
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["total_flight_time"])
    assert res["vel_excess_ratio"] == 0.0
    assert res["acc_excess_ratio"] == 0.0


def test_lsc_static_goal_two_agents(tmp_path):
    """Two agents crossing with the static goal mode (no DR)."""
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=1,
                                min_separation=2.0)
    # head-on crossing
    m.agents[0].start = np.array([-2.0, 0.0, 0.6])
    m.agents[0].goal = np.array([2.0, 0.0, 0.6])
    m.agents[1].start = np.array([2.0, 0.01, 0.6])
    m.agents[1].goal = np.array([-2.0, 0.01, 0.6])
    p = _param(goal_mode=GoalMode.STATIC)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0


def test_bvc_mode_runs(tmp_path):
    m = _mini_mission(n=3, seed=5)
    p = _param(planner_mode=PlannerMode.BVC, goal_mode=GoalMode.STATIC)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    for it in range(10):
        if it > 0:
            sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()
    assert not sim.is_collided


def test_with_obstacle_world_and_csv(tmp_path):
    """Mini forest-like world with saved CSV logs in reference schema."""
    m = generate_random_mission(3, [-3, -3, 0], [3, 3, 2.5], seed=7,
                                min_separation=1.5)
    m.world_boxes = np.array([[0.0, 1.5, 1.25, 0.5, 0.5, 2.5]])
    m.world_file_name = "mini.csv"
    p = _param(world_use_octomap=True, multisim_save_result=True,
               multisim_max_planner_iteration=120)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    # CSV outputs exist with the reference schemas
    import glob, os

    sims = glob.glob(str(tmp_path / "simulation_*.csv"))
    summ = glob.glob(str(tmp_path / "summary_*.csv"))
    assert sims and summ
    header = open(sims[0]).readline()
    assert header.startswith("id,t,px,py,pz,vx,vy,vz,ax,ay,az,planning_time")
    sheader = open(summ[0]).readline()
    assert sheader.startswith("start_time,total_flight_time,total_flight_distance")


def test_patrol_mode_swaps_goals(tmp_path):
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=11,
                                min_separation=2.5)
    p = _param(multisim_patrol=True, multisim_max_planner_iteration=60)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    res = sim.run()
    # patrol never "finishes"; it must keep flying safely
    assert not res["is_collided"]
    assert res["planner_seq"] >= 59


def test_3d_vertical_crossing_with_downwash(tmp_path):
    """3-D mode: a vertical crossing pair must pass safely under the
    ellipsoidal downwash model; planar agents reach goals."""
    m = generate_random_mission(4, [-3, -3, 0], [3, 3, 3.0], seed=9,
                                min_separation=1.5, z=1.5)
    m.agents[0].start = np.array([0.0, 0.0, 0.5])
    m.agents[0].goal = np.array([0.0, 0.0, 2.5])
    m.agents[1].start = np.array([0.5, 0.0, 2.5])
    m.agents[1].goal = np.array([0.5, 0.0, 0.5])
    p = _param(world_dimension=3, multisim_max_planner_iteration=250,
               qp_max_iter=150)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["total_flight_time"])


def test_land_service(tmp_path):
    """LAND (reference /stop_planning service): planning continues,
    is_finished stays False, the audit/recording stops, and in 3-D the
    agents descend toward ground level.
    Reference: multi_sync_simulator.cpp:365-371, 739-743."""
    m = generate_random_mission(3, [-3, -3, 0], [3, 3, 3.0], seed=7,
                                min_separation=1.5, z=1.5)
    p = _param(world_dimension=3, multisim_max_planner_iteration=80)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    # fly a few normal steps first
    for it in range(6):
        if sim.planner_seq > 0:
            sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()
        sim.save_simulation_result()
    z_before = sim.pos[:, 2].copy()
    audit_rows = len(sim.traj_history)
    sim.land()
    for it in range(30):
        assert not sim.is_finished()  # LAND never finishes
        sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()
        # reference: no saveSimulationResult in LAND
    assert len(sim.traj_history) == audit_rows  # audit stopped
    assert np.all(sim.pos[:, 2] < z_before)  # descending
    assert np.all(sim.pos[:, 2] >= 0.0)


def test_dlsc_substep_replanning(tmp_path):
    """DLSC with multisim_time_step < dt (sub-step replanning via the
    subsegment re-parameterization). The reference's CONTINUITY-slack
    variables are vestigial (declared offsets, never created:
    traj_optimizer.cpp:222-230), so sub-step DLSC runs unrelaxed."""
    from lsc_dr_planner_tpu.config import PlannerMode

    m = generate_random_mission(4, [-3, -3, 0], [3, 3, 2.5], seed=3,
                                min_separation=1.2)
    p = _param(planner_mode=PlannerMode.DLSC, multisim_time_step=0.1,
               dt=0.2, multisim_max_planner_iteration=200)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["total_flight_time"])


def test_dynamic_obstacles_end_to_end(tmp_path):
    """Agents cross a field with a spinning and a straight-moving
    obstacle; full audit (agent-agent AND agent-obstacle safety).
    Reference obstacle models: include/obstacle.hpp:83-214."""
    from lsc_dr_planner_tpu.mission import ObstacleSpec

    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=21,
                                min_separation=2.0)
    m.obstacles.append(ObstacleSpec(
        type="spin", radius=0.2, max_acc=1.0, downwash=1.0,
        axis_position=np.array([0.0, 0.0, 0.6]),
        axis_ori=np.array([0.0, 0.0, 1.0]),
        start=np.array([0.8, 0.0, 0.6]),
        speed=0.4,
    ))
    m.obstacles.append(ObstacleSpec(
        type="straight", radius=0.15, max_acc=1.0, downwash=1.0,
        start=np.array([-2.0, 1.5, 0.6]),
        goal=np.array([2.0, 1.5, 0.6]),
        speed=0.3,
    ))
    p = _param(multisim_max_planner_iteration=120)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["safety_ratio_obs"])
    assert res["safety_ratio_obs"] >= 1.0
    assert np.isfinite(res["total_flight_time"])


def test_obstacle_observation_noise_wiring(tmp_path):
    """multisim_observer_stddev perturbs the PLANNER's view of dynamic
    obstacles (reference hook obstacle_generator.hpp:95-108) while the
    audit uses true states; the run must remain safe under small noise."""
    from lsc_dr_planner_tpu.mission import ObstacleSpec

    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=23,
                                min_separation=2.0)
    m.obstacles.append(ObstacleSpec(
        type="straight", radius=0.2, max_acc=1.0, downwash=1.0,
        start=np.array([-2.0, 0.5, 0.6]),
        goal=np.array([2.0, 0.5, 0.6]),
        speed=0.3,
    ))
    p = _param(multisim_max_planner_iteration=100,
               multisim_observer_stddev=0.03)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))

    # the planner's observed obstacle positions differ from truth
    inp = sim._build_step_inputs()
    true_state = sim.obstacle_generator.states_at(0.0)[0]
    observed = np.asarray(inp.dynobs_pos[0])
    assert np.linalg.norm(observed - true_state.position) > 1e-6

    res = sim.run()
    assert not res["is_collided"]
    assert res["safety_ratio_obs"] >= 1.0


def test_groups_spatial_hash_matches_dense(tmp_path):
    """The spatial-hash union-find grouping must match the O(A²) dense
    connected-components reference (multi_sync_simulator.cpp:160-194)."""
    rng = np.random.default_rng(7)
    for A, R in [(1, 2.0), (13, 1.5), (60, 3.0), (60, 0.4)]:
        m = generate_random_mission(A, [-6, -6, 0], [6, 6, 3], seed=int(R * 10) + A)
        p = _param(communication_range=R)
        sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
        sim.pos = rng.uniform([-6, -6, 0], [6, 6, 3], (A, 3))
        got = sim._groups()

        d = np.max(np.abs(sim.pos[:, None] - sim.pos[None, :]), axis=-1)
        adj = d < R
        seen = np.zeros(A, bool)
        want = []
        for i in range(A):
            if seen[i]:
                continue
            stack, comp = [i], []
            seen[i] = True
            while stack:
                u = stack.pop()
                comp.append(u)
                for v in np.nonzero(adj[u] & ~seen)[0]:
                    seen[v] = True
                    stack.append(v)
            want.append(sorted(comp))
        want = sorted(want)
        assert got == want, (A, R)


def test_auto_layer_selection_on_reference_worlds(tmp_path):
    """mapf_layer=auto must route corridor mazes to committed-MCP and
    open forests to the hybrid flow layer (thresholds from the 90-world
    sweep; see simulator._resolve_layer)."""
    import os

    from lsc_dr_planner_tpu.mission import Mission

    REF = "/root/reference"
    if not os.path.isdir(REF):
        return
    cases = [
        (f"{REF}/missions/forest10/forest10_1.json",
         f"{REF}/world/forest/forest1.csv", "hybrid"),
        (f"{REF}/missions/maze10_sparse/maze10_1.json",
         f"{REF}/world/maze/sparse/maze1.csv", "mcp"),
        (f"{REF}/missions/maze10_dense/maze10_1.json",
         f"{REF}/world/maze/dense/maze1.csv", "mcp"),
    ]
    for mf, wf, want in cases:
        p = Param(world_dimension=2, world_use_octomap=True)
        m = Mission.load(mf, world_file=wf, world_dimension=2,
                         world_z_2d=p.world_z_2d)
        sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
        assert sim._layer == want, (mf, sim._layer)


@pytest.mark.slow
def test_fuzz_subset_deadlock_free():
    """Seeded subset of the OOD deadlock fuzz (tools/fuzz_missions.py):
    random worlds + fleets the waypoint-layer constants were NOT tuned
    on must finish collision-free with finite flight time in both
    forced layer modes."""
    import sys

    sys.path.insert(0, ".")
    from tools.fuzz_missions import run_case

    cases = [(2001, "hybrid"), (2002, "mcp"), (2003, "auto")]
    for seed, layer in cases:
        r = run_case(seed, layer, A=8)
        # these seeds are known to generate successfully — a skip row
        # (mission generation failure) is itself a regression
        assert "skip" not in r, (seed, layer, r)
        assert r["clean"], (seed, layer, r)
