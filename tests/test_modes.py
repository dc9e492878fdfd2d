"""End-to-end exercise of the shipped baseline planner/goal modes that
mission benchmarks don't cover:

  * Reciprocal-RSFC (reference: generateReciprocalRSFC,
    src/traj_planner.cpp:581-609) — symmetric crossing,
  * RIGHT_HAND deadlock detour (src/traj_planner.cpp:443-476, 904-923),
  * GOBACK planner state (src/agent_manager.cpp:225-240).

Baseline modes run with the communication range disabled: the comm-range
waypoint box (traj_optimizer.cpp:477-500) is anchored on
`agent.next_waypoint`, which only the DR layer maintains
(multi_sync_simulator.cpp:293) — in the reference too, a non-grid goal
mode with comm range enabled pins every agent within half the comm
range of its START position (agent_manager.cpp:10 initializes
next_waypoint = start).
"""

import numpy as np

from lsc_dr_planner_tpu.config import GoalMode, Param, PlannerMode
from lsc_dr_planner_tpu.mission import generate_random_mission
from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator


def _param(**kw):
    defaults = dict(
        world_use_octomap=False,
        multisim_max_planner_iteration=250,
        qp_max_iter=150,
        communication_range=-1.0,
    )
    defaults.update(kw)
    return Param(**defaults)


def test_reciprocal_rsfc_crossing(tmp_path):
    """Perpendicular symmetric crossing under Reciprocal-RSFC: both
    agents must trade sides collision-free with the mode's reciprocal
    margins (in-conflict planes split the gap: d = ½(size_sum + dist),
    traj_planner.cpp:597-600) and finish."""
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=1,
                                min_separation=2.0)
    m.agents[0].start = np.array([-2.0, 0.0, 0.6])
    m.agents[0].goal = np.array([2.0, 0.0, 0.6])
    m.agents[1].start = np.array([0.0, -2.0, 0.6])
    m.agents[1].goal = np.array([0.0, 2.0, 0.6])
    p = _param(planner_mode=PlannerMode.RECIPROCAL_RSFC,
               goal_mode=GoalMode.STATIC)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    res = sim.run()
    assert not res["is_collided"]
    # reciprocal-margin semantics: the pair keeps at least the summed
    # radii apart at the crossing (safety ratio ≥ 1 == no collision)
    assert res["safety_ratio_agent"] >= 1.0
    assert np.isfinite(res["total_flight_time"])
    assert res["vel_excess_ratio"] == 0.0
    assert res["acc_excess_ratio"] == 0.0


def test_right_hand_deadlock_detour(tmp_path):
    """Exactly symmetric head-on swap: static goals deadlock at the
    midline; the right-hand rule must detect the deadlock (velocity
    threshold, traj_planner.cpp:904-923) and detour both agents
    clockwise past each other to completion."""
    m = generate_random_mission(2, [-4, -4, 0], [4, 4, 2.5], seed=1,
                                min_separation=2.0)
    m.agents[0].start = np.array([-2.0, 0.0, 0.6])
    m.agents[0].goal = np.array([2.0, 0.0, 0.6])
    m.agents[1].start = np.array([2.0, 0.0, 0.6])
    m.agents[1].goal = np.array([-2.0, 0.0, 0.6])
    p = _param(planner_mode=PlannerMode.LSC, goal_mode=GoalMode.RIGHT_HAND,
               multisim_max_planner_iteration=300)
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))

    detour_fired = False
    for it in range(300):
        if sim.is_finished():
            break
        if it > 0:
            sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()
        sim.save_simulation_result()
        # the detour goal is the cross-product rotation of the goal
        # direction (goal.py::right_hand_goal) — when the deadlock
        # trigger fires, current_goal departs from the straight-line
        # goal by a macroscopic offset
        if np.max(np.linalg.norm(sim.current_goal - sim.desired_goal,
                                 axis=-1)) > 0.5:
            detour_fired = True
    assert detour_fired, "right-hand detour never triggered"
    assert sim.is_finished(), "head-on pair did not resolve"
    assert not sim.is_collided
    assert sim.safety_ratio_agent >= 1.0


def test_goback_round_trip(tmp_path):
    """GOTO → GOBACK round trip (reference /stop_patrol service →
    GOBACK state): after flying toward the goals, the fleet must return
    to its start points and finish there."""
    m = generate_random_mission(2, [-3, -3, 0], [3, 3, 2.5], seed=11,
                                min_separation=2.5)
    p = _param(communication_range=3.0)  # default DR config
    sim = MultiSyncSimulator(p, m, log_dir=str(tmp_path))
    for it in range(30):
        if it > 0:
            sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()
        sim.save_simulation_result()
    mid = sim.pos.copy()
    assert np.all(np.linalg.norm(mid - sim.start_point, axis=-1) > 1.0), \
        "fleet did not leave its start area before GOBACK"

    sim.stop_patrol()  # → PlannerState.GOBACK
    finished = False
    for it in range(170):
        if sim.is_finished():
            finished = True
            break
        sim.do_step()
        sim.decentralized_mapp()
        assert sim.plan()
        sim.save_simulation_result()
    assert finished, "GOBACK never finished"
    d_start = np.linalg.norm(sim.pos - sim.start_point, axis=-1)
    assert np.all(d_start <= sim.param.goal_threshold)
    assert not sim.is_collided
