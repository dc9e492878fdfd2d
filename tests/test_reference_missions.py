"""Reference-benchmark regression tests.

End-to-end runs of the reference repo's own benchmark missions
(missions/forest10, missions/maze10_dense) asserting the reference's
pass criteria — safety ratio ≥ 1, zero velocity/acceleration excess,
finite flight time under an explicit bound (SURVEY §4: a summary row
with those properties is a "pass"; baselines
/root/reference/log/summary_LSC_10agents.csv:2-3) — plus an audit
parity check that replays the reference's committed simulation CSV and
reproduces its logged safety ratio with this repo's safety math.
"""

import os
import tempfile

import numpy as np
import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference tree not available"
)


def _run_mission(mission_file, world_file, max_iter=600):
    from lsc_dr_planner_tpu.config import Param
    from lsc_dr_planner_tpu.mission import Mission
    from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator

    param = Param(
        world_dimension=2, world_use_octomap=True, communication_range=3.0,
        multisim_save_result=False,
        multisim_max_planner_iteration=max_iter,
    )
    mission = Mission.load(
        mission_file, world_file=world_file,
        world_dimension=2, world_z_2d=param.world_z_2d,
    )
    sim = MultiSyncSimulator(param, mission, log_dir=tempfile.mkdtemp())
    return sim.run()


@pytest.mark.slow
def test_forest10_10_end_to_end():
    """forest10_10: the mission behind the reference's committed
    forest10 summary row (flight time 15.8 s)."""
    r = _run_mission(
        f"{REF}/missions/forest10/forest10_10.json",
        f"{REF}/world/forest/forest10.csv",
        max_iter=200,
    )
    assert not r["is_collided"]
    assert not r["qp_failed"]
    assert r["safety_ratio_agent"] >= 1.0
    assert r["vel_excess_ratio"] == 0.0
    assert r["acc_excess_ratio"] == 0.0
    assert np.isfinite(r["total_flight_time"])
    # reference: 15.8 s; this repo matches it exactly (committed
    # benchmark row, log/benchmark/forest10.jsonl) — the bound holds
    # quality within 10% of the reference
    assert r["total_flight_time"] <= 17.5


@pytest.mark.slow
def test_maze10_1_dense_end_to_end():
    """maze10_1: the mission behind the reference's committed
    maze10_dense summary row (flight time 51.2 s)."""
    r = _run_mission(
        f"{REF}/missions/maze10_dense/maze10_1.json",
        f"{REF}/world/maze/dense/maze1.csv",
        max_iter=450,
    )
    assert not r["is_collided"]
    assert not r["qp_failed"]
    assert r["safety_ratio_agent"] >= 1.0
    assert r["vel_excess_ratio"] == 0.0
    assert r["acc_excess_ratio"] == 0.0
    assert np.isfinite(r["total_flight_time"])
    # reference: 51.2 s; this repo beats it at 48.4 s (committed
    # benchmark row, log/benchmark/maze10_dense.jsonl) — the bound
    # holds quality within ~7% of the reference
    assert r["total_flight_time"] <= 55.0


def test_reference_log_audit_parity():
    """Replay the reference's committed simulation CSV and re-audit it
    with this repo's ellipsoidal safety math; must reproduce the
    reference's own logged min safety ratio (1.021, forest10 row of
    summary_LSC_10agents.csv) to within interpolation error."""
    from lsc_dr_planner_tpu.sim.replay import read_csv

    log = read_csv(
        f"{REF}/log/simulation_1663743693.650981_LSC_10agents.csv"
    )
    assert log.qn == 10

    # reference quadrotor table (crazyflie): radius 0.15, downwash 2.0
    r = np.full(log.qn, 0.15)
    dw = np.full(log.qn, 2.0)
    dw_pair = (dw[:, None] * r[:, None] + dw[None, :] * r[None, :]) / (
        r[:, None] + r[None, :]
    )
    min_ratio = np.inf
    for t in range(len(log.times)):
        pos = log.agent_states[t, :, :3]
        diff = pos[:, None] - pos[None, :]
        dist = np.sqrt(
            diff[..., 0] ** 2
            + diff[..., 1] ** 2
            + (diff[..., 2] / dw_pair) ** 2
        )
        ratio = dist / (r[:, None] + r[None, :])
        np.fill_diagonal(ratio, np.inf)
        min_ratio = min(min_ratio, ratio.min())

    # summary_LSC_10agents.csv:2 logs safety_ratio_agent = 1.02144
    assert min_ratio == pytest.approx(1.02144, abs=0.02)


@pytest.mark.slow
def test_forest10_10_dlsc_substep_end_to_end(tmp_path):
    """DLSC sub-step replanning (ts=0.1 < dt=0.2) on the reference's
    forest10 headline mission: collision-free, zero excess, and flight
    time at least matching the LSC result (measured 15.3 s vs LSC's
    reference-equal 15.8 s)."""
    from lsc_dr_planner_tpu.config import Param, PlannerMode
    from lsc_dr_planner_tpu.mission import Mission
    from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator

    param = Param(
        world_dimension=2, world_use_octomap=True, communication_range=3.0,
        multisim_save_result=False, multisim_max_planner_iteration=400,
        planner_mode=PlannerMode.DLSC, multisim_time_step=0.1,
        profile_stages=False,
    )
    mission = Mission.load(
        f"{REF}/missions/forest10/forest10_10.json",
        world_file=f"{REF}/world/forest/forest10.csv",
        world_dimension=2, world_z_2d=param.world_z_2d,
    )
    sim = MultiSyncSimulator(param, mission, log_dir=str(tmp_path))
    r = sim.run()
    assert not r["is_collided"]
    assert not r["qp_failed"]
    assert r["safety_ratio_agent"] >= 1.0
    assert r["vel_excess_ratio"] == 0.0
    assert r["acc_excess_ratio"] == 0.0
    assert r["total_flight_time"] <= 17.5
