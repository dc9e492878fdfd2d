"""The per-step planning pipeline, batched over the whole fleet.

Capability parity with TrajPlanner::planImpl's six stages (reference:
src/traj_planner.cpp:117-139):

  1. obstacle prediction      (:225-358)   — previous-solution shift /
                                             const-vel / const-pos, with
                                             disturbance reset and
                                             max-acc size inflation
  2. initial trajectory       (:360-431)
  3. LSC construction         (:552-736)   — LSC / CLSC / BVC / RSFC
  4. SFC construction         (:571-579, collision_constraints.cpp)
  5. goal planning            (:433-550)   — static / right-hand /
                                             grid-based DR (closed-form
                                             goal LP)
  6. trajectory optimization  (:755-803)   — batched ADMM QP + failsafe

Everything below is ONE jitted function over fixed-shape arrays; agents
are the batch axis. The sequential per-agent loop of the reference
(multi_sync_simulator.cpp:354-374) disappears: all agents plan at once.
The MAPF waypoint layer runs host-side (see sim/) and feeds
`next_waypoint`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lsc_dr_planner_tpu.config import GoalMode, Param, PlannerMode
from lsc_dr_planner_tpu.ops import bernstein, lsc, qp, sfc, trajectory
from lsc_dr_planner_tpu.planner import goal as goalmod
from lsc_dr_planner_tpu.world.grid import GridWorld


class FleetArrays(NamedTuple):
    """Static per-agent attributes (device)."""

    radius: jnp.ndarray  # [A]
    downwash: jnp.ndarray  # [A]
    max_vel: jnp.ndarray  # [A, 3]
    max_acc: jnp.ndarray  # [A, 3]
    nominal_velocity: jnp.ndarray  # [A]


class StepInputs(NamedTuple):
    """Per-step dynamic inputs (device)."""

    pos: jnp.ndarray  # [A, 3]
    vel: jnp.ndarray  # [A, 3]
    acc: jnp.ndarray  # [A, 3]
    prev_ctrl: jnp.ndarray  # [A, M, N, 3] previous solutions
    has_prev: jnp.ndarray  # [A] bool (planner_seq >= 2)
    is_disturbed: jnp.ndarray  # [A] bool
    desired_goal: jnp.ndarray  # [A, 3]
    current_goal: jnp.ndarray  # [A, 3] (from previous step's goal planning)
    next_waypoint: jnp.ndarray  # [A, 3] (from the host MAPF layer)
    sfc_lo: jnp.ndarray  # [A, M, 3] int32 lattice boxes
    sfc_hi: jnp.ndarray  # [A, M, 3]
    sfc_initialized: jnp.ndarray  # [A] bool
    planner_seq: jnp.ndarray  # [] int32
    # dynamic obstacles (padded to OD slots)
    dynobs_pos: jnp.ndarray  # [OD, 3]
    dynobs_vel: jnp.ndarray  # [OD, 3]
    dynobs_radius: jnp.ndarray  # [OD]
    dynobs_downwash: jnp.ndarray  # [OD]
    dynobs_max_acc: jnp.ndarray  # [OD]
    dynobs_valid: jnp.ndarray  # [OD] bool
    # per-agent known occupancy [A, X, Y, Z] (local-sensing mode only;
    # None when world_use_global_map — the static world is jit-closed)
    occ_known: Optional[jnp.ndarray] = None
    # previous step's ADMM duals [A, R] (qp.n_rows rows; None = cold)
    qp_y0: Optional[jnp.ndarray] = None


class NeighborData(NamedTuple):
    """Per-agent neighbor tensors [A, OA, ...] — exactly the reference's
    broadcast Obstacle message fields (agent_manager.cpp:184-199).
    Normally built in-graph by `FleetPlanner._gather_neighbors` (global
    top-k); the §5.8 halo exchange (parallel/halo.py) builds it from
    spatially-tiled `ppermute` blocks instead and injects it."""

    prev_ctrl: jnp.ndarray  # [A, OA, M, N, 3]
    has_prev: jnp.ndarray  # [A, OA]
    pos: jnp.ndarray  # [A, OA, 3]
    vel: jnp.ndarray  # [A, OA, 3]
    radius: jnp.ndarray  # [A, OA]
    downwash: jnp.ndarray  # [A, OA]
    goal: jnp.ndarray  # [A, OA, 3]
    valid: jnp.ndarray  # [A, OA] bool


class DeferredQP(NamedTuple):
    """Stage 1–5 products + the assembled QP problem, returned by
    `_step_impl(..., defer_qp=True)` so a caller can batch the QP solve
    across an OUTER axis (Monte-Carlo flattens the scenario × agent axes
    into one so the straggler-rescue compaction spans the whole S·A
    batch instead of duplicating per scenario lane)."""

    qp_inp: "object"  # qp.QPInputs
    initial_ctrl: jnp.ndarray
    new_goal: jnp.ndarray
    new_sfc_lo: jnp.ndarray
    new_sfc_hi: jnp.ndarray
    obs_pred: jnp.ndarray


class StepOutputs(NamedTuple):
    desired_ctrl: jnp.ndarray  # [A, M, N, 3]
    current_goal: jnp.ndarray  # [A, 3]
    sfc_lo: jnp.ndarray  # [A, M, 3]
    sfc_hi: jnp.ndarray  # [A, M, 3]
    sfc_initialized: jnp.ndarray  # [A]
    qp_converged: jnp.ndarray  # [A]
    qp_residual: jnp.ndarray  # [A]
    qp_iterations: jnp.ndarray  # [A]
    obs_pred_ctrl: jnp.ndarray  # [A, O, M, N, 3]
    initial_ctrl: jnp.ndarray  # [A, M, N, 3]
    qp_y: Optional[jnp.ndarray] = None  # [A, R] duals — next warm start


class FleetPlanner:
    """Holds the static planner configuration and the jitted step fn."""

    def __init__(self, param: Param, world: GridWorld, n_agents: int,
                 max_dynobs: int = 0, agent_radius: float = 0.15,
                 max_vel_hint: float = 2.0):
        self.param = param
        self.world = world
        self.A = n_agents
        self.sfc_margin = agent_radius  # SFC margin compensation (static)
        # SFC expansion clamp: corridor boxes persist M shift steps, so a
        # box built now can still bound control points up to
        # 3·M·dt·v_max away from its seed (horizon reach when built +
        # agent drift over its lifetime + horizon reach of the new plan;
        # Bernstein velocity rows bound each term). Growth beyond that
        # is physically non-binding — a 2·reach clamp was measured to
        # flip chaotic dense-maze missions, this bound does not.
        # Clamping bounds the expansion while-loop's trips independent
        # of world size (the scaling term on large worlds).
        self.sfc_expand_cells = int(
            np.ceil((3.0 * param.M * param.dt * max_vel_hint + 1.0)
                    / param.world_resolution)
        )
        # neighbor slots: other agents + dynamic obstacles
        self.O_agents = min(n_agents - 1, param.max_obstacles)
        self.OD = max_dynobs
        self.O = self.O_agents + self.OD
        if self.O == 0:
            self.O = 1  # keep shapes non-degenerate

        p = param
        self.qp_cfg = qp.QPConfig(
            dim=p.world_dimension,
            M=p.M,
            n=p.n,
            phi=p.phi,
            n_obs=self.O,
            use_comm=p.communication_range > 0,
            stop_at_horizon=(p.planner_mode == PlannerMode.LSC),
            dt=p.dt,
            control_input_weight=p.control_input_weight,
            terminal_weight=p.terminal_weight,
            rho=p.qp_rho,
            rho_eq=p.qp_rho_eq,
            sigma=p.qp_sigma,
            alpha=p.qp_alpha,
            max_iter=p.qp_max_iter,
            eps_abs=p.qp_eps_abs,
            rescue_iter=p.qp_rescue_iter,
        )
        self._step = jax.jit(self._step_impl)
        self._prefix_steps = {}  # stop_after -> jitted prefix fn
        self.debug = False  # eager mode: stash intermediates on self._dbg
        self._dbg = {}

    # ==================================================================
    def step(self, fleet: FleetArrays, inp: StepInputs) -> StepOutputs:
        if self.debug:
            return self._step_impl(fleet, inp)
        return self._step(fleet, inp)

    # ==================================================================
    def measure_stage_times(self, fleet: FleetArrays, inp: StepInputs,
                            repeats: int = 3):
        """Per-stage wall times by compiled prefix differences. Returns a
        dict of stage name → seconds (parity with the reference's 8-stage
        statistics, sp_const.hpp:108-128)."""
        import time as _time

        names = {1: "obstacle_prediction", 2: "initial_traj", 3: "lsc",
                 4: "sfc", 5: "goal", 0: "total"}
        prefix_t = {}
        for k in (1, 2, 3, 4, 5, 0):
            if k not in self._prefix_steps:
                self._prefix_steps[k] = jax.jit(
                    functools.partial(self._step_impl, stop_after=k)
                )
            fn = self._prefix_steps[k]
            out = fn(fleet, inp)  # warm-up/compile
            jax.tree_util.tree_map(
                lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x,
                out)
            t0 = _time.perf_counter()
            for _ in range(repeats):
                out = fn(fleet, inp)
            jax.tree_util.tree_map(
                lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x,
                out)
            prefix_t[k] = (_time.perf_counter() - t0) / repeats

        stages = {}
        prev = 0.0
        for k in (1, 2, 3, 4, 5):
            stages[names[k]] = max(prefix_t[k] - prev, 0.0)
            prev = prefix_t[k]
        stages["traj_opt"] = max(prefix_t[0] - prev, 0.0)
        stages["total"] = prefix_t[0]
        return stages

    # ==================================================================
    def _neighbor_slots(self, inp: StepInputs, fleet: FleetArrays):
        """Build per-agent neighbor tensors [A, O, ...]: the OA nearest
        other agents within L∞ communication range, then dynamic
        obstacles (always visible — reference broadcastMsgs sends all
        dynamic obstacles regardless of range,
        multi_sync_simulator.cpp:311-318; agents filtered by range
        :320-333)."""
        p = self.param
        A, OA, OD = inp.pos.shape[0], self.O_agents, self.OD
        pos = inp.pos
        dist = jnp.max(jnp.abs(pos[:, None] - pos[None, :]), axis=-1)  # [A, A]
        dist = dist + jnp.eye(A) * 1e9
        in_range = (
            dist < p.communication_range
            if p.communication_range > 0
            else jnp.ones_like(dist, dtype=bool)
        )
        dist = jnp.where(in_range, dist, 1e9)
        # top-k nearest instead of a full argsort: O(A²·log k) work and
        # no [A, A] permutation materialization — the argsort was the
        # scaling wall toward 10⁴+ agents
        neg_top, order = jax.lax.top_k(-dist, OA)  # [A, OA] nearest first
        valid = -neg_top < 1e8

        def gather(x):
            return x[order]  # [A, OA, ...]

        return order, valid, gather

    # ==================================================================
    def _gather_neighbors(self, fleet: FleetArrays,
                          inp: StepInputs) -> NeighborData:
        """Global top-k neighbor gather (single-device / all-gather
        path). The halo exchange (parallel/halo.py) replaces this with
        spatially-tiled ppermute blocks."""
        order, valid, _ = self._neighbor_slots(inp, fleet)
        return NeighborData(
            prev_ctrl=inp.prev_ctrl[order],
            has_prev=inp.has_prev[order],
            pos=inp.pos[order],
            vel=inp.vel[order],
            radius=fleet.radius[order],
            downwash=fleet.downwash[order],
            goal=inp.current_goal[order],
            valid=valid,
        )

    # ==================================================================
    def _step_impl(self, fleet: FleetArrays, inp: StepInputs,
                   stop_after: int = 0,
                   neighbors: Optional[NeighborData] = None,
                   defer_qp: bool = False) -> StepOutputs:
        # stop_after > 0: return a checksum after pipeline stage k — used
        # by measure_stage_times() for prefix-difference stage timing
        p = self.param
        A, O, OA, OD = inp.pos.shape[0], self.O, self.O_agents, self.OD
        M, n, N, phi = p.M, p.n, p.n + 1, p.phi
        dt = p.dt
        f32 = jnp.float32

        nd = (
            neighbors if neighbors is not None
            else self._gather_neighbors(fleet, inp)
        )
        agent_valid = nd.valid

        # ---------- stage 1: obstacle prediction --------------------------
        # agent neighbors: previous-solution shift (LSC family) or const-vel
        nbr_prev = nd.prev_ctrl  # [A, OA, M, N, 3]
        nbr_has_prev = nd.has_prev
        nbr_pos = nd.pos
        nbr_vel = nd.vel

        if p.planner_mode in (PlannerMode.DLSC, PlannerMode.LSC):
            if p.multisim_time_step == p.dt:
                shifted = trajectory.shift_one_segment(nbr_prev)
            else:
                shifted = trajectory.subsegment_first(
                    nbr_prev, p.multisim_time_step / p.dt
                )
            const_vel = trajectory.const_vel_ctrl(nbr_pos, nbr_vel, M, n, dt)
            agent_pred = jnp.where(
                nbr_has_prev[..., None, None, None], shifted, const_vel
            )
        elif p.planner_mode == PlannerMode.BVC:
            agent_pred = trajectory.const_vel_ctrl(
                nbr_pos, jnp.zeros_like(nbr_vel), M, n, dt
            )
        else:  # RSFC / circle test: constant velocity
            agent_pred = trajectory.const_vel_ctrl(nbr_pos, nbr_vel, M, n, dt)

        # disturbance reset: prediction must start at the observed position
        pred_err = jnp.linalg.norm(
            agent_pred[..., 0, 0, :] - nbr_pos, axis=-1
        )
        reset = pred_err > p.reset_threshold
        hold = trajectory.const_vel_ctrl(nbr_pos, jnp.zeros_like(nbr_vel), M, n, dt)
        agent_pred = jnp.where(reset[..., None, None, None], hold, agent_pred)

        # dynamic obstacles: constant-velocity prediction, broadcast to all
        if OD > 0:
            dyn_pred = trajectory.const_vel_ctrl(
                inp.dynobs_pos, inp.dynobs_vel, M, n, dt
            )  # [OD, M, N, 3]
            dyn_pred = jnp.broadcast_to(dyn_pred[None], (A, OD, M, N, 3))
            obs_pred = jnp.concatenate([agent_pred, dyn_pred], axis=1)
            obs_valid = jnp.concatenate(
                [agent_valid, jnp.broadcast_to(inp.dynobs_valid[None], (A, OD))],
                axis=1,
            )
            obs_is_agent = jnp.concatenate(
                [jnp.ones((A, OA), bool), jnp.zeros((A, OD), bool)], axis=1
            )
            obs_radius = jnp.concatenate(
                [nd.radius,
                 jnp.broadcast_to(inp.dynobs_radius[None], (A, OD))], axis=1)
            obs_downwash = jnp.concatenate(
                [nd.downwash,
                 jnp.broadcast_to(inp.dynobs_downwash[None], (A, OD))], axis=1)
            obs_max_acc = jnp.concatenate(
                [jnp.zeros((A, OA), f32),
                 jnp.broadcast_to(inp.dynobs_max_acc[None], (A, OD))], axis=1)
            obs_pos_now = jnp.concatenate(
                [nbr_pos, jnp.broadcast_to(inp.dynobs_pos[None], (A, OD, 3))],
                axis=1)
            obs_goal = jnp.concatenate(
                [nd.goal,
                 jnp.broadcast_to(inp.dynobs_pos[None], (A, OD, 3))], axis=1)
        else:
            obs_pred = agent_pred
            obs_valid = agent_valid
            obs_is_agent = jnp.ones((A, OA), bool)
            obs_radius = nd.radius
            obs_downwash = nd.downwash
            obs_max_acc = jnp.zeros((A, OA), f32)
            obs_pos_now = nbr_pos
            obs_goal = nd.goal
            if self.O > OA:  # degenerate padding slot
                pad = self.O - OA

                def padcat(x, fill=0.0):
                    shp = (A, pad) + x.shape[2:]
                    return jnp.concatenate(
                        [x, jnp.full(shp, fill, x.dtype)], axis=1
                    )

                obs_pred = padcat(obs_pred)
                obs_valid = padcat(obs_valid, False)
                obs_is_agent = padcat(obs_is_agent, False)
                obs_radius = padcat(obs_radius, 0.1)
                obs_downwash = padcat(obs_downwash, 1.0)
                obs_max_acc = padcat(obs_max_acc)
                obs_pos_now = padcat(obs_pos_now)
                obs_goal = padcat(obs_goal)

        # size prediction with const-acc uncertainty (dynamic obstacles
        # only in LSC modes; reference traj_planner.cpp:321-358)
        growth = jnp.asarray(
            _uncertainty_growth_table(n, dt, p.obs_uncertainty_horizon, M), f32
        )  # [M, N] (per unit max_acc)
        vel_guard = jnp.where(
            p.use_velocity_guard,
            p.velocity_guard_ratio
            * jnp.sum(inp.vel**2, axis=-1)
            / fleet.max_acc[:, 0],
            0.0,
        )  # [A]
        inflate = (
            p.obs_size_prediction
            and p.planner_mode != PlannerMode.BVC
        )
        size_base = obs_radius[..., None, None] * jnp.ones((A, self.O, M, N), f32)
        if inflate:
            grown = (
                size_base
                + vel_guard[:, None, None, None]
                + obs_max_acc[..., None, None] * growth[None, None]
            )
            use_growth = (
                jnp.logical_not(obs_is_agent)
                | (p.planner_mode == PlannerMode.RECIPROCAL_RSFC)
            )
            obs_pred_sizes = jnp.where(
                use_growth[..., None, None], grown, size_base
            )
        else:
            obs_pred_sizes = size_base

        if stop_after == 1:
            return jnp.sum(obs_pred) + jnp.sum(obs_pred_sizes)

        # ---------- stage 2: initial trajectory ---------------------------
        if p.planner_mode in (PlannerMode.DLSC, PlannerMode.LSC):
            if p.multisim_time_step == p.dt:
                own_shift = trajectory.shift_one_segment(inp.prev_ctrl)
            else:
                own_shift = trajectory.subsegment_first(
                    inp.prev_ctrl, p.multisim_time_step / p.dt
                )
            own_cv = trajectory.const_vel_ctrl(inp.pos, inp.vel, M, n, dt)
            initial_ctrl = jnp.where(
                inp.has_prev[..., None, None, None], own_shift, own_cv
            )
        elif p.planner_mode == PlannerMode.BVC:
            initial_ctrl = trajectory.const_vel_ctrl(
                inp.pos, jnp.zeros_like(inp.vel), M, n, dt
            )
        else:
            initial_ctrl = trajectory.const_vel_ctrl(inp.pos, inp.vel, M, n, dt)

        hold_self = trajectory.const_vel_ctrl(
            inp.pos, jnp.zeros_like(inp.vel), M, n, dt
        )
        initial_ctrl = jnp.where(
            inp.is_disturbed[..., None, None, None], hold_self, initial_ctrl
        )

        if stop_after == 2:
            return jnp.sum(initial_ctrl)

        # ---------- stage 3: LSC construction -----------------------------
        if p.planner_mode in (PlannerMode.DLSC, PlannerMode.LSC):
            # CLSC whenever the DR waypoint layer drives the goals: the
            # layer's deadlock-freedom argument rests on the goal-aware
            # CLSC margins. The reference dispatches CLSC only for
            # LSC+grid_based (traj_planner.cpp:556-559) because its DLSC
            # experiments never ran the DR layer (open worlds, static /
            # prior goals); DLSC+DR with plain LSC wedges measurably
            # (forest10_2: goal LPs pin against neighbor predictions and
            # the fleet livelocks at ~t=15 s).
            if p.goal_mode == GoalMode.GRID_BASED_PLANNER:
                ls = lsc.build_clsc(
                    initial_ctrl, obs_pred, obs_goal,
                    fleet.radius, fleet.downwash, obs_radius, obs_downwash,
                    obs_is_agent, inp.current_goal, obs_valid,
                    p.world_dimension,
                )
            else:
                ls = lsc.build_lsc(
                    initial_ctrl, obs_pred, obs_pred_sizes,
                    fleet.radius, fleet.downwash, obs_radius, obs_downwash,
                    obs_is_agent, obs_pos_now, inp.current_goal, obs_valid,
                )
        elif p.planner_mode == PlannerMode.BVC:
            ls = lsc.build_bvc(
                initial_ctrl, obs_pred,
                fleet.radius, fleet.downwash, obs_radius, obs_downwash,
                obs_is_agent, obs_valid,
            )
        else:
            ls = lsc.build_reciprocal_rsfc(
                initial_ctrl, obs_pred, obs_pred_sizes,
                fleet.radius, fleet.downwash, obs_radius, obs_downwash,
                obs_is_agent, obs_valid,
            )

        if stop_after == 3:
            return jnp.sum(ls.normals) + jnp.sum(ls.margins)

        # ---------- stage 4: SFC construction -----------------------------
        gw = self.world
        substep = (
            p.planner_mode == PlannerMode.DLSC
            and p.multisim_time_step != p.dt
        )
        if p.world_use_octomap:
            def update_sfc(args, occ_a=None):
                slo, shi, init_done, last_pt, cgoal, wpt, pos, ictrl = args
                if occ_a is None:
                    gw_a = gw
                else:
                    # local-sensing mode: per-agent EDT analog rebuilt on
                    # device from the agent's known occupancy (reference
                    # distmap_ptr->update(), map_manager.cpp:118-119)
                    from lsc_dr_planner_tpu.world.grid import (
                        blocked_cumsum_jnp, local_grid_world,
                    )
                    blk, S = blocked_cumsum_jnp(
                        occ_a, gw.resolution, gw.radius
                    )
                    gw_a = local_grid_world(gw, occ_a, blk, S)
                # fused update: init + shift/rebuild expansions run as
                # LANES of one batched greedy loop (max- instead of
                # sum-of-trips; ops/sfc.py::update_sfc_fused reproduces
                # the sequential composition exactly)
                mode = (
                    "substep" if substep
                    else "hull" if p.goal_mode == GoalMode.GRID_BASED_PLANNER
                    else "point"
                )
                return sfc.update_sfc_fused(
                    gw_a, mode, slo, shi, init_done, last_pt, cgoal,
                    wpt, pos, ictrl, self.sfc_margin,
                    max_radius_cells=self.sfc_expand_cells,
                )

            sfc_args = (
                inp.sfc_lo, inp.sfc_hi,
                inp.sfc_initialized & jnp.logical_not(inp.is_disturbed),
                trajectory.last_point(initial_ctrl),
                inp.current_goal, inp.next_waypoint, inp.pos,
                initial_ctrl,
            )
            if inp.occ_known is None:
                new_sfc_lo, new_sfc_hi = jax.vmap(update_sfc)(sfc_args)
            else:
                new_sfc_lo, new_sfc_hi = jax.vmap(update_sfc)(
                    sfc_args, inp.occ_known
                )
            sfc_lo_w, sfc_hi_w = sfc.sfc_to_world(
                gw, new_sfc_lo, new_sfc_hi, self.sfc_margin
            )
        else:
            new_sfc_lo, new_sfc_hi = inp.sfc_lo, inp.sfc_hi
            big = 1e9
            sfc_lo_w = jnp.full((A, M, 3), -big, f32)
            sfc_hi_w = jnp.full((A, M, 3), big, f32)

        if stop_after == 4:
            return jnp.sum(sfc_lo_w) + jnp.sum(sfc_hi_w)

        # ---------- stage 5: goal planning --------------------------------
        dim = p.world_dimension
        if p.goal_mode == GoalMode.GRID_BASED_PLANNER:
            new_goal, _infeas = goalmod.goal_lp(
                inp.current_goal, inp.next_waypoint,
                ls.normals[:, :, M - 1, :],
                ls.anchors[:, :, M - 1, N - 1, :],
                ls.margins[:, :, M - 1, N - 1],
                obs_valid,
                sfc_lo_w[:, M - 1], sfc_hi_w[:, M - 1],
                dim, use_sfc=p.world_use_octomap,
            )
        elif p.goal_mode == GoalMode.RIGHT_HAND:
            dl = goalmod.is_deadlock(
                inp.planner_seq, inp.vel, inp.pos, inp.desired_goal,
                p.deadlock_velocity_threshold, p.deadlock_seq_threshold,
            )
            new_goal = goalmod.right_hand_goal(inp.pos, inp.desired_goal, dl)
        elif p.goal_mode in (GoalMode.PRIOR_BASED, GoalMode.DYNAMIC_PRIORITY):
            # host-computed goals (planner/priority.py) arrive via current_goal
            new_goal = inp.current_goal
        else:  # STATIC
            new_goal = inp.desired_goal

        # disturbed agents hold position as goal (traj_planner.cpp:437-440)
        new_goal = jnp.where(
            inp.is_disturbed[..., None], inp.pos, new_goal
        )

        if stop_after == 5:
            return jnp.sum(new_goal)

        # ---------- stage 6: trajectory optimization ----------------------
        # terminal segments from the nominal-velocity flight-time heuristic
        # (reference getTerminalSegments_old, traj_optimizer.cpp:530-538)
        dist_goal = jnp.linalg.norm(new_goal - inp.pos, axis=-1)
        ift = dist_goal / fleet.nominal_velocity
        tseg = jnp.maximum(
            jnp.floor((M * dt - ift + 1e-9) / dt).astype(jnp.int32), 1
        )
        seg_idx = jnp.arange(M)[None, :]
        terminal_mask = (seg_idx >= (M - tseg[:, None])).astype(f32)

        # LSC rows (dim-restricted dot products, reference
        # traj_optimizer.cpp:399-437). Empty neighbour slots get zero
        # normals: their rows are inactive, but a normal left in them
        # would still enter the KKT matrix, making the iterates depend on
        # whichever agent filled the slot (it differs between the global
        # gather and the halo exchange).
        nrm = jnp.where(obs_valid[..., None, None], ls.normals[..., :dim], 0.0)
        # qp_safety_margin: tiny margin inflation so that solutions within
        # the ADMM feasibility tolerance still certify true separation
        # (the reference's simplex solutions are exact; ours are ε-accurate).
        # Sub-step (DLSC) replanning adds a few mm: the seg-0 time
        # dilation of the predictions shifts the pairwise point
        # correspondence within the first segment by O(ts/dt) of the
        # per-step drift (measured 0.6 mm grazing on forest10_2 DLSC).
        # In sub-step mode the margin is sized ABOVE the (loosened)
        # feasibility gate: accepted ε-solutions then still certify true
        # separation. CLSC's crowded sub-step instances stall at an ADMM
        # floor of ~7e-3 — rejecting those 99%-feasible plans into the
        # failsafe froze whole missions (maze10_sparse DLSC).
        qp_margin = 1e-2 if substep else 1e-3
        rhs = (
            jnp.einsum("aomd,aomnd->aomn", nrm, ls.anchors[..., :dim])
            + ls.margins
            + qp_margin
        )
        nnorm = jnp.linalg.norm(ls.normals, axis=-1)
        active = obs_valid[..., None, None] & (nnorm > 1e-6)[..., None]
        active = jnp.broadcast_to(active, (A, self.O, M, N))
        active = active.at[:, :, 0, :phi].set(False)

        # variable bounds: world ∩ SFC (+ waypoint comm box on segment ends)
        wmin = jnp.asarray(self.world.world_min[:dim], f32)
        wmax = jnp.asarray(self.world.world_max[:dim], f32)
        lb = jnp.broadcast_to(wmin[None, :, None, None], (A, dim, M, N))
        ub = jnp.broadcast_to(wmax[None, :, None, None], (A, dim, M, N))
        if p.world_use_octomap:
            lb = jnp.maximum(lb, sfc_lo_w[..., :dim].transpose(0, 2, 1)[:, :, :, None])
            ub = jnp.minimum(ub, sfc_hi_w[..., :dim].transpose(0, 2, 1)[:, :, :, None])
        if p.communication_range > 0:
            wp = inp.next_waypoint[..., :dim]
            half = 0.5 * p.communication_range - 1e-6
            lb = lb.at[..., N - 1].set(
                jnp.maximum(lb[..., N - 1], (wp - half)[:, :, None])
            )
            ub = ub.at[..., N - 1].set(
                jnp.minimum(ub[..., N - 1], (wp + half)[:, :, None])
            )

        if self.debug:
            self._dbg = dict(
                ls=ls, obs_valid=obs_valid, obs_pred=obs_pred,
                sfc_lo_w=sfc_lo_w, sfc_hi_w=sfc_hi_w, new_goal=new_goal,
                initial_ctrl=initial_ctrl, nd=nd, lb=lb, ub=ub,
                terminal_mask=terminal_mask, rhs=rhs, active=active,
            )

        qp_inp = qp.QPInputs(
            p0=inp.pos[:, :dim].astype(f32),
            v0=inp.vel[:, :dim].astype(f32),
            a0=inp.acc[:, :dim].astype(f32),
            goal=new_goal[:, :dim].astype(f32),
            terminal_mask=terminal_mask,
            lsc_normals=nrm.astype(f32),
            lsc_rhs=rhs.astype(f32),
            lsc_active=active,
            vmax=fleet.max_vel[:, :dim].astype(f32),
            amax=fleet.max_acc[:, :dim].astype(f32),
            lb=lb,
            ub=ub,
            comm_halfrange=(
                jnp.full((A,), 0.5 * p.communication_range, f32) - fleet.radius
                if p.communication_range > 0
                else jnp.full((A,), 1e19, f32)
            ),
            x0=initial_ctrl[..., :dim].transpose(0, 3, 1, 2).astype(f32),
            y0=(
                # duals only carry over when the problem is a shifted
                # continuation of last step's (fresh or disturbed agents
                # cold-start)
                inp.qp_y0
                * (inp.has_prev & ~inp.is_disturbed)[:, None].astype(f32)
                if inp.qp_y0 is not None and p.qp_warm_start_duals
                else None
            ),
        )
        deferred = DeferredQP(
            qp_inp=qp_inp,
            initial_ctrl=initial_ctrl,
            new_goal=new_goal,
            new_sfc_lo=new_sfc_lo,
            new_sfc_hi=new_sfc_hi,
            obs_pred=jnp.where(obs_valid[..., None, None, None], obs_pred, 0.0),
        )
        if defer_qp:
            return deferred
        out = qp.solve(self.qp_cfg, qp_inp, feas_tol=self.feas_tol)
        return self.finish_step(out, deferred)

    # ==================================================================
    @property
    def feas_tol(self) -> float:
        """QP feasibility gate: loosened in DLSC sub-step mode (crowded
        CLSC instances stall at an ADMM floor ~7e-3; the enlarged
        qp_margin still certifies true separation — see stage 6)."""
        p = self.param
        substep = (
            p.planner_mode == PlannerMode.DLSC
            and p.multisim_time_step != p.dt
        )
        return 8e-3 if substep else 5e-3

    # ==================================================================
    def finish_step(self, out, d: DeferredQP) -> StepOutputs:
        """Post-QP assembly: 3-D control points + the reference's
        failsafe (keep the initial trajectory on non-convergence,
        traj_planner.cpp:795-797)."""
        p = self.param
        A, M, N = d.initial_ctrl.shape[0], p.M, p.n + 1
        f32 = jnp.float32
        desired = out.x.transpose(0, 2, 3, 1)  # [A, M, N, dim]
        if p.world_dimension == 2:
            z = jnp.full((A, M, N, 1), p.world_z_2d, f32)
            desired = jnp.concatenate([desired, z], axis=-1)
        desired = jnp.where(
            out.converged[..., None, None, None], desired, d.initial_ctrl
        )

        return StepOutputs(
            desired_ctrl=desired,
            current_goal=d.new_goal,
            sfc_lo=d.new_sfc_lo,
            sfc_hi=d.new_sfc_hi,
            sfc_initialized=jnp.ones((A,), bool),
            qp_converged=out.converged,
            qp_residual=out.primal_residual,
            qp_iterations=out.iterations,
            obs_pred_ctrl=d.obs_pred,
            initial_ctrl=d.initial_ctrl,
            qp_y=out.y,
        )


@functools.lru_cache(maxsize=None)
def _uncertainty_growth_table(n: int, dt: float, horizon: float, M: int):
    """Per-segment Bernstein control points of ½·(t)² growth (unit max
    acc): [M, n+1]. Reference: obstacleSizePredictionWithConstAcc,
    src/traj_planner.cpp:321-358."""
    M_unc = int((horizon + 1e-9) / dt)
    out = np.zeros((M, n + 1))
    for m in range(M):
        if m < M_unc:
            out[m] = bernstein.uncertainty_growth_ctrl(n, dt, 1.0, m)
        else:
            out[m] = 0.5 * (M_unc * dt) ** 2
    return out
