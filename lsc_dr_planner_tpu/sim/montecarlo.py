"""Monte-Carlo scenario batching: S scenarios planned in one device call.

The reference runs mission files strictly sequentially
(multi_sync_simulator_node.cpp:44-75) and its only stochastic knob is
the start/goal noise (mission.cpp:410-420). Batched design for the
pod-scale config (BASELINE.json: "1024 agents × 256 scenarios"):

  * ONE set of preprocessed statics — rasterized world, coarse MAPF
    grids, fleet planner — shared by every replica
    (MultiSyncSimulator(share_static_from=...)); a replica owns only
    its mutable per-scenario arrays. The r2 design deep-copied the
    whole simulator per scenario.
  * The device step is vmapped over the scenario axis; step inputs are
    numpy host-side, stacked once, and shipped in a single device_put
    (optionally sharded over a 'scenarios' mesh axis).
  * The host MAPF/waypoint layer runs scenarios through a thread pool:
    the native C++ solvers release the GIL during their ctypes calls,
    so solver work overlaps across scenarios; the remaining pure-Python
    gate bookkeeping is light.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import jax
import numpy as np

from lsc_dr_planner_tpu.config import Param
from lsc_dr_planner_tpu.mission import Mission
from lsc_dr_planner_tpu.sim.simulator import MultiSyncSimulator


class MonteCarloSimulator:
    """Runs S scenario replicas in lockstep with a scenario-vmapped
    planning step. All scenarios share one world/mission shape; goals
    are perturbed per scenario (`max_noise`, seeded)."""

    def __init__(self, param: Param, mission: Mission, n_scenarios: int,
                 max_noise: float = 0.25, log_dir: str = "log", seed: int = 0,
                 mesh=None, host_workers: Optional[int] = None):
        """`mesh`: optional jax.sharding.Mesh with a 'scenarios' axis —
        the stacked scenario batch is sharded across its devices, so S
        replicas split over the chips (the pod-scale Monte-Carlo axis,
        BASELINE '1024 agents × 256 scenarios')."""
        self.S = n_scenarios
        self.mesh = mesh
        base = MultiSyncSimulator(param, mission, log_dir=log_dir,
                                  seed=seed, save_result=False)
        self.sims: List[MultiSyncSimulator] = [base]
        for s in range(1, n_scenarios):
            m = copy.deepcopy(mission)
            if max_noise > 0:
                m.add_noise(max_noise, param.world_dimension, seed=seed + s)
            self.sims.append(MultiSyncSimulator(
                param, m, log_dir=log_dir, seed=seed + s, save_result=False,
                share_static_from=base,
            ))
        self.planner = base.planner

        # Scenario-batched step: stages 1–5 are vmapped per scenario,
        # then the QP batch is FLATTENED to one S·A agent axis for a
        # single qp.solve — the straggler-rescue masked compaction then
        # spans the whole flattened batch (one 64-agent rescue per device
        # call) instead of duplicating its working set per vmap lane,
        # which ran one card out of memory at S=8 × A=1024 (Monte-Carlo
        # runs must not rely on the silent failsafe for stragglers).
        from functools import partial

        from lsc_dr_planner_tpu.ops import qp as qpmod

        def chunk_step(fleet, binp):
            d = jax.vmap(
                partial(self.planner._step_impl, defer_qp=True),
                in_axes=(None, 0),
            )(fleet, binp)
            S, A = d.initial_ctrl.shape[:2]
            flat = jax.tree_util.tree_map(
                lambda x: x.reshape((S * A,) + x.shape[2:]), d.qp_inp
            )
            out = qpmod.solve(
                self.planner.qp_cfg, flat, feas_tol=self.planner.feas_tol
            )
            out = jax.tree_util.tree_map(
                lambda x: x.reshape((S, A) + x.shape[1:]), out
            )
            return jax.vmap(self.planner.finish_step)(out, d)

        def vstep_impl(fleet, binp):
            # bounded memory: past 32 replicas, run 32-wide chunks
            # sequentially (same aggregate throughput; the working set
            # grows linearly in S). Bucket sizes are powers of two, so
            # B > 32 always divides evenly.
            B = binp.pos.shape[0]
            if B <= 32:
                return chunk_step(fleet, binp)
            chunked = jax.tree_util.tree_map(
                lambda x: x.reshape((B // 32, 32) + x.shape[1:]), binp
            )
            outs = jax.lax.map(lambda c: chunk_step(fleet, c), chunked)
            return jax.tree_util.tree_map(
                lambda x: x.reshape((B,) + x.shape[2:]), outs
            )

        self._vstep = jax.jit(vstep_impl)
        self.fleet = base.fleet
        self._pool = ThreadPoolExecutor(
            max_workers=host_workers or min(n_scenarios,
                                            (os.cpu_count() or 2) * 2)
        )
        # last-step phase wall times (host MAPF / stack+transfer /
        # device / apply) — the pod-scale planning surface
        self.phase_times = {}
        # last-step fleet-wide QP convergence over active lanes
        self.last_qp_convergence = 1.0

    # ------------------------------------------------------------------
    def step(self, iteration: int) -> None:
        """One lockstep iteration over the scenarios still flying.

        Finished replicas are dropped from BOTH phases (host MAPF and
        the device batch): at S=256 with heterogeneous finish times,
        planning finished scenarios forever was a large tail tax. The
        device batch is padded to power-of-two buckets so XLA compiles
        at most log2(S) batch shapes instead of one per distinct count.
        """
        import time as _time

        p = self.sims[0].param
        active = [sim for sim in self.sims if not sim.is_finished()]
        if not active:
            return
        t0 = _time.perf_counter()
        # batched ideal dynamics, host-side float64 over all scenarios at
        # once — same Bernstein evaluation as the single-sim do_step, so
        # a replica run is bit-identical to a standalone run, with no
        # device round-trip
        if iteration > 0:
            from lsc_dr_planner_tpu.sim.simulator import _state_at_np

            ctrl = np.stack([sim.desired_ctrl for sim in active])
            pos, vel, acc = _state_at_np(ctrl, p.multisim_time_step, p.dt)
            for s, sim in enumerate(active):
                sim.pos = pos[s].astype(np.float64)
                sim.vel = vel[s].astype(np.float64)
                sim.acc = acc[s].astype(np.float64)
                if p.world_dimension == 2:
                    sim.pos[:, 2] = p.world_z_2d
                sim.sim_time += p.multisim_time_step
                if sim.local_maps:
                    sim.map_manager.sense(sim.pos, p.sensor_range)

        # host MAPF layer, threaded across scenarios — the native
        # solvers release the GIL during their ctypes calls
        def host_phase(sim):
            sim.decentralized_mapp()
            return sim._build_step_inputs()

        inputs = list(self._pool.map(host_phase, active))
        t1 = _time.perf_counter()

        # pad the batch to a power-of-two bucket with repeats of the
        # last active input; padded lanes' outputs are discarded. Past
        # 32 the chunked step needs a multiple of 32 (the bucket is NOT
        # capped at S: S itself may be non-divisible, e.g. S=40).
        n_act = len(inputs)
        B = 1
        while B < n_act:
            B *= 2
        B = min(B, self.S)
        if B > 32:
            B = -(-n_act // 32) * 32
        inputs = inputs + [inputs[-1]] * (B - n_act)

        # stack numpy leaves once → one device transfer
        stacked = jax.tree_util.tree_map(
            lambda *leaves: np.stack(leaves), *inputs
        )
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            shard = NamedSharding(self.mesh, P("scenarios"))

            def place(x):
                if x is None or np.ndim(x) == 0:
                    return x
                return jax.device_put(x, shard)

            stacked = jax.tree_util.tree_map(place, stacked)
        t2 = _time.perf_counter()
        outs = self._vstep(self.fleet, stacked)
        # one device→host transfer of only the leaves the host applies
        # (obs_pred_ctrl alone is ~12 KB/agent — at 1024×8 that is
        # ~94 MB/step of device→host copies if pulled)
        keep = ("desired_ctrl", "current_goal", "sfc_lo", "sfc_hi",
                "sfc_initialized", "qp_converged", "qp_residual",
                "qp_iterations", "qp_y")
        outs_np = outs._replace(**{
            f: (np.asarray(getattr(outs, f)) if f in keep else None)
            for f in outs._fields
        })
        t3 = _time.perf_counter()
        # fleet-wide QP convergence across the ACTIVE scenario lanes —
        # the silent-failsafe tax the flattened rescue exists to close;
        # padded lanes are excluded
        self.last_qp_convergence = float(
            np.mean(outs_np.qp_converged[:n_act])
        )
        for s, sim in enumerate(active):
            out_s = jax.tree_util.tree_map(
                lambda x: x[s] if x is not None else None, outs_np
            )
            sim._apply_step_outputs(out_s)
            sim.save_simulation_result()
        t4 = _time.perf_counter()
        self.phase_times = {
            "n_active": len(active), "host": t1 - t0, "stack": t2 - t1,
            "device": t3 - t2, "apply": t4 - t3,
        }

    # ------------------------------------------------------------------
    def run(self, max_iterations: Optional[int] = None) -> List[dict]:
        max_iter = max_iterations or self.sims[0].param.multisim_max_planner_iteration
        for it in range(max_iter):
            if all(sim.is_finished() for sim in self.sims):
                break
            self.step(it)
        return [sim.summary() for sim in self.sims]
