"""Per-agent map state: simulated local sensing + peer map merging.

Capability parity with the reference's MapManager local-map path
(reference: src/map_manager.cpp — simulated sensing by kd-tree radius
search over the global-map point cloud + insertPointCloud with
max range `sensor/range` :111-144, 191-229; peer map merging by
log-odds fusion of the neighbor's octree :231-260), driven the same
way: agents sense in `doStep` (agent_manager.cpp:46-48) and merge from
every neighbor within communication range in `broadcastMsgs`
(multi_sync_simulator.cpp:335-337), both only when
`world/use_global_map` is false.

Batched redesign: the per-agent octree becomes a per-agent boolean
known-occupancy mask over the global rasterized grid [A, X, Y, Z].

  * sensing  = reveal occupied cells whose center lies within the
    Euclidean sensor range of the agent (the kd-tree radius search,
    vectorized over the fleet × occupied-cell-center matrix). The
    reference's z ≥ −1 point filter (map_manager.cpp:138-140) is
    implied (all grid cells lie inside the world bbox).
  * merging  = single-hop union within communication range per step
    (binary ground-truth sensing makes octomap's log-odds addition of
    occupied leaves equivalent to set union).
  * the per-agent EDT rebuild (`distmap_ptr->update()`) becomes the
    on-device blocked-lattice + integral-image build inside the jitted
    pipeline step (world/grid.py::blocked_cumsum_jnp), batched over
    agents.

The masks stay on host (numpy) — sensing/merging are tiny boolean ops —
and ship to the device once per planning step as the `occ_known` input.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from lsc_dr_planner_tpu.world.grid import rasterize_boxes


class MapManager:
    """Fleet-wide per-agent known-occupancy state."""

    def __init__(self, boxes: np.ndarray, world_min, world_max,
                 resolution: float, n_agents: int,
                 use_global_map: bool = True):
        self.resolution = resolution
        self.A = n_agents
        occ, _, origin_idx, _ = rasterize_boxes(
            boxes, world_min, world_max, resolution
        )
        self.occ_true = occ
        self.origin_idx = origin_idx
        self.use_global_map = use_global_map

        # occupied cell centers (the "global map point cloud",
        # map_manager.cpp:85-99 builds it from a PointCloud2; ours comes
        # from the rasterization directly)
        idx = np.argwhere(occ)
        self._occ_idx = idx
        self._occ_centers = (idx + origin_idx + 0.5) * resolution

        if use_global_map:
            self.known = np.broadcast_to(
                occ, (n_agents,) + occ.shape
            ).copy()
        else:
            self.known = np.zeros((n_agents,) + occ.shape, dtype=bool)
        self._version = np.zeros(n_agents, dtype=np.int64)

    # ------------------------------------------------------------------
    def sense(self, positions: np.ndarray, sensor_range: float) -> None:
        """Reveal occupied cells within Euclidean `sensor_range` of each
        agent (MapManager::getVirtualSensorInput's radius search,
        src/map_manager.cpp:191-230)."""
        if self.use_global_map or len(self._occ_centers) == 0:
            return
        positions = np.asarray(positions, dtype=np.float64)
        d2 = np.sum(
            (self._occ_centers[None] - positions[:, None]) ** 2, axis=-1
        )  # [A, P]
        hit = d2 <= sensor_range * sensor_range
        ii, jj = np.nonzero(hit)
        if len(ii) == 0:
            return
        cells = self._occ_idx[jj]
        newly = ~self.known[ii, cells[:, 0], cells[:, 1], cells[:, 2]]
        self.known[ii, cells[:, 0], cells[:, 1], cells[:, 2]] = True
        np.add.at(self._version, ii[newly], 1)

    # ------------------------------------------------------------------
    def merge(self, positions: np.ndarray, comm_range: float) -> None:
        """Single-hop map union from every peer within L∞ `comm_range`
        (the per-step mergeMapCallback fan-out,
        multi_sync_simulator.cpp:319-337 + map_manager.cpp:231-260)."""
        if self.use_global_map:
            return
        positions = np.asarray(positions, dtype=np.float64)
        d = np.max(np.abs(positions[:, None] - positions[None]), axis=-1)
        adj = (d < comm_range) if comm_range > 0 else np.ones_like(d, bool)
        np.fill_diagonal(adj, False)
        before = self.known.sum(axis=(1, 2, 3))
        # new_known[i] = known[i] ∨ (∨_{j: adj[i,j]} known[j])
        flat = self.known.reshape(self.A, -1)
        merged = flat | (adj @ flat.astype(np.uint8) > 0)
        self.known = merged.reshape(self.known.shape)
        after = self.known.sum(axis=(1, 2, 3))
        self._version += after - before

    # ------------------------------------------------------------------
    def union_occ(self) -> np.ndarray:
        """Union of all agents' known maps (used for the host-side
        coarse MAPF grid; after intra-group merging the group members'
        maps coincide, so the union equals each group's map on its own
        territory)."""
        return np.any(self.known, axis=0)

    def version(self) -> int:
        """Monotone counter that changes whenever any map changes."""
        return int(self._version.sum())
