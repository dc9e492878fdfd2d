"""Mission / world file I/O.

Capability parity with the reference mission layer (reference:
src/mission.cpp — JSON parsing :94-397, directory enumeration :4-45,
goal-noise injection :410-420, save-mission-back :427-468; world CSV box
lists: src/map_manager.cpp:262-305, world/forest/forest1.csv).

Mission JSON schema (missions/readme.txt): quadrotor type table
(max_vel / max_acc / radius / nominal_velocity / downwash), world bbox,
per-agent {type, cid, start, goal}, and six analytic obstacle types.
World files are CSV rows `cx,cy,cz,sx,sy,sz` (axis-aligned boxes) or
binary octomap `.bt` (not needed for the shipped benchmarks; gated).
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class AgentSpec:
    id: int = 0
    cid: int = 0
    type: str = "default"
    max_vel: np.ndarray = None
    max_acc: np.ndarray = None
    radius: float = 0.15
    downwash: float = 2.0
    nominal_velocity: float = 1.0
    start: np.ndarray = None
    goal: np.ndarray = None


@dataclasses.dataclass
class ObstacleSpec:
    """Analytic dynamic obstacle description (reference: include/obstacle.hpp).

    `type` ∈ {spin, straight, patrol, chasing, gaussian, real}; the fields
    used depend on the type (see world/obstacles.py for the dynamics).
    """

    type: str
    radius: float = 0.0
    max_acc: float = 0.0
    downwash: float = 1.0
    # spin
    axis_position: Optional[np.ndarray] = None
    axis_ori: Optional[np.ndarray] = None
    start: Optional[np.ndarray] = None
    speed: float = 0.0
    # straight
    goal: Optional[np.ndarray] = None
    # patrol
    waypoints: Optional[np.ndarray] = None
    # chasing
    max_vel: float = 0.0
    gamma_target: float = 0.0
    gamma_obs: float = 0.0
    # gaussian
    initial_vel: Optional[np.ndarray] = None
    stddev_acc: float = 0.0
    acc_update_cycle: float = 0.1


class Mission:
    """A loaded mission: world bounds, agents, obstacles, world boxes."""

    def __init__(self):
        self.world_min = np.zeros(3)
        self.world_max = np.zeros(3)
        self.agents: List[AgentSpec] = []
        self.obstacles: List[ObstacleSpec] = []
        self.world_boxes: np.ndarray = np.zeros((0, 6))  # cx,cy,cz,sx,sy,sz
        self.quadrotor_map: Dict[str, AgentSpec] = {}
        self.mission_file_name: str = ""
        self.world_file_name: str = ""
        self.raw: dict = {}

    # ------------------------------------------------------------------
    @property
    def qn(self) -> int:
        return len(self.agents)

    @property
    def on(self) -> int:
        return len(self.obstacles)

    # ------------------------------------------------------------------
    @classmethod
    def load(
        cls,
        mission_file: str,
        world_file: Optional[str] = None,
        world_dimension: int = 3,
        world_z_2d: float = 1.0,
        max_noise: float = 0.0,
        noise_seed: Optional[int] = None,
    ) -> "Mission":
        m = cls()
        m.mission_file_name = mission_file
        with open(mission_file) as f:
            doc = json.load(f)
        m.raw = doc

        dim = doc["world"][0]["dimension"]
        m.world_min = np.asarray(dim[:3], dtype=np.float64)
        m.world_max = np.asarray(dim[3:], dtype=np.float64)

        for name, q in doc.get("quadrotors", {}).items():
            m.quadrotor_map[name] = AgentSpec(
                type=name,
                max_vel=np.asarray(q["max_vel"], dtype=np.float64),
                max_acc=np.asarray(q["max_acc"], dtype=np.float64),
                radius=float(q["radius"]),
                downwash=float(q.get("downwash", 2.0)),
                nominal_velocity=float(q.get("nominal_velocity", 1.0)),
            )

        for qi, a in enumerate(doc["agents"]):
            base = m.quadrotor_map.get(a.get("type", "default"))
            spec = dataclasses.replace(base) if base else AgentSpec()
            spec.id = qi
            spec.cid = int(a.get("cid", qi))
            spec.type = a.get("type", "default")
            if base is not None:
                spec.max_vel = base.max_vel.copy()
                spec.max_acc = base.max_acc.copy()
            start = np.asarray(a["start"], dtype=np.float64)
            goal = np.asarray(a["goal"], dtype=np.float64)
            if world_dimension == 2:
                start = start.copy()
                goal = goal.copy()
                start[2] = world_z_2d
                goal[2] = world_z_2d
            spec.start, spec.goal = start, goal
            if "radius" in a:
                spec.radius = float(a["radius"])
            if "downwash" in a:
                spec.downwash = float(a["downwash"])
            if "nominal_velocity" in a:
                spec.nominal_velocity = float(a["nominal_velocity"])
            m.agents.append(spec)

        for o in doc.get("obstacles", []):
            m.obstacles.append(_parse_obstacle(o))

        if max_noise > 0:
            m.add_noise(max_noise, world_dimension, seed=noise_seed)

        if world_file is not None:
            m.load_world(world_file)
        return m

    # ------------------------------------------------------------------
    def load_world(self, world_file: str) -> None:
        self.world_file_name = world_file
        if world_file.endswith(".csv"):
            rows = []
            with open(world_file) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rows.append([float(x) for x in line.split(",")][:6])
            self.world_boxes = np.asarray(rows, dtype=np.float64).reshape(-1, 6)
        elif world_file.endswith(".bt"):
            # binary octomap world (reference: octree_ptr->readBinary,
            # src/map_manager.cpp:68-72); every occupied leaf becomes one
            # axis-aligned box
            from lsc_dr_planner_tpu.world.octomap import read_bt

            self.world_boxes, _ = read_bt(world_file)
        else:
            raise ValueError(f"unknown world file type: {world_file}")

    # ------------------------------------------------------------------
    def add_noise(self, max_noise: float, dimension: int, seed=None) -> None:
        """Uniform [0, max_noise) goal perturbation per axis.

        Reference: Mission::addNoise, src/mission.cpp:410-420 (seeded here
        for reproducibility; the reference uses a random_device).
        """
        rng = np.random.default_rng(seed)
        for a in self.agents:
            a.goal[:dimension] += rng.random(dimension) * max_noise

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the (possibly noise-perturbed) mission back to JSON.

        Reference: Mission::saveMission, src/mission.cpp:427-468.
        """
        doc = dict(self.raw)
        doc["agents"] = []
        for a in self.agents:
            doc["agents"].append(
                {
                    "type": a.type,
                    "cid": a.cid,
                    "start": [float(x) for x in a.start],
                    "goal": [float(x) for x in a.goal],
                }
            )
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)

    # ------------------------------------------------------------------
    # Stacked views for batched planning
    def stacked(self) -> Dict[str, np.ndarray]:
        return {
            "start": np.stack([a.start for a in self.agents]),
            "goal": np.stack([a.goal for a in self.agents]),
            "radius": np.asarray([a.radius for a in self.agents]),
            "downwash": np.asarray([a.downwash for a in self.agents]),
            "max_vel": np.stack([a.max_vel for a in self.agents]),
            "max_acc": np.stack([a.max_acc for a in self.agents]),
            "nominal_velocity": np.asarray(
                [a.nominal_velocity for a in self.agents]
            ),
        }


def _parse_obstacle(o: dict) -> ObstacleSpec:
    t = o["type"]
    dw = float(o.get("downwash", 1.0)) or 1.0
    spec = ObstacleSpec(
        type=t,
        radius=float(o.get("size", 0.0)),
        max_acc=float(o.get("max_acc", 0.0)),
        downwash=dw,
    )
    arr = lambda k: np.asarray(o[k], dtype=np.float64) if k in o else None
    if t == "spin":
        spec.axis_position = arr("axis_position")
        spec.axis_ori = arr("axis_ori")
        spec.start = arr("start")
        spec.speed = float(o.get("speed", 0.0))
    elif t == "straight":
        spec.start = arr("start")
        spec.goal = arr("goal")
        spec.speed = float(o.get("speed", 0.0))
    elif t == "patrol":
        spec.waypoints = np.asarray(
            [w["waypoint"] for w in o["waypoints"]], dtype=np.float64
        )
        spec.speed = float(o.get("speed", 0.0))
    elif t == "chasing":
        spec.start = arr("start")
        spec.max_vel = float(o.get("max_vel", 0.0))
        spec.gamma_target = float(o.get("gamma_target", 0.0))
        spec.gamma_obs = float(o.get("gamma_obs", 0.0))
    elif t == "gaussian":
        spec.start = arr("start")
        spec.initial_vel = arr("initial_vel")
        spec.max_vel = float(o.get("max_vel", 0.0))
        spec.stddev_acc = float(o.get("stddev_acc", 0.0))
        spec.acc_update_cycle = float(o.get("acc_update_cycle", 0.1)) or 0.1
    elif t == "real":
        spec.speed = float(o.get("speed", 0.0))
    else:
        raise ValueError(f"unknown obstacle type {t}")
    return spec


# ----------------------------------------------------------------------
# Mission set enumeration (directory mode)
# ----------------------------------------------------------------------


def enumerate_mission_set(
    mission_dir: str, world_dir: str
) -> List[Tuple[str, str]]:
    """Pair mission JSONs with world CSVs by sorted index.

    Reference: directory mode, src/mission.cpp:4-45 and
    src/multi_sync_simulator_node.cpp:44-56.
    """
    missions = sorted(
        os.path.join(mission_dir, f)
        for f in os.listdir(mission_dir)
        if f.endswith(".json")
    )
    worlds = sorted(
        os.path.join(world_dir, f)
        for f in os.listdir(world_dir)
        if f.endswith(".csv") or f.endswith(".bt")
    )
    if len(worlds) == 1:
        worlds = worlds * len(missions)
    return list(zip(missions, worlds))


def _natural_key(path: str):
    import re

    return [
        int(s) if s.isdigit() else s for s in re.split(r"(\d+)", os.path.basename(path))
    ]


def enumerate_mission_set_natural(mission_dir: str, world_dir: str):
    """Like enumerate_mission_set but with natural (numeric) ordering so
    mission `*_2.json` pairs with world `*2.csv` (the reference's sorted()
    pairs lexicographically; benchmark sets use matched numeric suffixes)."""
    missions = sorted(
        (
            os.path.join(mission_dir, f)
            for f in os.listdir(mission_dir)
            if f.endswith(".json")
        ),
        key=_natural_key,
    )
    worlds = sorted(
        (
            os.path.join(world_dir, f)
            for f in os.listdir(world_dir)
            if f.endswith(".csv")
        ),
        key=_natural_key,
    )
    if len(worlds) == 1:
        worlds = worlds * len(missions)
    return list(zip(missions, worlds))


# ----------------------------------------------------------------------
# Random mission generation (parity with matlab/mission_generator.m)
# ----------------------------------------------------------------------


def generate_random_mission(
    n_agents: int,
    world_min,
    world_max,
    radius: float = 0.15,
    z: float = 0.6,
    min_separation: float = 0.6,
    seed: int = 0,
    quad: Optional[dict] = None,
    snap_grid: Optional[float] = 0.5,
) -> Mission:
    """Random start/goal mission with pairwise separation (rejection
    sampling), equivalent in capability to matlab/mission_generator.m.

    `snap_grid`: starts/goals are snapped to this lattice (the shipped
    benchmark missions place all goals on the 0.5 m MAPF grid, which the
    DR waypoint layer needs to converge to the exact goal point)."""
    rng = np.random.default_rng(seed)
    world_min = np.asarray(world_min, dtype=np.float64)
    world_max = np.asarray(world_max, dtype=np.float64)

    def sample_points():
        pts = []
        for _ in range(n_agents):
            for _attempt in range(10000):
                p = world_min[:2] + rng.random(2) * (world_max[:2] - world_min[:2])
                if snap_grid:
                    p = np.round(p / snap_grid) * snap_grid
                    p = np.clip(p, world_min[:2], world_max[:2])
                if all(np.linalg.norm(p - q) > min_separation for q in pts):
                    pts.append(p)
                    break
            else:
                raise RuntimeError("could not place agents")
        return np.asarray(pts)

    starts = sample_points()
    goals = sample_points()

    m = Mission()
    m.world_min, m.world_max = world_min, world_max
    quad = quad or {
        "max_vel": [1.0, 1.0, 1.0],
        "max_acc": [2.0, 2.0, 2.0],
        "radius": radius,
        "nominal_velocity": 1.0,
        "downwash": 2.0,
    }
    m.raw = {
        "quadrotors": {"default": quad},
        "world": [{"dimension": list(world_min) + list(world_max)}],
        "agents": [],
        "obstacles": [],
    }
    for qi in range(n_agents):
        m.agents.append(
            AgentSpec(
                id=qi,
                cid=qi,
                type="default",
                max_vel=np.asarray(quad["max_vel"], dtype=np.float64),
                max_acc=np.asarray(quad["max_acc"], dtype=np.float64),
                radius=float(quad["radius"]),
                downwash=float(quad["downwash"]),
                nominal_velocity=float(quad["nominal_velocity"]),
                start=np.array([starts[qi, 0], starts[qi, 1], z]),
                goal=np.array([goals[qi, 0], goals[qi, 1], z]),
            )
        )
    return m


# ----------------------------------------------------------------------
# Seeded worlds and missions (no mission files needed)
# ----------------------------------------------------------------------


def random_world(rng, kind, half):
    """Random obstacle boxes [N, 6] (cx, cy, cz, sx, sy, sz) in the
    square [-half, half]²: a forest-like scatter or a maze-like wall
    field (`kind` ∈ {"forest", "maze"})."""
    boxes = []
    if kind == "forest":
        n = int(rng.integers(10, 40))
        for _ in range(n):
            s = rng.uniform(0.3, 0.9)
            cx, cy = rng.uniform(-half + 1, half - 1, 2)
            boxes.append([cx, cy, 1.0, s, s, 2.0])
    else:  # maze-like wall field
        # Wall center lines snap to the 0.5 m MAPF-grid CELL-CENTER
        # lattice, like the reference's maze worlds: a thin wall at an
        # arbitrary offset can slice the transition between two free
        # cell centers without marking either cell occupied — a world
        # family outside the (cell-based) grid semantics of both the
        # reference and this repo, which livelocks the waypoint layer
        # by construction.
        def snap_center(v):
            # grid NODES sit on multiples of 0.5 (build_coarse_grid)
            return np.round(v / 0.5) * 0.5

        n = int(rng.integers(6, 16))
        for _ in range(n):
            L = rng.uniform(1.0, 2.0 * half - 2.0)
            cx, cy = rng.uniform(-half + 1, half - 1, 2)
            if rng.random() < 0.5:
                boxes.append([cx, snap_center(cy), 1.0, L, 0.1, 2.0])
            else:
                boxes.append([snap_center(cx), cy, 1.0, 0.1, L, 2.0])
    return np.asarray(boxes).reshape(-1, 6)


def _occ_grid(boxes, half, res, clearance):
    n = int(np.ceil(2 * half / res))
    occ = np.zeros((n, n), bool)
    xs = -half + (np.arange(n) + 0.5) * res
    for cx, cy, _, sx, sy, _ in boxes:
        x0 = cx - sx / 2 - clearance
        x1 = cx + sx / 2 + clearance
        y0 = cy - sy / 2 - clearance
        y1 = cy + sy / 2 + clearance
        ix = np.nonzero((xs > x0) & (xs < x1))[0]
        iy = np.nonzero((xs > y0) & (xs < y1))[0]
        if len(ix) and len(iy):
            occ[ix[0]:ix[-1] + 1, iy[0]:iy[-1] + 1] = True
    return occ, xs


def _connected(occ, a, b):
    if occ[a] or occ[b]:
        return False
    seen = {a}
    q = deque([a])
    X, Y = occ.shape
    while q:
        x, y = q.popleft()
        if (x, y) == b:
            return True
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = x + dx, y + dy
            if 0 <= nx < X and 0 <= ny < Y and not occ[nx, ny] \
                    and (nx, ny) not in seen:
                seen.add((nx, ny))
                q.append((nx, ny))
    return False


def make_mission(rng, A, boxes, half, radius=0.15) -> Optional[Mission]:
    """Random 2-D mission in `boxes` with obstacle-clear, pairwise-
    separated, connectivity-checked starts/goals on the 0.5 m grid.
    Returns None when sampling fails (draw another world)."""
    res = 0.5
    occ, xs = _occ_grid(boxes, half, res, clearance=radius + 0.2)

    def box_clearance(pt):
        """L2 distance from pt to the nearest box (2-D)."""
        if len(boxes) == 0:
            return np.inf
        b = np.asarray(boxes)
        dx = np.maximum(np.abs(pt[0] - b[:, 0]) - b[:, 3] / 2, 0.0)
        dy = np.maximum(np.abs(pt[1] - b[:, 1]) - b[:, 4] / 2, 0.0)
        return float(np.min(np.hypot(dx, dy)))

    def cell_of(p):
        return (int(np.clip((p[0] + half) / res, 0, len(xs) - 1)),
                int(np.clip((p[1] + half) / res, 0, len(xs) - 1)))

    free_cells = np.argwhere(~occ)
    if len(free_cells) < 4 * A:
        return None

    def sample_set(exclude):
        pts = []
        for _ in range(A):
            for _a in range(3000):
                c = free_cells[rng.integers(len(free_cells))]
                p = np.array([-half + (c[0] + 0.5) * res,
                              -half + (c[1] + 0.5) * res])
                p = np.round(p / res) * res
                # the 0.5-lattice rounding can push edge cells OUT of the
                # world box: an agent born outside the fine lattice is
                # infeasible from step 0 and reads as a deadlock
                if np.max(np.abs(p)) > half - 0.3:
                    continue
                if occ[cell_of(p)]:
                    continue
                # the ROUNDED point must itself be flyable-to: within
                # radius+0.25 of a box face the fine-lattice inflation
                # blocks its cell, the SFC can never contain it, and a
                # goal there pins the goal LP short of it forever
                if box_clearance(p) < radius + 0.25:
                    continue
                if all(np.linalg.norm(p - q) >= 0.7 for q in pts + exclude):
                    pts.append(p)
                    break
            else:
                return None
        return pts

    starts = sample_set([])
    if starts is None:
        return None
    goals = sample_set([])
    if goals is None:
        return None
    for s, g in zip(starts, goals):
        if not _connected(occ, cell_of(s), cell_of(g)):
            return None

    m = generate_random_mission(
        A, [-half, -half, 0.0], [half, half, 2.5], radius=radius, seed=0,
        min_separation=0.0,
    )
    m.world_boxes = boxes
    for i, a in enumerate(m.agents):
        a.start = np.array([starts[i][0], starts[i][1], 0.6])
        a.goal = np.array([goals[i][0], goals[i][1], 0.6])
    return m


def lattice_forest(A: int, seed: int = 0):
    """Open-forest fleet at the upstream's density: a jittered 1.2 m
    agent lattice flying to antipodal goals through 0.3 m columns at
    0.25 columns/m², kept clear of starts and goals.

    Returns (starts [A, 2], goals [A, 2], boxes [T, 6], half) with the
    world spanning [-half, half]² × [0, 1]."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(A)))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    lattice = np.stack([gx, gy], -1).reshape(-1, 2)[:A] * 1.2
    lattice = lattice - lattice.mean(0)
    starts = lattice + rng.uniform(-0.2, 0.2, (A, 2))
    goals = -starts + rng.uniform(-0.2, 0.2, (A, 2))

    half = 0.6 * side + 2.0
    n_trees = int(0.25 * (2 * half) ** 2)
    keep = np.concatenate([starts, goals], 0)
    trees = []
    for _ in range(n_trees * 3):
        if len(trees) >= n_trees:
            break
        c = rng.uniform(-half + 0.5, half - 0.5, 2)
        if np.min(np.linalg.norm(keep - c, axis=-1)) > 0.6:
            trees.append([c[0], c[1], 0.5, 0.3, 0.3, 1.0])
    boxes = np.asarray(trees) if trees else np.zeros((0, 6))
    return starts, goals, boxes, half


def lattice_forest_mission(A: int, seed: int = 0, z: float = 0.6) -> Mission:
    """`lattice_forest` as a Mission for `MultiSyncSimulator`."""
    starts, goals, boxes, half = lattice_forest(A, seed)
    m = generate_random_mission(1, [-half, -half, 0.0], [half, half, 1.0])
    proto = m.agents[0]
    m.agents = [
        dataclasses.replace(proto, id=i, cid=i,
                            start=np.array([starts[i, 0], starts[i, 1], z]),
                            goal=np.array([goals[i, 0], goals[i, 1], z]))
        for i in range(A)
    ]
    m.world_boxes = boxes
    return m
