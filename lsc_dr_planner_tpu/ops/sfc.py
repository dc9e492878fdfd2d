"""Safe Flight Corridor (SFC) construction — batched, O(1)-per-query.

Capability parity with the reference's corridor machinery (reference:
src/collision_constraints.cpp — initializeSFC :366-383, shift update +
new last box from point :396-412 / from convex hull :414-436, greedy
axis-sweep expansion :820-881, goal-directed axis ordering
setAxisCand :1134-1170, margin compensation :864-877).

Batched redesign: boxes live in integer lattice coordinates; the
"any obstacle in this box?" predicate is a single 8-corner integral-image
lookup (see world/grid.py) instead of the reference's O(cells) EDT scan.
The greedy expansion is a bounded `lax.while_loop` doing one O(1) query
per step; agents are vmapped.

Box tensors: per agent, `lo`/`hi` int32 [..., M, 3] (inclusive lattice
index ranges; world coords = index·res with margin compensation applied
at conversion time).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lsc_dr_planner_tpu.world.grid import GridWorld

# direction encoding: 0,1,2 = -x,-y,-z; 3,4,5 = +x,+y,+z
_DIR_AXIS = np.array([0, 1, 2, 0, 1, 2], dtype=np.int32)
_DIR_SIGN = np.array([-1, -1, -1, 1, 1, 1], dtype=np.int32)


def _dims_arr(gw: GridWorld):
    return jnp.asarray(np.asarray(gw.occ.shape), dtype=jnp.int32)


def expand_box(gw: GridWorld, lo, hi, axis_order, max_iters: int = 4096,
               max_radius_cells: int = 0):
    """Greedy round-robin box expansion on the blocked-lattice field.

    lo, hi: int32 [3] (inclusive lattice range). axis_order: int32 [6]
    permutation of directions, tried cyclically; a direction is retired
    when one further cell along it would hit an obstacle or leave the
    world. Returns (lo, hi, ok) where ok = the seed box itself was free.

    `max_radius_cells` > 0 additionally retires a direction once it has
    grown that many cells beyond the seed face. The while-loop's trip
    count is then bounded by 6·max_radius_cells independent of world
    size — the scaling term that made SFC 78% of the fused step at
    A=1024 on large worlds. Callers pass a physics-derived radius (full
    horizon reach + margin) that the QP can never out-run, so the
    clamped box constrains nothing the unclamped one wouldn't.

    Reference: CollisionConstraints::expandSFC,
    src/collision_constraints.cpp:820-881.
    """
    dims = _dims_arr(gw)
    seed_free = gw.box_is_free(lo, hi) & jnp.all(lo >= 0) & jnp.all(hi <= dims)
    if max_radius_cells > 0:
        r = jnp.int32(max_radius_cells)
        lo_min = lo - r
        hi_max = hi + r
    else:
        lo_min = jnp.full((3,), -(2**30), jnp.int32)
        hi_max = jnp.full((3,), 2**30, jnp.int32)

    def try_dir(lo, hi, d):
        axis = jnp.asarray(_DIR_AXIS)[d]
        sign = jnp.asarray(_DIR_SIGN)[d]
        delta = sign * jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        nlo = jnp.where(sign < 0, lo + delta, lo)
        nhi = jnp.where(sign > 0, hi + delta, hi)
        in_bounds = (
            jnp.all(nlo >= 0) & jnp.all(nhi <= dims)
            & jnp.all(nlo >= lo_min) & jnp.all(nhi <= hi_max)
        )
        ok = in_bounds & gw.box_is_free(nlo, nhi)
        return nlo, nhi, ok

    def cond(state):
        lo, hi, active, ptr, it = state
        return jnp.any(active) & (it < max_iters)

    def body(state):
        lo, hi, active, ptr, it = state
        # next active slot in cyclic order starting at ptr
        idx6 = jnp.arange(6)
        order_pos = (ptr + idx6) % 6
        act = active[order_pos]
        step = jnp.argmax(act)  # first active offset
        slot = (ptr + step) % 6
        d = axis_order[slot]
        nlo, nhi, ok = try_dir(lo, hi, d)
        lo = jnp.where(ok, nlo, lo)
        hi = jnp.where(ok, nhi, hi)
        active = jnp.where(ok, active, active.at[slot].set(False))
        ptr = jnp.where(ok, (slot + 1) % 6, slot)
        return lo, hi, active, ptr, it + 1

    active0 = jnp.ones(6, dtype=bool) & seed_free
    lo, hi, _, _, _ = jax.lax.while_loop(
        cond, body, (lo, hi, active0, jnp.int32(0), jnp.int32(0))
    )
    return lo, hi, seed_free


def default_axis_order():
    return jnp.arange(6, dtype=jnp.int32)


def goal_directed_axis_order(box_lo_pt, box_hi_pt, goal):
    """Axis try-order by descending |goal − box mid| with the toward-goal
    direction first; away directions mirrored at the back.

    Reference: CollisionConstraints::setAxisCand,
    src/collision_constraints.cpp:1134-1170.
    """
    mid = 0.5 * (box_lo_pt + box_hi_pt)
    delta = goal - mid
    offsets = jnp.where(delta > 0, 3, 0)  # toward-goal direction id offset
    # stable descending sort of |delta|
    order = jnp.argsort(-jnp.abs(delta), stable=True)
    toward = order + offsets[order]
    away = order + (3 - offsets[order])
    return jnp.concatenate([toward, away[::-1]]).astype(jnp.int32)


def initialize_sfc(gw: GridWorld, position, M: int, max_radius_cells: int = 0):
    """Seed box = the grid cell containing the agent, expanded in default
    order; replicated over all M segments.

    Reference: CollisionConstraints::initializeSFC,
    src/collision_constraints.cpp:366-383.
    """
    lo = gw.point_to_lattice_floor(position)
    hi = gw.point_to_lattice_ceil(position)
    lo, hi, ok = expand_box(gw, lo, hi, default_axis_order(),
                            max_radius_cells=max_radius_cells)
    return (
        jnp.broadcast_to(lo, (M, 3)),
        jnp.broadcast_to(hi, (M, 3)),
        ok,
    )


def construct_sfc_from_point(gw: GridWorld, sfc_lo, sfc_hi, point, goal,
                             max_radius_cells: int = 0):
    """Corridor shift update + new last box grown from `point` toward
    `goal` (non-DR goal modes).

    Reference: constructSFCFromPoint + expandSFCFromPoint,
    src/collision_constraints.cpp:396-412, 669-694.
    """
    prev_lo, prev_hi = sfc_lo[-1], sfc_hi[-1]
    lo = gw.point_to_lattice_floor(point)
    hi = gw.point_to_lattice_ceil(point)
    # if not included in the previous last box, intersect with it
    included = jnp.all(lo >= prev_lo) & jnp.all(hi <= prev_hi)
    ilo = jnp.maximum(lo, prev_lo)
    ihi = jnp.minimum(hi, prev_hi)
    lo = jnp.where(included, lo, ilo)
    hi = jnp.where(included, hi, ihi)

    order = goal_directed_axis_order(
        gw.lattice_to_point(lo), gw.lattice_to_point(hi), goal
    )
    nlo, nhi, ok = expand_box(gw, lo, hi, order,
                              max_radius_cells=max_radius_cells)
    # failure → reuse previous last box
    new_lo = jnp.where(ok, nlo, prev_lo)
    new_hi = jnp.where(ok, nhi, prev_hi)
    return (
        jnp.concatenate([sfc_lo[1:], new_lo[None]], axis=0),
        jnp.concatenate([sfc_hi[1:], new_hi[None]], axis=0),
        ok,
    )


def construct_sfc_from_hull(gw: GridWorld, sfc_lo, sfc_hi, hull_pts, next_waypoint,
                            max_radius_cells: int = 0):
    """Corridor shift update + new last box containing the convex hull of
    `hull_pts` (= {initial-traj end, current goal}), greedily also trying
    to include `next_waypoint` (the DR goal mode update).

    Reference: constructSFCFromConvexHull + expandSFCFromConvexHull,
    src/collision_constraints.cpp:414-436, 696-778.
    """
    prev_lo, prev_hi = sfc_lo[-1], sfc_hi[-1]

    # attempt 1: hull + next_waypoint, round-aligned seed
    pts_g = jnp.concatenate([hull_pts, next_waypoint[None]], axis=0)
    lo1 = gw.point_to_lattice_round(jnp.min(pts_g, axis=0))
    hi1 = gw.point_to_lattice_round(jnp.max(pts_g, axis=0))
    e1lo, e1hi, ok1 = expand_box(gw, lo1, hi1, default_axis_order(),
                                 max_radius_cells=max_radius_cells)
    ok1 &= _superset_of(gw, e1lo, e1hi, pts_g)

    # attempt 2: hull only, floor/ceil seed intersected with previous box
    lo2 = gw.point_to_lattice_floor(jnp.min(hull_pts, axis=0))
    hi2 = gw.point_to_lattice_ceil(jnp.max(hull_pts, axis=0))
    included = jnp.all(lo2 >= prev_lo) & jnp.all(hi2 <= prev_hi)
    lo2 = jnp.where(included, lo2, jnp.maximum(lo2, prev_lo))
    hi2 = jnp.where(included, hi2, jnp.minimum(hi2, prev_hi))
    e2lo, e2hi, ok2 = expand_box(gw, lo2, hi2, default_axis_order(),
                                 max_radius_cells=max_radius_cells)
    ok2 &= _superset_of(gw, e2lo, e2hi, hull_pts)

    new_lo = jnp.where(ok1, e1lo, jnp.where(ok2, e2lo, prev_lo))
    new_hi = jnp.where(ok1, e1hi, jnp.where(ok2, e2hi, prev_hi))
    ok = ok1 | ok2
    return (
        jnp.concatenate([sfc_lo[1:], new_lo[None]], axis=0),
        jnp.concatenate([sfc_hi[1:], new_hi[None]], axis=0),
        ok,
    )


def construct_sfc_substep(gw: GridWorld, sfc_lo, sfc_hi, hull_pts,
                          next_waypoint, init_ctrl, margin: float,
                          max_radius_cells: int = 0):
    """DLSC sub-step corridor update (multisim_time_step < dt).

    The reference shifts the corridor one box per planning CALL
    (collision_constraints.cpp:396-436) — correct when each call
    advances the plan one full segment (LSC), but at sub-step cadence
    the segment grid advances only ts/dt of a segment per call, so an
    unconditional shift races the corridor ahead of the trajectory
    until the QP bounds exclude the reachable set entirely (measured:
    ~0.9 m initial-trajectory bound violations → mass failsafe → the
    fleet stalls; the reference's own DLSC experiments run without an
    octomap, so its SFC never exercises this).

    Sub-step rule (batched, per agent): advance the corridor one box
    ONLY when the shifted corridor still contains the initial
    trajectory (segment m ⊂ box m+1 for every m) — the QP feasibility
    invariant. Otherwise keep the current boxes. The LAST box is
    rebuilt from the {initial end, current goal} hull either way, with
    a full-last-segment containment guard (falling back to the
    previous last box, which contains initial segment M−1 = previous
    solution segment M−1 by induction).

    init_ctrl: [M, N, 3] initial-trajectory control points.
    """
    M = sfc_lo.shape[0]
    prev_lo, prev_hi = sfc_lo[-1], sfc_hi[-1]

    # new last box: same two attempts as construct_sfc_from_hull
    pts_g = jnp.concatenate([hull_pts, next_waypoint[None]], axis=0)
    lo1 = gw.point_to_lattice_round(jnp.min(pts_g, axis=0))
    hi1 = gw.point_to_lattice_round(jnp.max(pts_g, axis=0))
    e1lo, e1hi, ok1 = expand_box(gw, lo1, hi1, default_axis_order(),
                                 max_radius_cells=max_radius_cells)
    ok1 &= _superset_of(gw, e1lo, e1hi, pts_g)
    lo2 = gw.point_to_lattice_floor(jnp.min(hull_pts, axis=0))
    hi2 = gw.point_to_lattice_ceil(jnp.max(hull_pts, axis=0))
    included = jnp.all(lo2 >= prev_lo) & jnp.all(hi2 <= prev_hi)
    lo2 = jnp.where(included, lo2, jnp.maximum(lo2, prev_lo))
    hi2 = jnp.where(included, hi2, jnp.minimum(hi2, prev_hi))
    e2lo, e2hi, ok2 = expand_box(gw, lo2, hi2, default_axis_order(),
                                 max_radius_cells=max_radius_cells)
    ok2 &= _superset_of(gw, e2lo, e2hi, hull_pts)
    # feasibility guard beyond the reference's hull check: the new last
    # box must contain the WHOLE initial last segment (in DLSC it is a
    # real segment, not the stationary horizon point of LSC mode)
    ok1 &= _superset_of(gw, e1lo, e1hi, init_ctrl[M - 1])
    ok2 &= _superset_of(gw, e2lo, e2hi, init_ctrl[M - 1])
    new_lo = jnp.where(ok1, e1lo, jnp.where(ok2, e2lo, prev_lo))
    new_hi = jnp.where(ok1, e1hi, jnp.where(ok2, e2hi, prev_hi))

    # Per-SEGMENT box update for m < M−1 (an all-segments-simultaneous
    # shift freezes the whole corridor on one laggard segment until
    # feasibility breaks — measured): box m takes the first candidate
    # containing initial segment m, trying (a) previous box m+1 (the
    # advancing shift), (b) previous box m (hold), (c) a fresh box
    # expanded from the segment's own bounding box.
    eps = 1e-3

    def contains(blo, bhi, pts):
        lo_w, hi_w = sfc_to_world(gw, blo, bhi, margin)
        return jnp.all((pts >= lo_w - eps) & (pts <= hi_w + eps))

    los, his = [], []
    for m in range(M - 1):
        seg = init_ctrl[m]
        c_shift = contains(sfc_lo[m + 1], sfc_hi[m + 1], seg)
        c_hold = contains(sfc_lo[m], sfc_hi[m], seg)
        flo = gw.point_to_lattice_floor(jnp.min(seg, axis=0))
        fhi = gw.point_to_lattice_ceil(jnp.max(seg, axis=0))
        elo, ehi, eok = expand_box(gw, flo, fhi, default_axis_order(),
                                   max_radius_cells=max_radius_cells)
        eok &= contains(elo, ehi, seg)
        mlo = jnp.where(
            c_shift, sfc_lo[m + 1],
            jnp.where(c_hold, sfc_lo[m], jnp.where(eok, elo, sfc_lo[m])),
        )
        mhi = jnp.where(
            c_shift, sfc_hi[m + 1],
            jnp.where(c_hold, sfc_hi[m], jnp.where(eok, ehi, sfc_hi[m])),
        )
        los.append(mlo)
        his.append(mhi)

    # last box: the hull rebuild above, holding the previous last box if
    # it fails to contain the initial last segment
    keep_new = (ok1 | ok2)
    llo = jnp.where(keep_new, new_lo, prev_lo)
    lhi = jnp.where(keep_new, new_hi, prev_hi)
    los.append(llo)
    his.append(lhi)
    return jnp.stack(los), jnp.stack(his), keep_new


def update_sfc_fused(gw: GridWorld, mode: str, sfc_lo, sfc_hi, init_done,
                     last_pt, cgoal, wpt, pos, init_ctrl, margin: float,
                     max_radius_cells: int = 0):
    """One-agent SFC update with ALL greedy expansions batched into a
    single `lax.while_loop` (via an inner vmap over expansion lanes).

    Exactly reproduces the sequential composition the pipeline used
    before (initialize_sfc + construct_sfc_from_{hull,point} /
    construct_sfc_substep + the init_done select): each lane's greedy
    expansion is per-lane identical (vmap freezes finished lanes), but
    the merged loop costs max(T_lane) trips instead of Σ T_lane —
    the dominant term of the SFC stage at fleet scale (three sequential
    while_loops in LSC mode, M+2 in DLSC sub-step mode).

    mode: 'hull' (DR goal mode), 'point' (non-DR), 'substep' (DLSC
    ts < dt). Returns (new_lo [M,3], new_hi [M,3], ok).
    """
    M = sfc_lo.shape[0]
    prev_lo, prev_hi = sfc_lo[-1], sfc_hi[-1]

    # ---- build all expansion-lane seeds upfront ----------------------
    # lane 0: initialization seed from the current position
    lo_i = gw.point_to_lattice_floor(pos)
    hi_i = gw.point_to_lattice_ceil(pos)
    ord_d = default_axis_order()

    hull_pts = jnp.stack([last_pt, cgoal], axis=0)
    los, his, orders = [lo_i], [hi_i], [ord_d]

    if mode in ("hull", "substep"):
        pts_g = jnp.concatenate([hull_pts, wpt[None]], axis=0)
        lo1 = gw.point_to_lattice_round(jnp.min(pts_g, axis=0))
        hi1 = gw.point_to_lattice_round(jnp.max(pts_g, axis=0))
        lo2 = gw.point_to_lattice_floor(jnp.min(hull_pts, axis=0))
        hi2 = gw.point_to_lattice_ceil(jnp.max(hull_pts, axis=0))
        included = jnp.all(lo2 >= prev_lo) & jnp.all(hi2 <= prev_hi)
        lo2 = jnp.where(included, lo2, jnp.maximum(lo2, prev_lo))
        hi2 = jnp.where(included, hi2, jnp.minimum(hi2, prev_hi))
        los += [lo1, lo2]
        his += [hi1, hi2]
        orders += [ord_d, ord_d]
    else:  # 'point'
        lo_p = gw.point_to_lattice_floor(last_pt)
        hi_p = gw.point_to_lattice_ceil(last_pt)
        included = jnp.all(lo_p >= prev_lo) & jnp.all(hi_p <= prev_hi)
        lo_p = jnp.where(included, lo_p, jnp.maximum(lo_p, prev_lo))
        hi_p = jnp.where(included, hi_p, jnp.minimum(hi_p, prev_hi))
        los.append(lo_p)
        his.append(hi_p)
        orders.append(goal_directed_axis_order(
            gw.lattice_to_point(lo_p), gw.lattice_to_point(hi_p), cgoal
        ))

    if mode == "substep":
        for m in range(M - 1):
            seg = init_ctrl[m]
            los.append(gw.point_to_lattice_floor(jnp.min(seg, axis=0)))
            his.append(gw.point_to_lattice_ceil(jnp.max(seg, axis=0)))
            orders.append(ord_d)

    e_lo, e_hi, e_ok = jax.vmap(
        lambda l, h, o: expand_box(gw, l, h, o,
                                   max_radius_cells=max_radius_cells)
    )(jnp.stack(los), jnp.stack(his), jnp.stack(orders))

    # ---- recompose the original functions' post-logic ----------------
    ilo = jnp.broadcast_to(e_lo[0], (M, 3))
    ihi = jnp.broadcast_to(e_hi[0], (M, 3))

    if mode == "hull":
        ok1 = e_ok[1] & _superset_of(gw, e_lo[1], e_hi[1], pts_g)
        ok2 = e_ok[2] & _superset_of(gw, e_lo[2], e_hi[2], hull_pts)
        new_lo = jnp.where(ok1, e_lo[1], jnp.where(ok2, e_lo[2], prev_lo))
        new_hi = jnp.where(ok1, e_hi[1], jnp.where(ok2, e_hi[2], prev_hi))
        ulo = jnp.concatenate([sfc_lo[1:], new_lo[None]], axis=0)
        uhi = jnp.concatenate([sfc_hi[1:], new_hi[None]], axis=0)
    elif mode == "point":
        new_lo = jnp.where(e_ok[1], e_lo[1], prev_lo)
        new_hi = jnp.where(e_ok[1], e_hi[1], prev_hi)
        ulo = jnp.concatenate([sfc_lo[1:], new_lo[None]], axis=0)
        uhi = jnp.concatenate([sfc_hi[1:], new_hi[None]], axis=0)
    else:  # substep (construct_sfc_substep per-segment update)
        ok1 = e_ok[1] & _superset_of(gw, e_lo[1], e_hi[1], pts_g)
        ok2 = e_ok[2] & _superset_of(gw, e_lo[2], e_hi[2], hull_pts)
        ok1 &= _superset_of(gw, e_lo[1], e_hi[1], init_ctrl[M - 1])
        ok2 &= _superset_of(gw, e_lo[2], e_hi[2], init_ctrl[M - 1])
        new_lo = jnp.where(ok1, e_lo[1], jnp.where(ok2, e_lo[2], prev_lo))
        new_hi = jnp.where(ok1, e_hi[1], jnp.where(ok2, e_hi[2], prev_hi))

        eps = 1e-3

        def contains(blo, bhi, pts):
            lo_w, hi_w = sfc_to_world(gw, blo, bhi, margin)
            return jnp.all((pts >= lo_w - eps) & (pts <= hi_w + eps))

        us_lo, us_hi = [], []
        for m in range(M - 1):
            seg = init_ctrl[m]
            c_shift = contains(sfc_lo[m + 1], sfc_hi[m + 1], seg)
            c_hold = contains(sfc_lo[m], sfc_hi[m], seg)
            eok = e_ok[3 + m] & contains(e_lo[3 + m], e_hi[3 + m], seg)
            mlo = jnp.where(
                c_shift, sfc_lo[m + 1],
                jnp.where(c_hold, sfc_lo[m],
                          jnp.where(eok, e_lo[3 + m], sfc_lo[m])),
            )
            mhi = jnp.where(
                c_shift, sfc_hi[m + 1],
                jnp.where(c_hold, sfc_hi[m],
                          jnp.where(eok, e_hi[3 + m], sfc_hi[m])),
            )
            us_lo.append(mlo)
            us_hi.append(mhi)
        keep_new = ok1 | ok2
        us_lo.append(jnp.where(keep_new, new_lo, prev_lo))
        us_hi.append(jnp.where(keep_new, new_hi, prev_hi))
        ulo = jnp.stack(us_lo)
        uhi = jnp.stack(us_hi)

    lo = jnp.where(init_done, ulo, ilo)
    hi = jnp.where(init_done, uhi, ihi)
    return lo, hi


def _superset_of(gw: GridWorld, lo, hi, pts):
    """Containment check against the margin-COMPENSATED box (the
    reference checks isSuperSetOfConvexHull on the box returned by
    expandSFC, which already includes the margin compensation,
    collision_constraints.cpp:864-881 + 414-436)."""
    lop, hip = sfc_to_world(gw, lo, hi, gw.radius)
    return jnp.all((pts >= lop - 1e-6) & (pts <= hip + 1e-6))


def sfc_to_world(gw: GridWorld, sfc_lo, sfc_hi, margin: float):
    """Lattice boxes → world-coordinate boxes with margin compensation:
    each face not on the world boundary moves outward by
    margin − floor(margin/res)·res.

    Reference: expandSFC margin compensation,
    src/collision_constraints.cpp:864-877.
    """
    res = gw.resolution
    delta = margin - np.floor(margin / res + 1e-9) * res
    dims = _dims_arr(gw)
    lo_pt = gw.lattice_to_point(sfc_lo)
    hi_pt = gw.lattice_to_point(sfc_hi)
    lo_pt = jnp.where(sfc_lo > 0, lo_pt - delta, lo_pt)
    hi_pt = jnp.where(sfc_hi < dims, hi_pt + delta, hi_pt)
    return lo_pt, hi_pt
