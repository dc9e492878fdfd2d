"""Batched closest-point geometry kernels.

Capability parity with the reference's geometry toolbox (reference:
include/geometry.hpp — point/segment :31-102, simultaneous line paths
:105-127, segment–segment :174-264, point–convex-hull via openGJK
:266-296) re-designed for batched accelerators: everything is branch-free, fixed-shape,
and batches over arbitrary leading axes.

The point-to-convex-hull query (the LSC normal-vector op, reference
openGJK gjk() src/openGJK/openGJK.cpp:674) is replaced by an *exact*
Carathéodory enumeration: for a K-point hull the closest point to the
origin lies on a vertex, edge, or triangle face (or the origin is inside
some tetrahedron ⇒ distance 0). K is small (n+1 = 6 control points), so
enumerating all C(K,1)+C(K,2)+C(K,3) sub-simplices plus C(K,4) inside
tests is cheap, exact, and fully vectorized — no data-dependent
iteration like GJK.
"""

from __future__ import annotations

import functools
import itertools

import jax.numpy as jnp
import numpy as np

_EPS = 1e-12


def closest_point_on_segment(p, a, b):
    """Closest point to p on segment [a, b]; all [..., D].

    Reference: closestPointsBetweenPointAndLineSegment,
    include/geometry.hpp:74-102.
    """
    ab = b - a
    denom = jnp.sum(ab * ab, axis=-1, keepdims=True)
    t = jnp.sum((p - a) * ab, axis=-1, keepdims=True) / jnp.maximum(denom, _EPS)
    t = jnp.where(denom <= _EPS, 0.0, jnp.clip(t, 0.0, 1.0))
    return a + t * ab


def closest_between_line_paths(p1, p2, q1, q2):
    """Closest approach of two *simultaneously parameterized* line paths
    P(t) = p1 + t(p2−p1), Q(t) = q1 + t(q2−q1), t ∈ [0, 1].

    Returns (point_on_P, point_on_Q, dist). Used for LSC against moving
    obstacles. Reference: closestPointsBetweenLinePaths,
    include/geometry.hpp:105-127.
    """
    d0 = q1 - p1
    dv = (q2 - q1) - (p2 - p1)
    denom = jnp.sum(dv * dv, axis=-1, keepdims=True)
    t = -jnp.sum(d0 * dv, axis=-1, keepdims=True) / jnp.maximum(denom, _EPS)
    t = jnp.where(denom <= _EPS, 0.0, jnp.clip(t, 0.0, 1.0))
    cp = p1 + t * (p2 - p1)
    cq = q1 + t * (q2 - q1)
    dist = jnp.linalg.norm(cq - cp, axis=-1)
    return cp, cq, dist


def closest_between_segments(p1, p2, q1, q2):
    """Closest points between segments [p1,p2] and [q1,q2]; all [..., D].

    Returns (point_on_P, point_on_Q, dist). Branch-free version of the
    standard robust segment–segment query (parallel case falls back to
    clamped endpoint projection). Reference:
    closestPointsBetweenLineSegments, include/geometry.hpp:174-264.
    """
    d1 = p2 - p1
    d2 = q2 - q1
    r = p1 - q1
    a = jnp.sum(d1 * d1, axis=-1)
    e = jnp.sum(d2 * d2, axis=-1)
    f = jnp.sum(d2 * r, axis=-1)
    c = jnp.sum(d1 * r, axis=-1)
    b = jnp.sum(d1 * d2, axis=-1)
    denom = a * e - b * b

    # general case
    s_gen = jnp.clip((b * f - c * e) / jnp.maximum(denom, _EPS), 0.0, 1.0)
    # parallel (denom ~ 0): pick s = 0
    s = jnp.where(denom > _EPS * jnp.maximum(a * e, 1.0), s_gen, 0.0)
    # degenerate segments
    s = jnp.where(a <= _EPS, 0.0, s)

    t = (b * s + f) / jnp.maximum(e, _EPS)
    t_clamped = jnp.clip(t, 0.0, 1.0)
    # recompute s for clamped t
    s2 = jnp.clip((b * t_clamped - c) / jnp.maximum(a, _EPS), 0.0, 1.0)
    s = jnp.where(a <= _EPS, 0.0, jnp.where(t == t_clamped, s, s2))
    t = jnp.where(e <= _EPS, 0.0, t_clamped)

    cp = p1 + s[..., None] * d1
    cq = q1 + t[..., None] * d2
    dist = jnp.linalg.norm(cq - cp, axis=-1)
    return cp, cq, dist


# ----------------------------------------------------------------------
# Exact point-to-convex-hull (origin to hull of K points)
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _simplex_indices(K: int):
    pairs = np.array(list(itertools.combinations(range(K), 2)), dtype=np.int32)
    triples = np.array(list(itertools.combinations(range(K), 3)), dtype=np.int32)
    quads = np.array(list(itertools.combinations(range(K), 4)), dtype=np.int32)
    if quads.size == 0:
        quads = np.zeros((0, 4), dtype=np.int32)
    return pairs, triples, quads


def _closest_on_triangle_to_origin(a, b, c):
    """Closest point to the origin on triangle (a, b, c); [..., 3] each.

    Branch-free port of the classic Voronoi-region triangle query
    (regions resolved with nested selects)."""
    p = jnp.zeros_like(a)
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = jnp.sum(ab * ap, axis=-1)
    d2 = jnp.sum(ac * ap, axis=-1)

    bp = p - b
    d3 = jnp.sum(ab * bp, axis=-1)
    d4 = jnp.sum(ac * bp, axis=-1)

    cp = p - c
    d5 = jnp.sum(ab * cp, axis=-1)
    d6 = jnp.sum(ac * cp, axis=-1)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    # edge AB
    v_ab = jnp.clip(d1 / jnp.maximum(d1 - d3, _EPS), 0.0, 1.0)
    p_ab = a + v_ab[..., None] * ab
    # edge AC
    w_ac = jnp.clip(d2 / jnp.maximum(d2 - d6, _EPS), 0.0, 1.0)
    p_ac = a + w_ac[..., None] * ac
    # edge BC
    w_bc = jnp.clip((d4 - d3) / jnp.maximum((d4 - d3) + (d5 - d6), _EPS), 0.0, 1.0)
    p_bc = b + w_bc[..., None] * (c - b)
    # interior
    denom = jnp.maximum(va + vb + vc, _EPS)
    v_in = vb / denom
    w_in = vc / denom
    p_in = a + v_in[..., None] * ab + w_in[..., None] * ac

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    out = p_in
    out = jnp.where(on_bc[..., None], p_bc, out)
    out = jnp.where(on_ac[..., None], p_ac, out)
    out = jnp.where(on_ab[..., None], p_ab, out)
    out = jnp.where(in_c[..., None], c, out)
    out = jnp.where(in_b[..., None], b, out)
    out = jnp.where(in_a[..., None], a, out)
    return out


def _origin_in_tetra(a, b, c, d):
    """True where the origin is inside tetrahedron (a,b,c,d); [..., 3]."""

    def signed_vol(p0, p1, p2, p3):
        return jnp.einsum(
            "...i,...i->...", p1 - p0, jnp.cross(p2 - p0, p3 - p0)
        )

    o = jnp.zeros_like(a)
    v0 = signed_vol(a, b, c, d)
    v1 = signed_vol(o, b, c, d)
    v2 = signed_vol(a, o, c, d)
    v3 = signed_vol(a, b, o, d)
    v4 = signed_vol(a, b, c, o)
    eps = 1e-10
    nondegen = jnp.abs(v0) > eps
    same_pos = (v1 >= -eps) & (v2 >= -eps) & (v3 >= -eps) & (v4 >= -eps)
    same_neg = (v1 <= eps) & (v2 <= eps) & (v3 <= eps) & (v4 <= eps)
    return nondegen & jnp.where(v0 > 0, same_pos, same_neg)


def closest_point_origin_to_hull(points):
    """Exact closest point to the origin in conv(points).

    points: [..., K, 3] → (closest_point [..., 3], dist [...]).

    Replaces the reference's openGJK query
    (closestPointsBetweenPointAndConvexHull, include/geometry.hpp:266-296).
    Exact and odd under points → −points, so the two agents of a
    reciprocal pair compute exactly mirrored LSC normals.
    """
    K = points.shape[-2]
    pairs, triples, quads = _simplex_indices(K)

    # vertices
    cand_pts = [points]  # [..., K, 3]

    # edges
    if len(pairs):
        a = points[..., pairs[:, 0], :]
        b = points[..., pairs[:, 1], :]
        cand_pts.append(closest_point_on_segment(jnp.zeros_like(a), a, b))

    # triangles
    if len(triples):
        a = points[..., triples[:, 0], :]
        b = points[..., triples[:, 1], :]
        c = points[..., triples[:, 2], :]
        cand_pts.append(_closest_on_triangle_to_origin(a, b, c))

    cand = jnp.concatenate(cand_pts, axis=-2)
    d2 = jnp.sum(cand * cand, axis=-1)
    idx = jnp.argmin(d2, axis=-1)
    best = jnp.take_along_axis(cand, idx[..., None, None], axis=-2)[..., 0, :]
    dist = jnp.sqrt(jnp.take_along_axis(d2, idx[..., None], axis=-1)[..., 0])

    # interior: origin inside any tetrahedron → distance 0
    if len(quads):
        a = points[..., quads[:, 0], :]
        b = points[..., quads[:, 1], :]
        c = points[..., quads[:, 2], :]
        d = points[..., quads[:, 3], :]
        inside = jnp.any(_origin_in_tetra(a, b, c, d), axis=-1)
        dist = jnp.where(inside, 0.0, dist)
        best = jnp.where(inside[..., None], jnp.zeros_like(best), best)

    return best, dist


def l_infinity_distance(a, b):
    """Chebyshev distance. Reference: LInfinityDistance, include/util.hpp:122-131."""
    return jnp.max(jnp.abs(a - b), axis=-1)


def ellipsoidal_distance(a, b, downwash):
    """Downwash-scaled distance: z-difference divided by downwash.

    Reference: ellipsoidalDistance, include/util.hpp:155-159.
    """
    d = a - b
    dz = d[..., 2] / downwash
    return jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + dz**2)
