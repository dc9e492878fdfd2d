"""Bernstein-polynomial machinery.

Capability parity with the reference's header-only Bernstein toolbox
(reference: include/polynomial.hpp — basis matrix :281-294, basis eval
:22-24, fitting :65-88, derivative coefficient :90-100) and the QP
builder's constant matrices (reference: src/traj_optimizer.cpp —
jerk-cost base :163-178, junction-continuity base :180-214).

All constant matrices are built once in numpy (static, hashable by
(n, M, dt)) and fed into jitted JAX code as constants; evaluation
helpers are pure jnp and batch over arbitrary leading axes.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np


def binom(n: int, k: int) -> int:
    if k < 0 or k > n:
        return 0
    return math.comb(n, k)


def falling_factorial(i: int, k: int) -> int:
    """i·(i-1)···(i-k+1); 0 when i < k.

    Reference: coef_derivative(), include/polynomial.hpp:90-100.
    """
    if i < k:
        return 0
    out = 1
    for j in range(k):
        out *= i - j
    return out


@functools.lru_cache(maxsize=None)
def basis_matrix(n: int) -> np.ndarray:
    """Monomial-coefficient matrix B of the degree-n Bernstein basis.

    Row i holds the monomial coefficients of b_{i,n}(t), so for control
    points c (shape [n+1]), the monomial coefficients of the curve are
    cᵀB. Reference: buildBernsteinBasis, include/polynomial.hpp:281-294.
    """
    B = np.zeros((n + 1, n + 1), dtype=np.float64)
    for i in range(n + 1):
        for j in range(i, n + 1):
            B[i, j] = binom(n, i) * binom(n - i, n - j) * (-1.0) ** (j - i)
    return B


@functools.lru_cache(maxsize=None)
def basis_matrix_inv(n: int) -> np.ndarray:
    return np.linalg.inv(basis_matrix(n))


@functools.lru_cache(maxsize=None)
def subsegment_matrix(n: int, t0: float, tf: float) -> np.ndarray:
    """Matrix S with c' = cᵀS re-parameterizing a Bézier segment to the
    normalized sub-interval [t0, tf] (t ↦ a·t + b, a = tf−t0, b = t0).

    Key op for DLSC sub-step replanning.
    Reference: Segment::subSegment, src/trajectory.cpp:14-49
    (C' = C·B·A·B⁻¹ with A_ij = C(i,j)·aʲ·b^(i−j)).
    """
    a, b = tf - t0, t0
    A = np.zeros((n + 1, n + 1), dtype=np.float64)
    for i in range(n + 1):
        for j in range(i + 1):
            A[i, j] = binom(i, j) * (a**j) * (b ** (i - j))
    return basis_matrix(n) @ A @ basis_matrix_inv(n)


def bernstein_basis(n: int, tau):
    """Bernstein basis values b_{i,n}(tau) for i = 0..n.

    tau: array of any shape in [0, 1]; returns shape tau.shape + (n+1,).
    Reference: getBernsteinBasis, include/polynomial.hpp:22-24.
    """
    tau = jnp.asarray(tau)
    i = jnp.arange(n + 1)
    coeff = jnp.asarray([binom(n, k) for k in range(n + 1)], dtype=tau.dtype)
    t = tau[..., None]
    # guard 0**0 at the interval ends
    ti = jnp.where(i == 0, 1.0, t**i)
    si = jnp.where(i == n, 1.0, (1.0 - t) ** (n - i))
    return coeff * ti * si


def fit_bernstein(target: jnp.ndarray, taus: jnp.ndarray) -> jnp.ndarray:
    """Control points of the degree-(len(taus)-1) Bézier interpolating
    `target` at normalized times `taus`.

    target: [..., n+1, D], taus: [n+1]. Reference: bernsteinFitting,
    include/polynomial.hpp:65-88.
    """
    n = taus.shape[0] - 1
    G = bernstein_basis(n, taus)  # [n+1, n+1]; row i = basis at taus[i]
    return jnp.linalg.solve(G, target)


@functools.lru_cache(maxsize=None)
def jerk_cost_matrix(n: int, phi: int, phi_n: int, dt: float) -> np.ndarray:
    """Per-segment control-input cost base Q so the segment cost is cᵀQc
    (per spatial dimension), integrating the squared phi-th derivative.

    Reference: TrajOptimizer::buildQBase, src/traj_optimizer.cpp:163-178
    (Q = Σ_k B Z Bᵀ · dt^(1−2k), k = phi .. phi−phi_n+1).
    """
    B = basis_matrix(n)
    Q = np.zeros((n + 1, n + 1), dtype=np.float64)
    for k in range(phi, phi - phi_n, -1):
        Z = np.zeros((n + 1, n + 1), dtype=np.float64)
        for i in range(n + 1):
            for j in range(n + 1):
                if i + j - 2 * k + 1 > 0:
                    Z[i, j] = (
                        falling_factorial(i, k)
                        * falling_factorial(j, k)
                        / (i + j - 2 * k + 1)
                    )
        Q += (B @ Z @ B.T) * dt ** (-2 * k + 1)
    return Q


@functools.lru_cache(maxsize=None)
def endpoint_difference_matrices(n: int) -> tuple:
    """(A0, AT): row j maps control points to the j-th forward/backward
    difference at the segment start/end, so that
    p^(j)(0) = n!/(n−j)! · dt^(−j) · (A0 @ c)[j]   (and analogously at 1).

    General-n version of the reference's hard-coded n=5 matrices
    (src/traj_optimizer.cpp:184-197).
    """
    A0 = np.zeros((n + 1, n + 1), dtype=np.float64)
    AT = np.zeros((n + 1, n + 1), dtype=np.float64)
    for j in range(n + 1):
        for i in range(j + 1):
            c = (-1.0) ** (j - i) * binom(j, i)
            A0[j, i] = c
            AT[j, n - j + i] = c
    return A0, AT


@functools.lru_cache(maxsize=None)
def continuity_matrix(M: int, n: int, phi: int, dt: float) -> np.ndarray:
    """Junction C^(phi-1)... continuity rows for segments m = 2..M−1:
    shape [(M−2)·phi, M·(n+1)], acting on a flattened per-dimension
    control-point vector. Row block m−2 enforces the first `phi`
    derivatives matching between segment m−1's end and segment m's start.

    Reference: TrajOptimizer::buildAeqBase, src/traj_optimizer.cpp:199-214.
    """
    A0, AT = endpoint_difference_matrices(n)
    out = np.zeros(((M - 2) * phi, M * (n + 1)), dtype=np.float64)
    for m in range(2, M):
        nn = 1.0
        for j in range(phi):
            row = phi * (m - 2) + j
            out[row, (n + 1) * (m - 1) : (n + 1) * m] = dt ** (-j) * nn * AT[j]
            out[row, (n + 1) * m : (n + 1) * (m + 1)] = -(dt ** (-j)) * nn * A0[j]
            nn *= n - j
    return out


@functools.lru_cache(maxsize=None)
def derivative_matrix(n: int, dt: float) -> np.ndarray:
    """D with c' = Dᵀ… mapping degree-n control points to degree-(n−1)
    derivative control points: d_i = n/dt · (c_{i+1} − c_i). Shape [n, n+1].
    """
    D = np.zeros((n, n + 1), dtype=np.float64)
    for i in range(n):
        D[i, i] = -n / dt
        D[i, i + 1] = n / dt
    return D


def min_distance_between_curves(
    rel_ctrl: jnp.ndarray, n_grid: int = 64, n_bisect: int = 30
):
    """Closest approach of two same-degree Bézier curves over t ∈ [0, 1],
    computed from the relative control points `rel_ctrl` [..., n+1, D].
    Returns (distance [...], closest_point [..., D]) with the closest
    point expressed in the relative frame.

    Reference: distanceBetweenPolys + realRootIsolation,
    include/polynomial.hpp:109-279 — Descartes-rule bisection queue
    isolating the real roots of g = f·f′ (f(t) = rel(t), g scalar of
    degree 2n−1), bisection refinement of each negative→positive
    crossing (a local minimum of ‖f‖²), then the closest of those
    candidates, falling back to the nearer endpoint when no interior
    minimum exists.

    Batched design: the dynamic isolation queue becomes a static
    sign-change scan of g over a fixed n_grid-cell grid (g has ≤ 2n−1
    real roots; 64 cells isolate any minima separated by > 1/64 of the
    segment), each cell refined by fixed-count branch-free bisection and
    reduced with a masked min — identical candidate set, static shapes,
    no data-dependent control flow, batched over any leading axes.
    """
    rel_ctrl = jnp.asarray(rel_ctrl)
    n = rel_ctrl.shape[-2] - 1
    dtype = rel_ctrl.dtype
    B = jnp.asarray(basis_matrix(n), dtype)  # [n+1, n+1]

    # monomial coefficients of f and f': coef[..., j, D]
    coef = jnp.einsum("...id,ij->...jd", rel_ctrl, B)
    j = jnp.arange(1, n + 1, dtype=dtype)
    dcoef = coef[..., 1:, :] * j[:, None]  # [..., n, D]

    # g = f · f' — polynomial product summed over the spatial dimension:
    # g_k = Σ_{j0+j1=k} coef[j0]·dcoef[j1], degree 2n−1 (2n coefficients)
    deg_g = 2 * n - 1
    batch = rel_ctrl.shape[:-2]
    g = jnp.zeros(batch + (deg_g + 1,), dtype)
    for j0 in range(n + 1):
        for j1 in range(n):
            g = g.at[..., j0 + j1].add(
                jnp.sum(coef[..., j0, :] * dcoef[..., j1, :], axis=-1)
            )

    def eval_poly(c, t):
        # Horner over the last coefficient axis; t broadcast against batch
        out = c[..., -1]
        for k in range(c.shape[-1] - 2, -1, -1):
            out = out * t + c[..., k]
        return out

    # sign-change scan: cells [s, s+1]/n_grid with g(a) < 0 < g(b)
    ts = jnp.linspace(0.0, 1.0, n_grid + 1, dtype=dtype)
    gs = eval_poly(g[..., None, :], ts)  # [..., n_grid+1]
    has_min = (gs[..., :-1] < 0) & (gs[..., 1:] > 0)  # [..., n_grid]

    a = jnp.broadcast_to(ts[:-1], batch + (n_grid,)).astype(dtype)
    b = jnp.broadcast_to(ts[1:], batch + (n_grid,)).astype(dtype)
    g_cell = g[..., None, :]  # broadcast coefficients against the cell axis
    for _ in range(n_bisect):
        m = 0.5 * (a + b)
        gm = eval_poly(g_cell, m)
        a = jnp.where(gm < 0, m, a)
        b = jnp.where(gm < 0, b, m)
    t_cand = 0.5 * (a + b)  # [..., n_grid]

    # candidate points on the relative curve
    basis = bernstein_basis(n, t_cand)  # [..., n_grid, n+1]
    p_cand = jnp.einsum("...si,...id->...sd", basis, rel_ctrl)
    d_cand = jnp.linalg.norm(p_cand, axis=-1)
    d_cand = jnp.where(has_min, d_cand, jnp.inf)
    best = jnp.argmin(d_cand, axis=-1)
    d_int = jnp.take_along_axis(d_cand, best[..., None], -1)[..., 0]
    p_int = jnp.take_along_axis(p_cand, best[..., None, None], -2)[..., 0, :]

    # endpoint fallback (reference: the nearer endpoint when no interior
    # local minimum was isolated, polynomial.hpp:262-272)
    p0, p1 = rel_ctrl[..., 0, :], rel_ctrl[..., n, :]
    d0, d1 = jnp.linalg.norm(p0, axis=-1), jnp.linalg.norm(p1, axis=-1)
    p_end = jnp.where((d0 < d1)[..., None], p0, p1)
    d_end = jnp.minimum(d0, d1)

    any_int = jnp.any(has_min, axis=-1)
    dist = jnp.where(any_int, d_int, d_end)
    point = jnp.where(any_int[..., None], p_int, p_end)
    return dist, point


@functools.lru_cache(maxsize=None)
def uncertainty_growth_ctrl(n: int, dt: float, max_acc: float, m: int) -> np.ndarray:
    """Control points (degree n) of the per-segment radius-growth polynomial
    0.5·a·(m·dt + t·dt)² − 0.5·a·(m·dt)²-free form used for obstacle size
    inflation: p(τ) = ½a(m·dt)² + a·m·dt·dt·τ + ½a·dt²·τ².

    Reference: obstacleSizePredictionWithConstAcc,
    src/traj_planner.cpp:321-358 (monomial coeffs × B⁻¹).
    """
    coef = np.zeros(n + 1, dtype=np.float64)
    coef[0] = 0.5 * max_acc * (m * dt) ** 2
    coef[1] = max_acc * m * dt * dt
    coef[2] = 0.5 * max_acc * dt**2
    return coef @ basis_matrix_inv(n)
