"""Batched trajectory QP — the batched replacement for per-agent CPLEX.

Solves, for every agent at once, the reference's control-point QP
(reference: TrajOptimizer::solve/populatebyrow,
src/traj_optimizer.cpp:18-156, 216-514):

    min  w_ci Σ_m c_mᵀ Q c_m  +  w_term Σ_{terminal m} ‖c_{m,n} − g‖²
    s.t. c_{0,0..2} pinned to the initial state
         C²-continuity at segment junctions
         stop-at-horizon (LSC mode)
         LSC half-spaces per (obstacle, segment, ctrl point)
         |vel|, |acc| control-point bounds
         communication-range pair coupling
         world ∩ SFC ∩ waypoint-range variable bounds

Batched solver design:

  * ALL equality constraints (pins, junctions, continuity, stop) are
    data-independent per spatial dimension, so they are eliminated
    offline through a static orthonormal nullspace basis: x = x_p + N·ξ.
    Equalities hold exactly (to matmul precision), the reduced problem
    is inequality-only, and the ADMM KKT matrix is well-conditioned in
    float32 (the reference instead pins them as CPLEX rows,
    traj_optimizer.cpp:318-353).
  * The reduced problem is solved by OSQP-style ADMM with a per-agent
    dense KKT factored once by batched Cholesky, fixed-bound iteration
    loop with primal+dual convergence masking, vmapped over the fleet —
    one fused batched solve per planning step.
  * Warm-started from the initial trajectory (feasible by LSC
    construction), so steady-state replanning converges in few
    iterations. Non-converged agents are reported so the caller applies
    the reference's failsafe (keep the initial trajectory,
    traj_planner.cpp:795-797).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lsc_dr_planner_tpu.ops import bernstein

_INF = 1e20


class QPConfig(NamedTuple):
    dim: int
    M: int
    n: int
    phi: int
    n_obs: int  # padded obstacle slots O
    use_comm: bool
    stop_at_horizon: bool
    dt: float
    control_input_weight: float
    terminal_weight: float
    rho: float
    rho_eq: float  # unused (equalities are eliminated); kept for config parity
    sigma: float
    alpha: float
    max_iter: int
    eps_abs: float
    # masked-compaction rescue: agents still infeasible after max_iter
    # are gathered into a small batch and iterated up to rescue_iter
    # more (0 disables). The bench stragglers are slow convergers, not
    # infeasible — 1000 iterations converge 0.999 of them.
    rescue_iter: int = 0

    @property
    def N(self):
        return self.n + 1

    @property
    def n_vars(self):
        return self.dim * self.M * self.N


class QPInputs(NamedTuple):
    """Per-agent problem data; every leaf has a leading agent axis."""

    p0: jnp.ndarray  # [A, dim]
    v0: jnp.ndarray  # [A, dim]
    a0: jnp.ndarray  # [A, dim]
    goal: jnp.ndarray  # [A, dim]
    terminal_mask: jnp.ndarray  # [A, M] ∈ {0,1}: segments with goal cost
    lsc_normals: jnp.ndarray  # [A, O, M, dim]
    lsc_rhs: jnp.ndarray  # [A, O, M, N]  (n·anchor + margin, dim-restricted)
    lsc_active: jnp.ndarray  # [A, O, M, N] bool
    vmax: jnp.ndarray  # [A, dim]
    amax: jnp.ndarray  # [A, dim]
    lb: jnp.ndarray  # [A, dim, M, N]
    ub: jnp.ndarray  # [A, dim, M, N]
    comm_halfrange: jnp.ndarray  # [A] (0.5·R − r; big disables)
    x0: jnp.ndarray  # [A, dim, M, N] warm start (initial trajectory)
    y0: jnp.ndarray = None  # [A, R] optional dual warm start (None = cold)


class QPResult(NamedTuple):
    x: jnp.ndarray  # [A, dim, M, N] control points
    converged: jnp.ndarray  # [A] bool
    primal_residual: jnp.ndarray  # [A] max constraint violation (unscaled)
    iterations: jnp.ndarray  # [A] int
    objective: jnp.ndarray  # [A]
    z: jnp.ndarray = None  # [A, R] final slack rows (reduced coords)
    y: jnp.ndarray = None  # [A, R] final duals — next step's warm start


# ----------------------------------------------------------------------
# static equality elimination
# ----------------------------------------------------------------------


def pinned_values(cfg: QPConfig, p0, v0, a0):
    """Exact initial control points from the initial state:
    c0 = p, c1 = p + dt/n·v, c2 = dt²/(n(n−1))·a + 2c1 − c0."""
    n, dt = cfg.n, cfg.dt
    c0 = p0
    c1 = p0 + v0 * (dt / n)
    c2 = a0 * (dt * dt / (n * (n - 1))) + 2 * c1 - c0
    return jnp.stack([c0, c1, c2], axis=-1)  # [..., dim, phi]


def apply_pin(cfg: QPConfig, x, pins):
    return x.at[..., 0, : cfg.phi].set(pins)


@functools.lru_cache(maxsize=None)
def _equality_basis(M: int, n: int, phi: int, dt: float, stop: bool):
    """Per-dimension equality system E x = e over the flattened segment
    control points (x ∈ R^{M·(n+1)}), with e = [0,…,0, pinned values].

    Returns (N_null [MN, K] orthonormal nullspace basis,
             X_pin [MN, phi] particular-solution map from pin values).
    """
    NN = n + 1
    MN = M * NN

    def idx(m, i):
        return m * NN + i

    rows = []
    # junction between segments 0 and 1: pos / vel / acc differences
    r = np.zeros(MN)
    r[idx(0, n)] = 1
    r[idx(1, 0)] = -1
    rows.append(r)
    r = np.zeros(MN)
    r[idx(1, 1)] = 1
    r[idx(1, 0)] = -1
    r[idx(0, n)] = -1
    r[idx(0, n - 1)] = 1
    rows.append(r)
    r = np.zeros(MN)
    r[idx(1, 2)] = 1
    r[idx(1, 1)] = -2
    r[idx(1, 0)] = 1
    r[idx(0, n)] = -1
    r[idx(0, n - 1)] = 2
    r[idx(0, n - 2)] = -1
    rows.append(r)
    # junctions m = 2..M-1
    rows.extend(bernstein.continuity_matrix(M, n, phi, dt))
    # stop at horizon
    if stop:
        for i in range(1, phi):
            r = np.zeros(MN)
            r[idx(M - 1, n)] = 1
            r[idx(M - 1, n - i)] = -1
            rows.append(r)
    E_static = np.asarray(rows)
    pinrows = np.zeros((phi, MN))
    for i in range(phi):
        pinrows[i, idx(0, i)] = 1
    E = np.vstack([E_static, pinrows])

    _, s, vt = np.linalg.svd(E)
    rank = int((s > 1e-9).sum())
    N_null = vt[rank:].T  # orthonormal columns

    # Particular solution X_pin: minimum-JERK trajectory satisfying the
    # equalities (not the min-norm one — the pseudo-inverse solution has
    # large jerk, which poisons the reduced linear cost q_ξ and the
    # ADMM's relative dual tolerance).
    P_reg = np.kron(np.eye(M), bernstein.jerk_cost_matrix(n, phi, 1, dt)) + 1e-6 * np.eye(MN)
    neq = E.shape[0]
    KKT = np.block([[P_reg, E.T], [E, np.zeros((neq, neq))]])
    rhs = np.zeros((MN + neq, phi))
    rhs[MN + E_static.shape[0] :, :] = np.eye(phi)
    X_pin = np.linalg.solve(KKT, rhs)[:MN]
    return N_null, X_pin


def reduced_dim(cfg: QPConfig) -> int:
    N_null, _ = _equality_basis(cfg.M, cfg.n, cfg.phi, cfg.dt, cfg.stop_at_horizon)
    return cfg.dim * N_null.shape[1]


def n_rows(cfg: QPConfig) -> int:
    """Total inequality rows per agent (the dual-vector length)."""
    return sum(row_blocks(cfg).values())


# ----------------------------------------------------------------------
# structured inequality operator (single agent; vmapped by the solver)
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _comm_pairs(M: int):
    pairs = [(mi, m) for mi in range(M) for m in range(mi, M)]
    a = np.asarray(pairs, dtype=np.int32)
    return a[:, 0], a[:, 1]


def row_blocks(cfg: QPConfig):
    """Static row counts per inequality family, in flat-vector order."""
    dim, M, n, N = cfg.dim, cfg.M, cfg.n, cfg.N
    return {
        "lsc": cfg.n_obs * M * N,
        "vel": dim * M * n,
        "acc": dim * M * (n - 1),
        "comm": dim * (M * (M + 1) // 2) if cfg.use_comm else 0,
        "bound": dim * M * N,
    }


def constraint_rows(cfg: QPConfig, x, lsc_normals):
    """A·x as a flat vector; x: [dim, M, N] (full control-point tensor)."""
    dim, M, n, N = cfg.dim, cfg.M, cfg.n, cfg.N
    rows = []
    # LSC: Σ_k n_k·x[k, m, i]
    rows.append(jnp.einsum("omk,kmi->omi", lsc_normals, x).reshape(-1))
    # velocity first differences (unit row scale)
    rows.append((x[..., 1:] - x[..., :-1]).reshape(-1))
    # acceleration second differences
    rows.append((x[..., 2:] - 2 * x[..., 1:-1] + x[..., :-2]).reshape(-1))
    # communication pairs
    if cfg.use_comm:
        mi, mm = _comm_pairs(M)
        rows.append((x[:, mm, n] - x[:, mi, 0]).reshape(-1))
    # variable bounds (identity)
    rows.append(x.reshape(-1))
    return jnp.concatenate(rows)


# Per-family ρ multipliers, roughly ∝ 1/(feasible row range): the raw
# velocity/acceleration caps are ~4e-2/4e-3 while LSC/bound rows are
# O(0.1–1) — uniform ρ leaves the narrow rows with large relative
# violations in f32. Tuned on saturated forest10 instances (residuals
# drop to ~0 with these).
_RHO_SCALE = {"lsc": 10.0, "vel": 100.0, "acc": 500.0, "comm": 1.0, "bound": 5.0}


def constraint_bounds(cfg: QPConfig, inp_leaf):
    """(l, u, rho) flat row vectors for ONE agent (inequalities only)."""
    dim, M, n, N, phi = cfg.dim, cfg.M, cfg.n, cfg.N, cfg.phi
    dt = cfg.dt
    dtype = inp_leaf.p0.dtype
    ls, us, rs = [], [], []

    def add(l, u, rho):
        ls.append(l.reshape(-1))
        us.append(u.reshape(-1))
        rs.append(jnp.full(l.size, rho, dtype=dtype))

    # LSC
    lsc_l = jnp.where(inp_leaf.lsc_active, inp_leaf.lsc_rhs, -_INF)
    add(lsc_l, jnp.full_like(lsc_l, _INF), cfg.rho * _RHO_SCALE["lsc"])

    # velocity: |Δ| ≤ vmax·dt/n; skip m=0, i<2 (involves pinned points).
    # Caps carry a 5% robustness buffer so ε-accurate ADMM solutions stay
    # within the true dynamic limits (the audited excess ratio must be 0;
    # the reference's exact simplex needs no buffer).
    vcap = (0.95 * inp_leaf.vmax * dt / n)[:, None, None] * jnp.ones((dim, M, n), dtype)
    vmask = np.ones((M, n), dtype=bool)
    vmask[0, :2] = False
    vcap = jnp.where(jnp.asarray(vmask)[None], vcap, _INF)
    add(-vcap, vcap, cfg.rho * _RHO_SCALE["vel"])

    # acceleration: |Δ²| ≤ amax·dt²/(n(n−1)); skip m=0, i=0
    acap = (0.95 * inp_leaf.amax * dt * dt / (n * (n - 1)))[
        :, None, None
    ] * jnp.ones((dim, M, n - 1), dtype)
    amask = np.ones((M, n - 1), dtype=bool)
    amask[0, 0] = False
    acap = jnp.where(jnp.asarray(amask)[None], acap, _INF)
    add(-acap, acap, cfg.rho * _RHO_SCALE["acc"])

    if cfg.use_comm:
        npairs = M * (M + 1) // 2
        ccap = jnp.broadcast_to(
            inp_leaf.comm_halfrange, (dim, npairs)
        ).astype(dtype)
        add(-ccap, ccap, cfg.rho * _RHO_SCALE["comm"])

    # bounds; pinned entries vacuous (their value is fixed by elimination)
    pm = np.zeros((dim, M, N), dtype=bool)
    pm[:, 0, :phi] = True
    lb = jnp.where(jnp.asarray(pm), -_INF, inp_leaf.lb)
    ub = jnp.where(jnp.asarray(pm), _INF, inp_leaf.ub)
    add(lb, ub, cfg.rho * _RHO_SCALE["bound"])

    return jnp.concatenate(ls), jnp.concatenate(us), jnp.concatenate(rs)


# ----------------------------------------------------------------------
# cost
# ----------------------------------------------------------------------


def cost_matrices(cfg: QPConfig, inp_leaf):
    """(P_seg [N,N] jerk block, tdiag [M] terminal diagonal, q [dim,M,N])."""
    dtype = inp_leaf.p0.dtype
    M, n, N = cfg.M, cfg.n, cfg.N
    Q = jnp.asarray(bernstein.jerk_cost_matrix(n, cfg.phi, 1, cfg.dt), dtype=dtype)
    P_seg = 2.0 * cfg.control_input_weight * Q
    tdiag = 2.0 * cfg.terminal_weight * inp_leaf.terminal_mask  # [M]
    q = jnp.zeros((cfg.dim, M, N), dtype=dtype)
    q = q.at[:, :, n].set(
        -2.0
        * cfg.terminal_weight
        * inp_leaf.terminal_mask[None, :]
        * inp_leaf.goal[:, None]
    )
    return P_seg, tdiag, q


# ----------------------------------------------------------------------
# solver
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _solver_statics(cfg: QPConfig):
    """Everything data-independent, in numpy, shared across the fleet.

    The reduced constraint operator is never materialised per agent: the
    static families (vel/acc/comm/bound) are evaluated structurally
    (first/second differences, gathers) and the LSC family through one
    einsum with the per-step normals, so every per-iteration matmul is a
    shared-matrix GEMM over the batch — the MXU-friendly shape — instead
    of an [A, rows, vars] batched matvec.
    """
    M, n, N = cfg.M, cfg.n, cfg.N
    MN = M * N
    N_null, X_pin = _equality_basis(M, n, cfg.phi, cfg.dt, cfg.stop_at_horizon)
    K = N_null.shape[1]
    N3 = N_null.reshape(M, N, K)

    # reduced jerk-cost base (per dim) and terminal outer products
    P_base = np.kron(
        np.eye(M),
        2.0 * cfg.control_input_weight
        * bernstein.jerk_cost_matrix(n, cfg.phi, 1, cfg.dt),
    )  # [MN, MN]
    Pn_base = N_null.T @ P_base @ N_null  # [K, K]
    T_term = np.einsum("mk,ml->mkl", N3[:, n, :], N3[:, n, :])  # [M, K, K]

    # LSC Gram reduction tensor: Σ_i N3[m,i,:] ⊗ N3[m,i,:]
    T_lsc = np.einsum("mik,mil->mkl", N3, N3)  # [M, K, K]

    # static families on the nullspace basis (per dim), with their ρ,
    # in the same family order as constraint_bounds
    rows = []
    rhos = []
    for m in range(M):
        for i in range(n):
            r = np.zeros(MN)
            r[m * N + i + 1] = 1
            r[m * N + i] = -1
            rows.append(r)
            rhos.append(cfg.rho * _RHO_SCALE["vel"])
    for m in range(M):
        for i in range(n - 1):
            r = np.zeros(MN)
            r[m * N + i + 2] = 1
            r[m * N + i + 1] = -2
            r[m * N + i] = 1
            rows.append(r)
            rhos.append(cfg.rho * _RHO_SCALE["acc"])
    Smm = Smi = None
    if cfg.use_comm:
        mi_arr, mm_arr = _comm_pairs(M)
        P = len(mi_arr)
        Smm = np.zeros((M, P))
        Smi = np.zeros((M, P))
        for p, (mi, mm) in enumerate(zip(mi_arr, mm_arr)):
            r = np.zeros(MN)
            r[mm * N + n] += 1
            r[mi * N + 0] -= 1
            rows.append(r)
            rhos.append(cfg.rho * _RHO_SCALE["comm"])
            Smm[mm, p] = 1.0
            Smi[mi, p] = 1.0
    rows.extend(np.eye(MN))
    rhos.extend([cfg.rho * _RHO_SCALE["bound"]] * MN)
    A_dim = np.asarray(rows)  # [R_dim, MN]
    rho_dim = np.asarray(rhos)
    An_sd = A_dim @ N_null
    G_stat = (An_sd.T * rho_dim) @ An_sd  # [K, K], identical per dim

    # materialised static families in reduced coords, family-major with
    # dim-major rows inside each family (constraint_bounds's flat layout)
    n_vel, n_acc = M * n, M * (n - 1)
    n_comm = M * (M + 1) // 2 if cfg.use_comm else 0
    eye_d = np.eye(cfg.dim)
    blocks = []
    off = 0
    for cnt in (n_vel, n_acc, n_comm, MN):
        if cnt:
            blocks.append(np.kron(eye_d, An_sd[off:off + cnt]))
        off += cnt
    An_stat = np.vstack(blocks)  # [dim·R_dim, dim·K]

    return {
        "N_null": N_null, "X_pin": X_pin, "N3": N3, "K": K,
        "P_base": P_base, "Pn_base": Pn_base, "T_term": T_term,
        "T_lsc": T_lsc, "G_stat": G_stat, "Smm": Smm, "Smi": Smi,
        "An_stat": An_stat, "An_sd": An_sd,
    }


def _rows_batched(cfg: QPConfig, x, normals):
    """Batched `constraint_rows`: x [A,dim,M,N], normals [A,O,M,dim] → [A,R]."""
    A = x.shape[0]
    dim, M, n = cfg.dim, cfg.M, cfg.n
    out = [jnp.einsum("aomk,akmi->aomi", normals, x).reshape(A, -1)]
    out.append((x[..., 1:] - x[..., :-1]).reshape(A, -1))
    out.append((x[..., 2:] - 2 * x[..., 1:-1] + x[..., :-2]).reshape(A, -1))
    if cfg.use_comm:
        mi, mm = _comm_pairs(M)
        out.append((x[:, :, mm, n] - x[:, :, mi, 0]).reshape(A, -1))
    out.append(x.reshape(A, -1))
    return jnp.concatenate(out, axis=-1)


def _rows_adjoint(cfg: QPConfig, y, normals, statics):
    """Adjoint of `_rows_batched`: y [A,R] → x-space cotangent [A,dim,M,N]."""
    A = y.shape[0]
    dim, M, n, N = cfg.dim, cfg.M, cfg.n, cfg.N
    nb = row_blocks(cfg)
    off = 0
    yl = y[:, off:off + nb["lsc"]].reshape(A, cfg.n_obs, M, N)
    off += nb["lsc"]
    yv = y[:, off:off + nb["vel"]].reshape(A, dim, M, n)
    off += nb["vel"]
    ya = y[:, off:off + nb["acc"]].reshape(A, dim, M, n - 1)
    off += nb["acc"]
    yc = None
    if cfg.use_comm:
        yc = y[:, off:off + nb["comm"]].reshape(A, dim, -1)
        off += nb["comm"]
    yb = y[:, off:off + nb["bound"]].reshape(A, dim, M, N)

    adj = jnp.einsum("aomk,aomi->akmi", normals, yl) + yb
    pad = lambda v, lo, hi: jnp.pad(v, ((0, 0), (0, 0), (0, 0), (lo, hi)))
    adj += pad(yv, 1, 0) - pad(yv, 0, 1)
    adj += pad(ya, 2, 0) - 2 * pad(ya, 1, 1) + pad(ya, 0, 2)
    if yc is not None:
        Smm = jnp.asarray(statics["Smm"], y.dtype)
        Smi = jnp.asarray(statics["Smi"], y.dtype)
        adj = adj.at[..., n].add(jnp.einsum("mp,adp->adm", Smm, yc))
        adj = adj.at[..., 0].add(-jnp.einsum("mp,adp->adm", Smi, yc))
    return adj




def default_loop() -> str:
    """The ADMM loop `solve` runs when none is named: the Triton kernel
    on a GPU backend, the XLA loop elsewhere."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def solve(cfg: QPConfig, inputs: QPInputs, feas_tol: float = 5e-3,
          loop: str | None = None) -> QPResult:
    """Solve all agents' QPs in one fused batched ADMM.

    `loop` picks the iteration loop: "xla" (the reference), "triton"
    (ops/qp_pallas.py compiled for the GPU), "interpret" (the same
    kernel interpreted on the CPU, for tests), or None for
    `default_loop()`.

    OSQP-style iteration on the equality-reduced variables ξ (x = x_p +
    N·ξ per dim), with:
      * the KKT matrix assembled from Kronecker structure (static-family
        Gram precomputed once; the LSC Gram from one tiny per-segment
        outer-product contraction) and inverted ONCE by batched Cholesky,
        so each iteration is a single [A, dk, dk] matvec plus
        structural constraint evaluations — no per-iteration triangular
        solves, no materialised [A, rows, vars] constraint matrix;
      * early exit when every agent is feasible (row-scaled residual,
        the same gate the caller uses) and either dual-optimal to a
        relative tolerance or stalled at the f32 ADMM floor (Δξ ≈ 0 —
        further iterations provably change nothing).
    """
    st = _solver_statics(cfg)
    dtype = inputs.p0.dtype
    A = inputs.p0.shape[0]
    dim, M, n, N = cfg.dim, cfg.M, cfg.n, cfg.N
    MN = M * N
    K = st["K"]
    N_null = jnp.asarray(st["N_null"], dtype)  # [MN, K]
    X_pin = jnp.asarray(st["X_pin"], dtype)  # [MN, phi]

    pins = pinned_values(cfg, inputs.p0, inputs.v0, inputs.a0)  # [A, dim, phi]
    xpart = jnp.einsum("vp,adp->adv", X_pin, pins)  # [A, dim, MN]
    xpart3 = xpart.reshape(A, dim, M, N)

    l, u, rho = jax.vmap(lambda leaf: constraint_bounds(cfg, leaf))(inputs)
    b_off = _rows_batched(cfg, xpart3, inputs.lsc_normals)
    ln, un = l - b_off, u - b_off

    # ---- reduced cost -------------------------------------------------
    P_base = jnp.asarray(st["P_base"], dtype)  # [MN, MN]
    tdiag = 2.0 * cfg.terminal_weight * inputs.terminal_mask  # [A, M]
    tvec = jnp.zeros((A, M, N), dtype).at[:, :, n].set(tdiag).reshape(A, 1, MN)
    q = jnp.zeros((A, dim, M, N), dtype)
    q = q.at[..., n].set(
        -2.0 * cfg.terminal_weight
        * inputs.terminal_mask[:, None, :]
        * inputs.goal[..., None]
    )
    qflat = q.reshape(A, dim, MN)
    Pxp = jnp.einsum("vw,adw->adv", P_base, xpart) + tvec * xpart
    qn = jnp.einsum("vk,adv->adk", N_null, qflat + Pxp)  # [A, dim, K]

    # ---- KKT matrix from Kronecker structure, inverted once -----------
    Pn_dim = (
        jnp.asarray(st["Pn_base"], dtype)[None]
        + jnp.einsum("am,mkl->akl", tdiag, jnp.asarray(st["T_term"], dtype))
    )  # [A, K, K]
    diag_blk = (
        Pn_dim
        + jnp.asarray(st["G_stat"], dtype)[None]
        + cfg.sigma * jnp.eye(K, dtype=dtype)[None]
    )
    S_lsc = jnp.einsum(
        "aomd,aome->amde", inputs.lsc_normals, inputs.lsc_normals
    )  # [A, M, dim, dim]
    G_lsc = (cfg.rho * _RHO_SCALE["lsc"]) * jnp.einsum(
        "amde,mkl->adkel", S_lsc, jnp.asarray(st["T_lsc"], dtype)
    )  # [A, dim, K, dim, K]
    Kmat = G_lsc.at[:, jnp.arange(dim), :, jnp.arange(dim), :].add(
        jnp.broadcast_to(diag_blk[:, None], (A, dim, K, K)).transpose(1, 0, 2, 3)
    ).reshape(A, dim * K, dim * K)
    chol = jnp.linalg.cholesky(Kmat)
    eye_dk = jnp.broadcast_to(jnp.eye(dim * K, dtype=dtype), Kmat.shape)
    Kinv = jax.scipy.linalg.cho_solve((chol, True), eye_dk)  # [A, dk, dk]

    # ---- reduced operators (GEMM-shaped: batch is the GEMM dimension) --
    An_stat = jnp.asarray(st["An_stat"], dtype)  # [R_stat, dim·K]
    N3 = jnp.asarray(st["N3"], dtype)  # [M, N, K]
    normals = inputs.lsc_normals  # [A, O, M, dim]
    R_lsc = cfg.n_obs * M * N

    def fwd(xi):  # ξ [A, dim, K] → rows [A, R] (pin offset excluded)
        c = jnp.einsum("aomd,adk->aomk", normals, xi)
        r_lsc = jnp.einsum("mik,aomk->aomi", N3, c).reshape(A, -1)
        r_stat = xi.reshape(A, -1) @ An_stat.T
        return jnp.concatenate([r_lsc, r_stat], axis=-1)

    def adj(w):  # rows cotangent [A, R] → ξ-space [A, dim, K]
        wl = w[:, :R_lsc].reshape(A, cfg.n_obs, M, N)
        t = jnp.einsum("mik,aomi->aomk", N3, wl)
        g_lsc = jnp.einsum("aomd,aomk->adk", normals, t)
        g_stat = (w[:, R_lsc:] @ An_stat).reshape(A, dim, K)
        return g_lsc + g_stat

    # residual row scale (matches the caller's feasibility gate)
    half_range = 0.5 * (u - l)
    scale = jnp.clip(6.0 * half_range, 0.02, 1.0)

    xi0 = jnp.einsum(
        "vk,adv->adk", N_null, inputs.x0.reshape(A, dim, MN) - xpart
    )
    z0 = fwd(xi0)
    y0 = jnp.zeros_like(z0) if inputs.y0 is None else inputs.y0.astype(dtype)

    def admm_loop(B, normals_b, Kinv_b, Pn_b, qn_b, ln_b, un_b, rho_b,
                  scale_b, xi_i, z_i, y_i, max_iter):
        """The chunked ADMM iteration for a batch of B agents. Returns
        (xi, z, y, itdone, iters)."""
        eps_rel = 1e-3
        stop_tol = 0.6 * feas_tol
        CHUNK = 8
        n_chunks = max(1, -(-max_iter // CHUNK))

        def fwd_b(xi):
            c = jnp.einsum("aomd,adk->aomk", normals_b, xi)
            r_lsc = jnp.einsum("mik,aomk->aomi", N3, c).reshape(B, -1)
            r_stat = xi.reshape(B, -1) @ An_stat.T
            return jnp.concatenate([r_lsc, r_stat], axis=-1)

        def adj_b(w):
            wl = w[:, :R_lsc].reshape(B, cfg.n_obs, M, N)
            t = jnp.einsum("mik,aomi->aomk", N3, wl)
            g_lsc = jnp.einsum("aomd,aomk->adk", normals_b, t)
            g_stat = (w[:, R_lsc:] @ An_stat).reshape(B, dim, K)
            return g_lsc + g_stat

        def one_iter(carry, _):
            xi, z, y, Ax = carry
            rhs = cfg.sigma * xi - qn_b + adj_b(rho_b * z - y)
            xi_t = jnp.einsum(
                "aij,aj->ai", Kinv_b, rhs.reshape(B, -1)
            ).reshape(B, dim, K)
            z_t = fwd_b(xi_t)
            xi_n = cfg.alpha * xi_t + (1 - cfg.alpha) * xi
            z_mix = cfg.alpha * z_t + (1 - cfg.alpha) * z
            z_n = jnp.clip(z_mix + y / rho_b, ln_b, un_b)
            y_n = y + rho_b * (z_mix - z_n)
            # A·ξ of the actual iterate, carried to avoid a second fwd pass
            Ax_n = cfg.alpha * z_t + (1 - cfg.alpha) * Ax
            return (xi_n, z_n, y_n, Ax_n), None

        def chunk_step(state):
            xi_prev, z0, y0, Ax0, ck, itdone, best_obj, noimp, done, _ = state
            (xi, z, y, Ax), _ = jax.lax.scan(
                one_iter, (xi_prev, z0, y0, Ax0), None, length=CHUNK,
                unroll=CHUNK,
            )
            # an agent's iterate freezes at its first certified chunk, so
            # its solution does not depend on which agents share the
            # batch (the Triton kernel exits per agent the same way)
            def keep(new, old):
                return jnp.where(done.reshape((B,) + (1,) * (new.ndim - 1)),
                                 old, new)

            xi, z, y, Ax = (keep(xi, xi_prev), keep(z, z0), keep(y, y0),
                            keep(Ax, Ax0))
            it = (ck + 1) * CHUNK
            # per-agent feasibility of the actual iterate (row-scaled)
            viol = jnp.maximum(jnp.maximum(ln_b - Ax, Ax - un_b), 0.0)
            feas = jnp.max(viol / scale_b, axis=-1) < stop_tol
            # dual residual, relative
            Px = jnp.einsum("akl,adl->adk", Pn_b, xi)
            Aty = adj_b(y)
            rd = jnp.max(jnp.abs(Px + qn_b + Aty).reshape(B, -1), axis=-1)
            dmag = jnp.maximum(
                jnp.max(jnp.abs(Px).reshape(B, -1), axis=-1),
                jnp.maximum(
                    jnp.max(jnp.abs(Aty).reshape(B, -1), axis=-1),
                    jnp.max(jnp.abs(qn_b).reshape(B, -1), axis=-1),
                ),
            )
            opt = rd < cfg.eps_abs + eps_rel * dmag
            # f32 stall: the iterate stopped moving across the whole chunk
            dxi = jnp.max(jnp.abs(xi - xi_prev).reshape(B, -1), axis=-1)
            ximag = jnp.maximum(
                1.0, jnp.max(jnp.abs(xi).reshape(B, -1), axis=-1)
            )
            stalled = dxi < 1e-4 * ximag
            # monotone best-objective patience (robust to ADMM
            # oscillation): a feasible agent whose best objective hasn't
            # improved for two consecutive chunks has nothing measurable
            # left to gain
            obj_now = jnp.einsum("adk,adk->a", 0.5 * Px + qn_b, xi)
            improved = obj_now < best_obj - 2e-4 * jnp.maximum(
                1.0, jnp.abs(obj_now)
            )
            best_obj = jnp.where(feas & improved, obj_now, best_obj)
            noimp = jnp.where(feas & ~improved, noimp + 1, jnp.int32(0))
            done_a = done | (feas & (opt | stalled | (noimp >= 2)))
            itdone = jnp.where(
                done_a & (itdone == max_iter), jnp.int32(it), itdone
            )
            return (
                xi, z, y, Ax, ck + 1, itdone, best_obj, noimp, done_a,
                jnp.all(done_a),
            )

        def cond(state):
            ck, all_done = state[4], state[9]
            return (ck < n_chunks) & jnp.logical_not(all_done)

        never = jnp.full((B,), max_iter, jnp.int32)
        state = (
            xi_i, z_i, y_i, fwd_b(xi_i), jnp.int32(0), never,
            jnp.full((B,), jnp.inf, dtype), jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), bool), jnp.asarray(False),
        )
        xi, z, y, _, ck_f, itdone, _, _, _, _ = jax.lax.while_loop(
            cond, chunk_step, state
        )
        return xi, z, y, itdone, ck_f * CHUNK

    # ---- iteration-loop dispatch: Triton kernel (GPU) or XLA ----------
    if loop is None:
        loop = default_loop()
    if loop not in ("xla", "triton", "interpret"):
        raise ValueError(f"unknown ADMM loop {loop!r}")

    def run_loop(B_, normals_, Kinv_, Pn_, qn_, ln_, un_, rho_, scale_,
                 xi_, z_, y_, max_it):
        if loop == "xla":
            return admm_loop(B_, normals_, Kinv_, Pn_, qn_, ln_, un_,
                             rho_, scale_, xi_, z_, y_, max_it)
        from lsc_dr_planner_tpu.ops import qp_pallas

        return qp_pallas.admm_loop_pallas(
            cfg, st, normals_, Kinv_, Pn_, qn_, ln_, un_, scale_,
            xi_, z_, y_, max_it, feas_tol,
            interpret=(loop == "interpret"),
        )

    xi, z, y, itdone, iters = run_loop(
        A, normals, Kinv, Pn_dim, qn, ln, un, rho, scale,
        xi0, z0, y0, cfg.max_iter,
    )

    # ---- masked-compaction rescue -------------------------------------
    # Stragglers (feasibility still above tolerance at the cap) are slow
    # convergers, not infeasible. Small fleets just
    # keep iterating in place (the early exit makes the extra bound free
    # when it isn't needed); large fleets gather the worst RESCUE agents
    # into a compact batch so 1000-iteration tails don't drag 1024
    # converged agents through the loop with them.
    RESCUE = 64
    if cfg.rescue_iter > 0 and A <= RESCUE:
        xi, z, y, itdone2, iters2 = run_loop(
            A, normals, Kinv, Pn_dim, qn, ln, un, rho, scale,
            xi, z, y, cfg.rescue_iter,
        )
        itdone = jnp.minimum(itdone, cfg.max_iter) + jnp.minimum(
            itdone2, iters2
        )
        iters = iters + iters2
    elif cfg.rescue_iter > 0:
        Axc = fwd(xi)
        violc = jnp.maximum(jnp.maximum(ln - Axc, Axc - un), 0.0)
        resc = jnp.max(violc / scale, axis=-1)
        bad = resc >= 0.6 * feas_tol
        # worst-first compaction (non-stragglers key below every straggler)
        _, idx = jax.lax.top_k(jnp.where(bad, resc, -1.0), RESCUE)
        take = bad[idx]  # rescue slots actually holding stragglers

        def g(t):
            return t[idx]

        xi_r, z_r, y_r, it_r, iters2 = run_loop(
            RESCUE, g(normals), g(Kinv), g(Pn_dim), g(qn), g(ln), g(un),
            g(rho), g(scale), g(xi), g(z), g(y), cfg.rescue_iter,
        )
        sel3 = take[:, None, None]
        xi = xi.at[idx].set(jnp.where(sel3, xi_r, xi[idx]))
        z = z.at[idx].set(jnp.where(take[:, None], z_r, z[idx]))
        y = y.at[idx].set(jnp.where(take[:, None], y_r, y[idx]))
        itdone = itdone.at[idx].add(
            jnp.where(take, jnp.minimum(it_r, iters2), 0)
        )
        iters = iters + iters2

    x = (
        jnp.einsum("vk,adk->adv", N_null, xi) + xpart
    ).reshape(A, dim, M, N)
    Ax = fwd(xi) + b_off
    viol = jnp.maximum(jnp.maximum(l - Ax, Ax - u), 0.0)
    primal_res = jnp.max(viol / scale, axis=-1)

    xf = x.reshape(A, dim, MN)
    obj = (
        0.5 * jnp.einsum("adv,vw,adw->a", xf, P_base, xf)
        + 0.5 * jnp.einsum("adv,adv->a", tvec * xf, xf)
        + jnp.einsum("adv,adv->a", qflat, xf)
    )
    return QPResult(
        x=x,
        converged=primal_res < feas_tol,
        primal_residual=primal_res,
        iterations=jnp.minimum(itdone, iters),
        objective=obj,
        z=z,
        y=y,
    )
