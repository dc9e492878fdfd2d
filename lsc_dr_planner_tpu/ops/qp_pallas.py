"""Pallas GPU kernel (Triton route) for the batched ADMM iteration loop.

On the GPU, XLA runs `ops/qp.py::admm_loop` as a `while_loop` whose
body is eight unrolled iterations of a dozen small fusions, so every
chunk pays many kernel launches plus the loop predicate's trip to the
host, while each iteration moves only a few bytes per agent. This kernel
runs the whole chunked loop, convergence checks and early exit
included, inside one launch.

Design for Hopper:

  * one agent per program (grid over agents): an agent's working set in
    2-D (LSC rows [16, 64], static rows [2, 256], its KKT inverse as
    2×2 blocks of [32, 32]) is ~30 K floats, which the registers of
    eight warps hold; a larger agent block would spill to local memory.
  * the per-iteration products are against the SHARED per-dimension
    operators (`An_sd` [256, 32] for the vel/acc/comm/bound rows, `N3`
    [32, 64] for the LSC rows), read from L1/L2, and the per-agent
    KKT-inverse matvec; all are broadcast-multiply + reduce, because the
    matvec batch of one agent has no GEMM shape for the tensor cores.
  * every axis is padded to a power of two with benign rows (zero
    operator rows, ±inf bounds, unit ρ), which stay exactly zero.
  * every exit gate of the XLA loop is kept — feasibility, relative dual
    residual, iterate stall, objective patience — so the kernel is a
    drop-in for `admm_loop`. Each agent exits on its own; the loop's
    global trip count is the max taken outside the kernel.

The XLA loop stays the reference and the CPU path; `qp.solve(...,
loop=...)` chooses. `interpret=True` runs the kernel on the CPU (tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from lsc_dr_planner_tpu.ops import qp as qpmod

_INF = 1e20
CHUNK = 8  # iterations between convergence checks (matches the XLA loop)
NUM_WARPS = 8


def _p2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _layout(cfg, K: int):
    """Static padding plan and the flat-static-row ↔ per-dim permutation.

    The XLA path lays the static rows out family-major with dim-major
    rows inside each family (`constraint_bounds`); the kernel keeps one
    [dim, RSP] block per dimension in `An_sd` row order. Returns
    (KP, MNP, OP, RSP, to_dim [dim·RSP] gather index into the flat static
    rows with R_stat as the pad sentinel, from_dim [R_stat] gather index
    into the flattened per-dim rows, rho_dim [RSP])."""
    dim, M, n, N = cfg.dim, cfg.M, cfg.n, cfg.N
    counts = [M * n, M * (n - 1)]
    rhos = [qpmod._RHO_SCALE["vel"], qpmod._RHO_SCALE["acc"]]
    if cfg.use_comm:
        counts.append(M * (M + 1) // 2)
        rhos.append(qpmod._RHO_SCALE["comm"])
    counts.append(M * N)
    rhos.append(qpmod._RHO_SCALE["bound"])
    R_dim = sum(counts)
    R_stat = dim * R_dim
    KP, MNP, OP, RSP = _p2(K), _p2(M * N), _p2(cfg.n_obs), _p2(R_dim)

    to_dim = np.full((dim, RSP), R_stat, np.int32)
    from_dim = np.zeros(R_stat, np.int32)
    rho_dim = np.ones(RSP, np.float32)
    fam_off = 0  # offset of the family in the flat static rows
    row_off = 0  # offset of the family in one dimension's rows
    for cnt, rs in zip(counts, rhos):
        rho_dim[row_off:row_off + cnt] = cfg.rho * rs
        for d in range(dim):
            flat = fam_off + d * cnt + np.arange(cnt)
            to_dim[d, row_off:row_off + cnt] = flat
            from_dim[flat] = d * RSP + row_off + np.arange(cnt)
        fam_off += dim * cnt
        row_off += cnt
    return KP, MNP, OP, RSP, to_dim.reshape(-1), from_dim, rho_dim


def admm_loop_pallas(cfg, statics, normals, Kinv, Pn, qn, ln, un,
                     scale, xi0, z0, y0, max_iter: int, feas_tol: float,
                     interpret: bool = False):
    """Drop-in equivalent of ops/qp.py::admm_loop (same inputs in the
    flat row layout, same outputs) running the loop in a Triton kernel.

    normals: [A, O, M, dim]; Kinv: [A, dk, dk]; Pn: [A, K, K];
    qn: [A, dim, K]; ln/un/scale: [A, R]; xi0: [A, dim, K];
    z0/y0: [A, R]. Returns (xi, z, y, itdone, iters_scalar).
    """
    dim, M, N, O = cfg.dim, cfg.M, cfg.N, cfg.n_obs
    MN = M * N
    K = statics["K"]
    A = normals.shape[0]
    R_lsc = O * MN
    f32 = jnp.float32
    KP, MNP, OP, RSP, to_dim, from_dim, rho_dim = _layout(cfg, K)

    def pad_to(x, shape, fill=0.0):
        return jnp.pad(x, [(0, s - d) for d, s in zip(x.shape, shape)],
                       constant_values=fill)

    def lsc_rows(v, fill=0.0):  # [A, R_lsc] → [A, OP, MNP]
        return pad_to(v[:, :R_lsc].reshape(A, O, MN), (A, OP, MNP), fill)

    def stat_rows(v, fill):  # flat static rows → [A, dim, RSP]
        ext = jnp.concatenate(
            [v[:, R_lsc:], jnp.full((A, 1), fill, v.dtype)], axis=-1)
        return ext[:, to_dim].reshape(A, dim, RSP)

    nd = pad_to(jnp.repeat(normals, N, axis=2).transpose(0, 3, 1, 2),
                (A, dim, OP, MNP))
    kinv = pad_to(Kinv.reshape(A, dim, K, dim, K).transpose(0, 1, 3, 2, 4),
                  (A, dim, dim, KP, KP))
    An = np.zeros((RSP, KP), np.float32)
    An[:statics["An_sd"].shape[0], :K] = statics["An_sd"]
    N3k = np.zeros((KP, MNP), np.float32)
    N3k[:K, :MN] = statics["N3"].transpose(2, 0, 1).reshape(K, MN)

    args = (
        nd, kinv, pad_to(Pn, (A, KP, KP)), pad_to(qn, (A, dim, KP)),
        lsc_rows(ln, -_INF), stat_rows(ln, -_INF), stat_rows(un, _INF),
        stat_rows(1.0 / scale, 1.0), pad_to(xi0, (A, dim, KP)),
        lsc_rows(z0), stat_rows(z0, 0.0), lsc_rows(y0), stat_rows(y0, 0.0),
        jnp.asarray(An), jnp.asarray(N3k), jnp.asarray(rho_dim),
    )

    def agent(*shape):  # one agent's block, agent axis squeezed
        return pl.BlockSpec((None,) + shape,
                            lambda i: (i,) + (0,) * len(shape))

    def shared(*shape):
        return pl.BlockSpec(shape, lambda i: (0,) * len(shape))

    kern = functools.partial(
        _admm_agent_kernel, dim=dim, n_chunks=max(1, -(-max_iter // CHUNK)),
        max_iter=max_iter, stop_tol=0.6 * feas_tol, eps_abs=cfg.eps_abs,
        rho_l=float(cfg.rho * qpmod._RHO_SCALE["lsc"]),
        alpha=float(cfg.alpha),
        sigma=float(cfg.sigma),
    )
    out_shapes = [
        ((dim, KP), f32), ((OP, MNP), f32), ((dim, RSP), f32),
        ((OP, MNP), f32), ((dim, RSP), f32), ((1,), jnp.int32),
        ((1,), jnp.int32),
    ]
    outs = pl.pallas_call(
        kern,
        grid=(A,),
        in_specs=[
            agent(dim, OP, MNP), agent(dim, dim, KP, KP), agent(KP, KP),
            agent(dim, KP), agent(OP, MNP), agent(dim, RSP),
            agent(dim, RSP), agent(dim, RSP), agent(dim, KP),
            agent(OP, MNP), agent(dim, RSP), agent(OP, MNP),
            agent(dim, RSP), shared(RSP, KP), shared(KP, MNP),
            shared(RSP),
        ],
        out_specs=[agent(*s) for s, _ in out_shapes],
        out_shape=[jax.ShapeDtypeStruct((A,) + s, t) for s, t in out_shapes],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="admm_loop",
    )(*args)

    xi_o, zl_o, zs_o, yl_o, ys_o, itd_o, ck_o = outs

    def unstat(v):  # [A, dim, RSP] → flat static rows
        return v.reshape(A, dim * RSP)[:, from_dim]

    def unlsc(v):
        return v[:, :O, :MN].reshape(A, R_lsc)

    xi = xi_o[:, :, :K]
    z = jnp.concatenate([unlsc(zl_o), unstat(zs_o)], axis=-1)
    y = jnp.concatenate([unlsc(yl_o), unstat(ys_o)], axis=-1)
    return xi, z, y, itd_o[:, 0], jnp.max(ck_o[:, 0]) * CHUNK


def _admm_agent_kernel(nd_r, kinv_r, pn_r, qn_r, lnl_r, lns_r, uns_r,
                       sinv_r, xi0_r, zl0_r, zs0_r, yl0_r, ys0_r, an_r,
                       n3k_r, rhos_r, xi_o, zl_o, zs_o, yl_o, ys_o, itd_o,
                       ck_o, *, dim, n_chunks, max_iter, stop_tol, eps_abs,
                       rho_l, alpha, sigma):
    eps_rel = 1e-3
    dims = range(dim)

    an = an_r[...]  # [RSP, KP]
    n3k = n3k_r[...]  # [KP, MNP]
    rho_s = rhos_r[...]  # [RSP]
    pn = pn_r[...]  # [KP, KP]
    nd = [nd_r[d] for d in dims]  # [OP, MNP] each
    kinv = [[kinv_r[d, e] for e in dims] for d in dims]  # [KP, KP]
    qn = [qn_r[d] for d in dims]  # [KP]
    ln_l = lnl_r[...]
    ln_s = [lns_r[d] for d in dims]
    un_s = [uns_r[d] for d in dims]
    sinv = [sinv_r[d] for d in dims]

    def fwd(xi):
        """A·ξ: LSC rows [OP, MNP] and per-dim static rows [RSP]."""
        zl = None
        zs = []
        for d in dims:
            x_d = jnp.sum(n3k * xi[d][:, None], axis=0)  # [MNP]
            t = nd[d] * x_d[None, :]
            zl = t if zl is None else zl + t
            zs.append(jnp.sum(an * xi[d][None, :], axis=1))
        return zl, zs

    def adj(wl, ws):
        """Aᵀ·w back to ξ-space, per dim [KP]."""
        g = []
        for d in dims:
            v = jnp.sum(nd[d] * wl, axis=0)  # [MNP]
            g.append(jnp.sum(n3k * v[None, :], axis=1)
                     + jnp.sum(an * ws[d][:, None], axis=0))
        return g

    def one_iter(_, carry):
        xi, zl, zs, yl, ys, axl, axs = carry
        g = adj(rho_l * zl - yl, [rho_s * zs[d] - ys[d] for d in dims])
        rhs = [sigma * xi[d] - qn[d] + g[d] for d in dims]
        xi_t = []
        for d in dims:
            acc = None
            for e in dims:
                t = jnp.sum(kinv[d][e] * rhs[e][None, :], axis=1)
                acc = t if acc is None else acc + t
            xi_t.append(acc)
        ztl, zts = fwd(xi_t)
        xi_n = [alpha * xi_t[d] + (1.0 - alpha) * xi[d] for d in dims]
        zml = alpha * ztl + (1.0 - alpha) * zl
        zl_n = jnp.maximum(zml + yl / rho_l, ln_l)
        yl_n = yl + rho_l * (zml - zl_n)
        axl_n = alpha * ztl + (1.0 - alpha) * axl
        zs_n, ys_n, axs_n = [], [], []
        for d in dims:
            zms = alpha * zts[d] + (1.0 - alpha) * zs[d]
            z_d = jnp.minimum(jnp.maximum(zms + ys[d] / rho_s, ln_s[d]),
                              un_s[d])
            zs_n.append(z_d)
            ys_n.append(ys[d] + rho_s * (zms - z_d))
            axs_n.append(alpha * zts[d] + (1.0 - alpha) * axs[d])
        return xi_n, zl_n, zs_n, yl_n, ys_n, axl_n, axs_n

    def chunk_step(state):
        it_state, ck, itd, best, noimp, _ = state
        xi_prev = it_state[0]
        it_state = jax.lax.fori_loop(0, CHUNK, one_iter, it_state)
        xi, _, _, yl, ys, axl, axs = it_state
        # feasibility of the actual iterate (row-scaled; LSC unit scale)
        viol = jnp.max(jnp.maximum(ln_l - axl, 0.0))
        for d in dims:
            v = jnp.maximum(jnp.maximum(ln_s[d] - axs[d], axs[d] - un_s[d]),
                            0.0)
            viol = jnp.maximum(viol, jnp.max(v * sinv[d]))
        feas = viol < stop_tol
        # relative dual residual, iterate stall, objective
        aty = adj(yl, ys)
        rd = dmag = dxi = ximag = obj = None
        for d in dims:
            px = jnp.sum(pn * xi[d][None, :], axis=1)
            terms = (
                jnp.max(jnp.abs(px + qn[d] + aty[d])),
                jnp.maximum(jnp.max(jnp.abs(px)),
                            jnp.maximum(jnp.max(jnp.abs(aty[d])),
                                        jnp.max(jnp.abs(qn[d])))),
                jnp.max(jnp.abs(xi[d] - xi_prev[d])),
                jnp.max(jnp.abs(xi[d])),
                jnp.sum((0.5 * px + qn[d]) * xi[d]),
            )
            if rd is None:
                rd, dmag, dxi, ximag, obj = terms
            else:
                rd = jnp.maximum(rd, terms[0])
                dmag = jnp.maximum(dmag, terms[1])
                dxi = jnp.maximum(dxi, terms[2])
                ximag = jnp.maximum(ximag, terms[3])
                obj = obj + terms[4]
        opt = rd < eps_abs + eps_rel * dmag
        stalled = dxi < 1e-4 * jnp.maximum(ximag, 1.0)
        improved = obj < best - 2e-4 * jnp.maximum(1.0, jnp.abs(obj))
        best = jnp.where(feas & improved, obj, best)
        noimp = jnp.where(feas & ~improved, noimp + 1, 0)
        done = feas & (opt | stalled | (noimp >= 2))
        itd = jnp.where(done & (itd == max_iter), (ck + 1) * CHUNK, itd)
        return it_state, ck + 1, itd, best, noimp, done

    def cond(state):
        ck, done = state[1], state[5]
        return (ck < n_chunks) & jnp.logical_not(done)

    xi0 = [xi0_r[d] for d in dims]
    axl0, axs0 = fwd(xi0)
    it_state = (xi0, zl0_r[...], [zs0_r[d] for d in dims], yl0_r[...],
                [ys0_r[d] for d in dims], axl0, axs0)
    state = (it_state, jnp.int32(0), jnp.int32(max_iter), jnp.float32(jnp.inf),
             jnp.int32(0), jnp.bool_(False))
    it_state, ck, itd, _, _, _ = jax.lax.while_loop(cond, chunk_step, state)
    xi, zl, zs, yl, ys, _, _ = it_state
    for d in dims:
        xi_o[d] = xi[d]
        zs_o[d] = zs[d]
        ys_o[d] = ys[d]
    zl_o[...] = zl
    yl_o[...] = yl
    itd_o[...] = jnp.full((1,), itd, jnp.int32)
    ck_o[...] = jnp.full((1,), ck, jnp.int32)
