"""Essential-graph (pose-graph) optimization over Sim(3) / 4-DoF poses.

JAX replacement for Optimizer::OptimizeEssentialGraph (reference:
src/Optimizer.cc:4527 loop variant, :5683 merge variant; 4-DoF inertial
variant :4870). Vertices are per-keyframe Sim3 world->cam transforms; edges
(spanning tree + covisibility weight>=100 + loop/merge edges) carry the
relative Sim3 measured from the pre-correction poses; loop edges carry the
corrected relative transform. The Gauss-Newton normal equations are built
from vmapped autodiff edge Jacobians and scatter-added into a dense (7K,7K)
system — pose graphs here are a few hundred keyframes, squarely in dense-
Cholesky territory.

For the inertial 4-DoF variant, pass dof4=True: roll/pitch and scale are
frozen by large diagonal priors on those tangent components (the reference
parameterizes yaw+t directly; freezing is the same fixed-point). The
perturbation is RIGHT-multiplicative on Scw (S' = Scw * exp(xi)), i.e. a
world-side tangent: its rotation components are rotations about WORLD axes,
so freezing components 3/4 freezes world roll/pitch about gravity (the
reference's VertexPose4DoF yaw-in-world parameterization,
Optimizer.cc:4870)."""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie
from ..utils.precision import f32_matmuls


class PoseGraphProblem(NamedTuple):
    """K vertices, E edges (padded).

    s/R/t: (K,) (K,3,3) (K,3) initial Sim3 world->cam per keyframe
    fixed: (K,) bool — gauge anchors (the loop KF / init KF)
    e_i, e_j: (E,) int32 vertex indices
    e_s/e_R/e_t: measured relative Sim3  S_ij = S_i * S_j^-1
    e_valid: (E,) bool
    e_weight: (E,) float — 1 for normal edges, larger for loop edges
    """

    s: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    fixed: jnp.ndarray
    e_i: jnp.ndarray
    e_j: jnp.ndarray
    e_s: jnp.ndarray
    e_R: jnp.ndarray
    e_t: jnp.ndarray
    e_valid: jnp.ndarray
    e_weight: jnp.ndarray


def _edge_residual(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """r = log_sim3( S_ij_meas^-1 * (S_i exp(xi_i)) * (S_j exp(xi_j))^-1 )."""
    dsi, dRi, dti = lie.sim3_exp(xi_i)
    dsj, dRj, dtj = lie.sim3_exp(xi_j)
    s_i, R_i, t_i = lie.sim3_mul(si, Ri, ti, dsi, dRi, dti)
    s_j, R_j, t_j = lie.sim3_mul(sj, Rj, tj, dsj, dRj, dtj)
    s_ji, R_ji, t_ji = lie.sim3_inv(s_j, R_j, t_j)
    s_rel, R_rel, t_rel = lie.sim3_mul(s_i, R_i, t_i, s_ji, R_ji, t_ji)
    msi, mRi, mti = lie.sim3_inv(ms, mR, mt)
    s_e, R_e, t_e = lie.sim3_mul(msi, mRi, mti, s_rel, R_rel, t_rel)
    return lie.sim3_log(s_e, R_e, t_e)


@functools.partial(jax.jit, static_argnames=("iters", "dof4"))
@f32_matmuls
def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20, dof4: bool = False):
    """Returns corrected (s, R, t) per keyframe."""
    K = prob.s.shape[0]
    dtype = prob.t.dtype

    def gn_step(carry, _):
        s, R, t = carry
        z = jnp.zeros(7, dtype)

        def per_edge(i, j, ms, mR, mt):
            fi = lambda xi: _edge_residual(xi, z, s[i], R[i], t[i], s[j], R[j], t[j], ms, mR, mt)
            fj = lambda xj: _edge_residual(z, xj, s[i], R[i], t[i], s[j], R[j], t[j], ms, mR, mt)
            r = fi(z)
            Ji = jax.jacfwd(fi)(z)
            Jj = jax.jacfwd(fj)(z)
            return r, Ji, Jj

        r, Ji, Jj = jax.vmap(per_edge)(prob.e_i, prob.e_j, prob.e_s, prob.e_R, prob.e_t)
        w = jnp.where(prob.e_valid, prob.e_weight, 0.0)

        # assemble dense H (7K,7K), b (7K)
        Hii = jnp.einsum("eri,e,erj->eij", Ji, w, Ji)
        Hjj = jnp.einsum("eri,e,erj->eij", Jj, w, Jj)
        Hij = jnp.einsum("eri,e,erj->eij", Ji, w, Jj)
        bi = jnp.einsum("eri,e,er->ei", Ji, w, r)
        bj = jnp.einsum("eri,e,er->ei", Jj, w, r)

        Hb = jnp.zeros((K, K, 7, 7), dtype)
        Hb = Hb.at[prob.e_i, prob.e_i].add(Hii)
        Hb = Hb.at[prob.e_j, prob.e_j].add(Hjj)
        Hb = Hb.at[prob.e_i, prob.e_j].add(Hij)
        Hb = Hb.at[prob.e_j, prob.e_i].add(jnp.swapaxes(Hij, -1, -2))
        b = jnp.zeros((K, 7), dtype)
        b = b.at[prob.e_i].add(bi)
        b = b.at[prob.e_j].add(bj)

        # gauge + parameter freezing priors
        diag_prior = jnp.full((7,), 1e-8, dtype)
        if dof4:
            # freeze roll (phi_x), pitch (phi_y) and scale
            diag_prior = diag_prior.at[3].set(1e10).at[4].set(1e10).at[6].set(1e10)
        prior = jnp.diag(diag_prior)
        fixed_prior = prob.fixed[:, None, None] * 1e12 * jnp.eye(7, dtype=dtype)
        Hb = Hb.at[jnp.arange(K), jnp.arange(K)].add(
            prior[None] + fixed_prior + 1e-6 * jnp.eye(7, dtype=dtype)
        )

        H = Hb.transpose(0, 2, 1, 3).reshape(7 * K, 7 * K)
        bd = b.reshape(7 * K)
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(H), 1e-12))
        Hs = H / d[:, None] / d[None, :]
        L = jax.scipy.linalg.cho_factor(Hs)
        dx = (jax.scipy.linalg.cho_solve(L, -bd / d) / d).reshape(K, 7)
        dx = jnp.where(prob.fixed[:, None], 0.0, dx)

        ds, dR, dt = jax.vmap(lie.sim3_exp)(dx)
        s2, R2, t2 = jax.vmap(lie.sim3_mul)(s, R, t, ds, dR, dt)
        return (s2, R2, t2), jnp.sum(w * jnp.sum(r * r, -1))

    (s, R, t), costs = jax.lax.scan(
        gn_step, (prob.s, prob.R, prob.t), None, length=iters
    )
    return s, R, t, costs


def _edge_blocks(prob: PoseGraphProblem, s, R, t, dtype):
    """Per-edge residuals + GN blocks: r (E,7), Hii/Hjj/Hij (E,7,7),
    bi/bj (E,7), with invalid edges zero-weighted."""
    z = jnp.zeros(7, dtype)

    def per_edge(i, j, ms, mR, mt):
        fi = lambda xi: _edge_residual(xi, z, s[i], R[i], t[i], s[j], R[j], t[j], ms, mR, mt)
        fj = lambda xj: _edge_residual(z, xj, s[i], R[i], t[i], s[j], R[j], t[j], ms, mR, mt)
        r = fi(z)
        Ji = jax.jacfwd(fi)(z)
        Jj = jax.jacfwd(fj)(z)
        return r, Ji, Jj

    r, Ji, Jj = jax.vmap(per_edge)(prob.e_i, prob.e_j, prob.e_s, prob.e_R, prob.e_t)
    w = jnp.where(prob.e_valid, prob.e_weight, 0.0)
    Hii = jnp.einsum("eri,e,erj->eij", Ji, w, Ji)
    Hjj = jnp.einsum("eri,e,erj->eij", Jj, w, Jj)
    Hij = jnp.einsum("eri,e,erj->eij", Ji, w, Jj)
    bi = jnp.einsum("eri,e,er->ei", Ji, w, r)
    bj = jnp.einsum("eri,e,er->ei", Jj, w, r)
    cost = jnp.sum(w * jnp.sum(r * r, -1))
    return Hii, Hjj, Hij, bi, bj, cost


@functools.partial(jax.jit, static_argnames=("iters", "dof4", "cg_iters"))
@f32_matmuls
def optimize_pose_graph_cg(prob: PoseGraphProblem, iters: int = 20,
                           dof4: bool = False, cg_iters: int = 100):
    """Scalable essential-graph solve: identical GN linearization to
    optimize_pose_graph, but the normal equations are solved MATRIX-FREE with
    block-Jacobi-preconditioned conjugate gradients — O(E) memory for the
    per-edge 7x7 blocks instead of the dense (7K,7K) Hessian, which at the
    reference's 10k-keyframe scale (Optimizer.cc:4539 BlockSolver_7_3 +
    sparse Eigen Cholesky) would be 200 GB dense. Each CG matvec is two
    (E,7,7)x(E,7) einsums plus two segment scatters."""
    K = prob.s.shape[0]
    dtype = prob.t.dtype
    ei, ej = prob.e_i, prob.e_j

    diag_prior = jnp.full((7,), 1e-8, dtype)
    if dof4:
        diag_prior = diag_prior.at[3].set(1e10).at[4].set(1e10).at[6].set(1e10)
    prior = (
        jnp.diag(diag_prior)[None]
        + prob.fixed[:, None, None] * 1e12 * jnp.eye(7, dtype=dtype)
        + 1e-6 * jnp.eye(7, dtype=dtype)[None]
    )  # (K,7,7) per-vertex diagonal prior (gauge + dof freezing)

    def gn_step(carry, _):
        s, R, t = carry
        Hii, Hjj, Hij, bi, bj, cost = _edge_blocks(prob, s, R, t, dtype)
        b = jnp.zeros((K, 7), dtype).at[ei].add(bi).at[ej].add(bj)
        # accumulated diagonal blocks (also the block-Jacobi preconditioner)
        D = (
            jnp.zeros((K, 7, 7), dtype).at[ei].add(Hii).at[ej].add(Hjj)
            + prior
        )
        Dinv = jnp.linalg.inv(D)

        def hmul(x):
            yi = jnp.einsum("eij,ej->ei", Hij, x[ej])
            yj = jnp.einsum("eji,ej->ei", Hij, x[ei])
            y = jnp.zeros((K, 7), dtype).at[ei].add(yi).at[ej].add(yj)
            return y + jnp.einsum("kij,kj->ki", D, x)

        def precond(v):
            return jnp.einsum("kij,kj->ki", Dinv, v)

        bneg = -b
        x0 = jnp.zeros((K, 7), dtype)
        r0 = bneg
        z0 = precond(r0)
        p0 = z0
        rz0 = jnp.sum(r0 * z0)

        def cg_body(_, st):
            x, r, p, rz = st
            Ap = hmul(p)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            zn = precond(r)
            rzn = jnp.sum(r * zn)
            beta = rzn / jnp.maximum(rz, 1e-20)
            p = zn + beta * p
            return x, r, p, rzn

        dx, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body, (x0, r0, p0, rz0))
        dx = jnp.where(prob.fixed[:, None], 0.0, dx)
        ds, dR, dt = jax.vmap(lie.sim3_exp)(dx)
        s2, R2, t2 = jax.vmap(lie.sim3_mul)(s, R, t, ds, dR, dt)
        return (s2, R2, t2), cost

    (s, R, t), costs = jax.lax.scan(
        gn_step, (prob.s, prob.R, prob.t), None, length=iters
    )
    return s, R, t, costs


# keyframe count above which the dense (7K,7K) Cholesky path is replaced by
# the matrix-free CG path (dense at K=512 is ~50 MB)
DENSE_MAX_K = 512


def solve_pose_graph(prob: PoseGraphProblem, iters: int = 20, dof4: bool = False):
    """Dispatch by problem size: dense Cholesky for small graphs (exact,
    one dense solve), block-Jacobi CG for large ones (O(E) memory)."""
    if prob.s.shape[0] <= DENSE_MAX_K:
        return optimize_pose_graph(prob, iters=iters, dof4=dof4)
    return optimize_pose_graph_cg(prob, iters=iters, dof4=dof4)
