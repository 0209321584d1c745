"""Sim(3) estimation between two keyframes' matched map-point sets.

JAX replacement for Sim3Solver (reference: src/Sim3Solver.cc — Horn
closed-form 3-point similarity inside a RANSAC loop, scale fixed for
stereo/RGB-D) and Optimizer::OptimizeSim3 (src/Optimizer.cc:4213 — g2o LM on
a VertexSim3Expmap with bidirectional reprojection edges, chi2 10).

All RANSAC hypotheses are solved and scored in one vmapped batch; the
refinement is a small GN loop with autodiff Jacobians over the 7-dim tangent.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import lie, cameras
from ..utils.precision import f32_matmuls

RANSAC_ITERS = 256
CHI2_SIM3 = 10.0


def horn_sim3(p1: jnp.ndarray, p2: jnp.ndarray, fix_scale: bool = False):
    """Closed-form similarity p1 ~= s R p2 + t from >=3 correspondences
    (Horn 1987, as Sim3Solver::ComputeSim3). p1/p2: (S,3)."""
    o1 = p1.mean(0)
    o2 = p2.mean(0)
    c1 = p1 - o1
    c2 = p2 - o2
    M = c1.T @ c2  # (3,3)
    U, _, Vt = jnp.linalg.svd(M)
    d = jnp.linalg.det(U @ Vt)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], p1.dtype)).at[2, 2].set(d)
    R = U @ D @ Vt
    if fix_scale:
        s = jnp.array(1.0, p1.dtype)
    else:
        num = jnp.sum(c1 * (c2 @ R.T))
        den = jnp.maximum(jnp.sum(c2 * c2), 1e-12)
        s = num / den
    t = o1 - s * (R @ o2)
    return s, R, t


@functools.partial(jax.jit, static_argnames=("cam", "fix_scale", "n_hyp"))
@f32_matmuls
def sim3_ransac(
    cam: cameras.Camera,
    p1: jnp.ndarray,        # (N,3) points in KF1 camera frame
    p2: jnp.ndarray,        # (N,3) matched points in KF2 camera frame
    level1: jnp.ndarray,
    level2: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    fix_scale: bool = False,
    n_hyp: int = RANSAC_ITERS,
):
    """Returns (s12, R12, t12, inlier_mask, n_inliers): p1 ~= S12 * p2.
    Inlier check mirrors Sim3Solver::CheckInliers — project both directions,
    chi2 against 9.21*sigma^2 per octave."""
    n = p1.shape[0]
    logits = jnp.where(valid, 0.0, -1e9)
    g = jax.random.gumbel(key, (n_hyp, n)) + logits[None]
    _, idx = jax.lax.top_k(g, 3)

    sig1 = 9.21 * (1.2 ** level1.astype(jnp.float32)) ** 2
    sig2 = 9.21 * (1.2 ** level2.astype(jnp.float32)) ** 2
    uv1 = cameras.project(cam, p1)
    uv2 = cameras.project(cam, p2)

    def check(s, R, t):
        p2_in_1 = s * (p2 @ R.T) + t
        e1 = jnp.sum((cameras.project(cam, p2_in_1) - uv1) ** 2, -1)
        s_inv, R_inv, t_inv = lie.sim3_inv(s, R, t)
        p1_in_2 = s_inv * (p1 @ R_inv.T) + t_inv
        e2 = jnp.sum((cameras.project(cam, p1_in_2) - uv2) ** 2, -1)
        inl = valid & (e1 < sig1) & (e2 < sig2) & (p2_in_1[:, 2] > 0) & (p1_in_2[:, 2] > 0)
        return inl

    def hyp(i):
        s, R, t = horn_sim3(p1[i], p2[i], fix_scale)
        inl = check(s, R, t)
        # guard degenerate hypotheses
        bad = (~jnp.isfinite(s)) | (s <= 1e-3) | (s > 1e3)
        return jnp.where(bad, -1, jnp.sum(inl.astype(jnp.int32))), s, R, t

    scores, ss, Rs, ts = jax.vmap(hyp)(idx)
    best = jnp.argmax(scores)
    s, R, t = ss[best], Rs[best], ts[best]
    # re-solve on all inliers of the best hypothesis (standard polish)
    inl = check(s, R, t)
    w = inl.astype(p1.dtype)[:, None]
    nw = jnp.maximum(w.sum(), 3.0)
    o1 = (p1 * w).sum(0) / nw
    o2 = (p2 * w).sum(0) / nw
    c1 = (p1 - o1) * w
    c2 = (p2 - o2) * w
    M = c1.T @ c2
    U, _, Vt = jnp.linalg.svd(M)
    d = jnp.linalg.det(U @ Vt)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], p1.dtype)).at[2, 2].set(d)
    R2 = U @ D @ Vt
    if fix_scale:
        s2 = jnp.array(1.0, p1.dtype)
    else:
        s2 = jnp.sum(c1 * (c2 @ R2.T)) / jnp.maximum(jnp.sum(c2 * c2), 1e-12)
    t2 = o1 - s2 * (R2 @ o2)
    ok_polish = jnp.isfinite(s2) & (s2 > 1e-3) & (s2 < 1e3)
    s = jnp.where(ok_polish, s2, s)
    R = jnp.where(ok_polish, R2, R)
    t = jnp.where(ok_polish, t2, t)
    inl = check(s, R, t)
    return s, R, t, inl, jnp.sum(inl.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("cam", "fix_scale", "iters"))
@f32_matmuls
def optimize_sim3(
    cam: cameras.Camera,
    s0, R0, t0,
    p1: jnp.ndarray, uv1: jnp.ndarray, level1: jnp.ndarray,
    p2: jnp.ndarray, uv2: jnp.ndarray, level2: jnp.ndarray,
    valid: jnp.ndarray,
    fix_scale: bool = False,
    iters: int = 10,
):
    """GN refinement of S12 with bidirectional reprojection residuals and
    chi2-10 gating (OptimizeSim3). Returns (s, R, t, inliers, n)."""
    xi0 = jnp.zeros(7, p1.dtype)
    info1 = (1.2 ** level1.astype(jnp.float32)) ** -2
    info2 = (1.2 ** level2.astype(jnp.float32)) ** -2

    def residuals(xi):
        ds, dR, dt = lie.sim3_exp(xi)
        s, R, t = lie.sim3_mul(ds, dR, dt, s0, R0, t0)
        if fix_scale:
            s = s0
        p2_in_1 = s * (p2 @ R.T) + t
        r1 = (uv1 - cameras.project(cam, p2_in_1)) * jnp.sqrt(info1)[:, None]
        si, Ri, ti = lie.sim3_inv(s, R, t)
        p1_in_2 = si * (p1 @ Ri.T) + ti
        r2 = (uv2 - cameras.project(cam, p1_in_2)) * jnp.sqrt(info2)[:, None]
        return r1, r2

    inlier = valid

    def gn_step(carry, _):
        xi, inlier = carry
        (r1, r2), Jf = ( residuals(xi), jax.jacfwd(lambda x: residuals(x))(xi) )
        J1, J2 = Jf
        w = inlier.astype(p1.dtype)
        H = (
            jnp.einsum("nri,n,nrj->ij", J1, w, J1)
            + jnp.einsum("nri,n,nrj->ij", J2, w, J2)
        )
        b = (
            jnp.einsum("nri,n,nr->i", J1, w, r1)
            + jnp.einsum("nri,n,nr->i", J2, w, r2)
        )
        if fix_scale:
            H = H.at[6, 6].add(1e12)
        dx = jnp.linalg.solve(H + 1e-6 * jnp.eye(7), -b)
        xi = xi + dx
        r1n, r2n = residuals(xi)
        chi1 = jnp.sum(r1n * r1n, -1)
        chi2c = jnp.sum(r2n * r2n, -1)
        inlier = valid & (chi1 < CHI2_SIM3) & (chi2c < CHI2_SIM3)
        return (xi, inlier), None

    (xi, inlier), _ = jax.lax.scan(gn_step, (xi0, inlier), None, length=iters)
    ds, dR, dt = lie.sim3_exp(xi)
    s, R, t = lie.sim3_mul(ds, dR, dt, s0, R0, t0)
    if fix_scale:
        s = s0
    return s, R, t, inlier, jnp.sum(inlier.astype(jnp.int32))
