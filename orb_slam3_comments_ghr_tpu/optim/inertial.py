"""Inertial-only optimizations and visual-inertial pose tracking.

JAX replacements for the reference's inertial estimators:

  inertial_init        : Optimizer::InertialOptimization (Optimizer.cc:3706)
                         — gravity direction Rwg (2-dof), monocular scale,
                         shared gyro/acc bias, per-KF velocities; body poses
                         fixed. Used by LocalMapping::InitializeIMU stages
                         (priors per SURVEY.md A.5 schedule).
  scale_gravity_refine : the scale+gravity-only overload (Optimizer.cc:4085)
                         used by ScaleRefinement.
  pose_inertial_optimize: PoseInertialOptimizationLastKeyFrame/LastFrame
                         (Optimizer.cc:435/:1002) — current-frame 15-dof
                         state (pose, velocity, bias) against reprojection +
                         preintegration + bias-random-walk + optional
                         marginalization prior; produces the next frame's
                         15x15 prior by Schur-marginalizing (Marginalize,
                         Optimizer.cc:1663).

All are small dense GN/LM problems with autodiff Jacobians — the variable
counts (tens to hundreds) make jacfwd + dense Cholesky the right shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie, cameras
from . import imu as imu_mod
from . import robust
from ..utils.precision import f32_matmuls


class InertialWindow(NamedTuple):
    """K keyframes with stacked preintegrations between consecutive pairs.

    Rwb: (K,3,3) body-in-world rotations; pwb: (K,3) positions (fixed)
    vel0: (K,3) initial velocity estimates
    pre: Preintegrated with leading dim (K-1,) on every leaf
    valid: (K-1,) mask for the consecutive-pair factors
    """

    Rwb: jnp.ndarray
    pwb: jnp.ndarray
    vel0: jnp.ndarray
    pre: imu_mod.Preintegrated
    valid: jnp.ndarray


def _stack_info(pre):
    """(K-1, 9, 9) information matrices."""
    return jax.vmap(imu_mod.information)(pre)


def gravity_seed(win: InertialWindow) -> jnp.ndarray:
    """Initial gravity-direction rotation from the preintegrated velocity
    deltas: dirG = -sum_i Rwb_i dV_i (LocalMapping.cc:1604-1656). Returns the
    rotation Rwg0 mapping (0,0,-1) onto dirG."""
    dV = win.pre.dV  # (K-1, 3)
    dirG = -jnp.sum(
        jnp.einsum("kij,kj->ki", win.Rwb[:-1], dV) * win.valid[:, None], axis=0
    )
    dirG = dirG / jnp.maximum(jnp.linalg.norm(dirG), 1e-9)
    gI = jnp.array([0.0, 0.0, -1.0])
    v = jnp.cross(gI, dirG)
    s = jnp.linalg.norm(v)
    c = jnp.dot(gI, dirG)
    ang = jnp.arctan2(s, c)
    axis = v / jnp.maximum(s, 1e-9)
    return lie.so3_exp(jnp.where(s < 1e-6, jnp.zeros(3), axis * ang))


@functools.partial(jax.jit, static_argnames=("optimize_scale", "iters"))
@f32_matmuls
def inertial_init(
    win: InertialWindow,
    prior_g: float,
    prior_a: float,
    optimize_scale: bool = True,
    iters: int = 30,
):
    """Returns (Rwg (3,3), scale (), bias (6,), vel (K,3), final_cost).

    Variables x = [phi_xy (2) gravity, log_s (1), bg (3), ba (3), vel (3K)];
    the gravity rotation is seeded from the preintegrated velocity deltas
    (the reference's dirG seed) so large tilts converge.
    """
    K = win.Rwb.shape[0]
    Rwg0 = gravity_seed(win)
    info = _stack_info(win.pre)
    # sqrt-information via Cholesky for whitened residuals
    info_sqrt = jnp.linalg.cholesky(
        info + 1e-8 * jnp.eye(9, dtype=info.dtype)[None]
    ).transpose(0, 2, 1)  # upper

    def unpack(x):
        phi = jnp.concatenate([x[:2], jnp.zeros(1, x.dtype)])
        Rwg = Rwg0 @ lie.so3_exp(phi)
        s = jnp.exp(x[2]) if optimize_scale else jnp.array(1.0, x.dtype)
        bias = x[3:9]
        vel = x[9:].reshape(K, 3)
        return Rwg, s, bias, vel

    def residuals(x):
        Rwg, s, bias, vel = unpack(x)

        def pair(i):
            pre_i = jax.tree.map(lambda a: a[i], win.pre)
            r = imu_mod.inertial_residual(
                win.Rwb[i], win.pwb[i], vel[i],
                win.Rwb[i + 1], win.pwb[i + 1], vel[i + 1],
                bias, pre_i, Rwg=Rwg, scale=s,
            )
            return info_sqrt[i] @ r * win.valid[i]

        r_pairs = jax.vmap(pair)(jnp.arange(K - 1)).reshape(-1)
        r_prior = jnp.concatenate(
            [jnp.sqrt(prior_g) * bias[:3], jnp.sqrt(prior_a) * bias[3:]]
        )
        return jnp.concatenate([r_pairs, r_prior])

    x0 = jnp.concatenate([jnp.zeros(9), win.vel0.reshape(-1)])

    def lm_step(carry, _):
        x, lam = carry
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        H = J.T @ J
        b = J.T @ r
        n = x.shape[0]
        dx = jnp.linalg.solve(H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(n), -b)
        x_new = x + dx
        better = jnp.sum(residuals(x_new) ** 2) < jnp.sum(r**2)
        x = jnp.where(better, x_new, x)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        return (x, lam), None

    (x, _), _ = jax.lax.scan(lm_step, (x0, jnp.array(1e-2)), None, length=iters)
    Rwg, s, bias, vel = unpack(x)
    cost = jnp.sum(residuals(x) ** 2)
    return Rwg, s, bias, vel, cost


def scale_gravity_refine(win: InertialWindow, bias: jnp.ndarray, iters: int = 20):
    """Scale + gravity-direction only (Optimizer.cc:4085): bias and
    velocities held."""
    K = win.Rwb.shape[0]
    info = _stack_info(win.pre)
    info_sqrt = jnp.linalg.cholesky(
        info + 1e-8 * jnp.eye(9, dtype=info.dtype)[None]
    ).transpose(0, 2, 1)

    def residuals(x):
        phi = jnp.concatenate([x[:2], jnp.zeros(1, x.dtype)])
        Rwg = lie.so3_exp(phi)
        s = jnp.exp(x[2])

        def pair(i):
            pre_i = jax.tree.map(lambda a: a[i], win.pre)
            r = imu_mod.inertial_residual(
                win.Rwb[i], win.pwb[i], win.vel0[i],
                win.Rwb[i + 1], win.pwb[i + 1], win.vel0[i + 1],
                bias, pre_i, Rwg=Rwg, scale=s,
            )
            return info_sqrt[i] @ r * win.valid[i]

        return jax.vmap(pair)(jnp.arange(K - 1)).reshape(-1)

    def gn(x, _):
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        dx = jnp.linalg.solve(J.T @ J + 1e-6 * jnp.eye(3), -(J.T @ r))
        return x + dx, None

    x, _ = jax.lax.scan(gn, jnp.zeros(3), None, length=iters)
    phi = jnp.concatenate([x[:2], jnp.zeros(1)])
    return lie.so3_exp(phi), jnp.exp(x[2])


class VIState(NamedTuple):
    """Body state for VI tracking: Rwb, pwb, vel, bias[6]."""

    Rwb: jnp.ndarray
    pwb: jnp.ndarray
    vel: jnp.ndarray
    bias: jnp.ndarray


class VIPrior(NamedTuple):
    """Marginalization prior from the previous frame (ConstraintPoseImu,
    G2oTypes.h:820): mean state + 15x15 information."""

    Rwb: jnp.ndarray
    pwb: jnp.ndarray
    vel: jnp.ndarray
    bias: jnp.ndarray
    H: jnp.ndarray
    valid: jnp.ndarray  # scalar bool


def empty_prior(dtype=jnp.float32) -> VIPrior:
    return VIPrior(
        Rwb=jnp.eye(3, dtype=dtype), pwb=jnp.zeros(3, dtype),
        vel=jnp.zeros(3, dtype), bias=jnp.zeros(6, dtype),
        H=jnp.zeros((15, 15), dtype), valid=jnp.array(False),
    )


@functools.partial(jax.jit, static_argnames=("cam", "iters"))
@f32_matmuls
def pose_inertial_optimize(
    cam: cameras.Camera,
    state0: VIState,              # predicted current state
    prev: VIState,                # last keyframe (or last frame) state
    pre: imu_mod.Preintegrated,   # preintegration prev -> current
    obs,                          # pose_opt.PoseObs (map matches, body-posed)
    Tcb: tuple,                   # (Rcb, tcb): body->cam
    prior: VIPrior,
    iters: int = 10,
):
    """Optimize the current frame's 15-dof state. Returns (state, inliers,
    n_inliers, next_prior). Mirrors PoseInertialOptimizationLastKeyFrame
    (prev fixed) with the marginalization-prior chain of ...LastFrame."""
    Rcb, tcb = Tcb
    info9 = imu_mod.information(pre)
    info9_sqrt = jnp.linalg.cholesky(info9 + 1e-8 * jnp.eye(9)).T
    info_level = robust.inv_level_sigma2(obs.level)
    # bias random walk information (EdgeGyroRW/EdgeAccRW): from walk covs
    # accumulated over the preintegration window
    walk_info = jnp.linalg.inv(pre.C[9:15, 9:15] + 1e-9 * jnp.eye(6))
    walk_sqrt = jnp.linalg.cholesky(walk_info + 1e-9 * jnp.eye(6)).T

    def unpack(x):
        dR = lie.so3_exp(x[:3])
        Rwb = state0.Rwb @ dR
        pwb = state0.pwb + x[3:6]
        vel = state0.vel + x[6:9]
        bias = state0.bias + x[9:15]
        return VIState(Rwb, pwb, vel, bias)

    def vis_residuals(st: VIState):
        # camera pose from body: Tcw = Tcb * Twb^-1
        Rcw = Rcb @ st.Rwb.T
        tcw = tcb - Rcw @ st.pwb
        pc = obs.p_world @ Rcw.T + tcw
        z = jnp.maximum(pc[..., 2], 1e-6)
        uv_hat = cameras.project(cam, pc)
        r_uv = (obs.uv - uv_hat)
        is_stereo = obs.u_right >= 0
        ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], z)
        r_ur = jnp.where(is_stereo, obs.u_right - ur_hat, 0.0)
        r = jnp.concatenate([r_uv, r_ur[..., None]], -1)  # (N,3)
        chi2 = jnp.sum(r * r, -1) * info_level
        return r, chi2, is_stereo

    def full_residuals(x, inlier):
        st = unpack(x)
        r_vis, chi2, is_stereo = vis_residuals(st)
        delta2 = jnp.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
        w = robust.huber_weight(chi2, delta2) * info_level
        w = jnp.where(inlier, w, 0.0)
        r_vis_w = r_vis * jnp.sqrt(w)[:, None]
        r_imu = imu_mod.inertial_residual(
            prev.Rwb, prev.pwb, prev.vel, st.Rwb, st.pwb, st.vel,
            prev.bias, pre,
        )
        r_imu_w = info9_sqrt @ r_imu
        r_walk = walk_sqrt @ (st.bias - prev.bias)
        rs = [r_vis_w.reshape(-1), r_imu_w, r_walk]
        # marginalization prior residual (15)
        dphi = lie.so3_log(prior.Rwb.T @ st.Rwb)
        dp = st.pwb - prior.pwb
        dv = st.vel - prior.vel
        db = st.bias - prior.bias
        r_pr = jnp.concatenate([dphi, dp, dv, db])
        Hp = jnp.where(prior.valid, 1.0, 0.0) * prior.H
        # sqrt via eigen-clip (H may be PSD)
        evals, evecs = jnp.linalg.eigh(Hp + 1e-9 * jnp.eye(15))
        sq = evecs @ jnp.diag(jnp.sqrt(jnp.maximum(evals, 0.0))) @ evecs.T
        rs.append(sq @ r_pr)
        return jnp.concatenate(rs)

    inlier = obs.valid
    x = jnp.zeros(15)
    for rnd in range(2):
        def gn(carry, _):
            x, lam = carry
            r = full_residuals(x, inlier)
            J = jax.jacfwd(lambda xx: full_residuals(xx, inlier))(x)
            H = J.T @ J
            b = J.T @ r
            dx = jnp.linalg.solve(H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(15), -b)
            x_new = x + dx
            better = jnp.sum(full_residuals(x_new, inlier) ** 2) < jnp.sum(r**2)
            x = jnp.where(better, x_new, x)
            lam = jnp.where(better, lam * 0.5, lam * 4.0)
            return (x, lam), None

        (x, _), _ = jax.lax.scan(gn, (x, jnp.array(1e-3)), None, length=iters // 2)
        st = unpack(x)
        _, chi2, is_stereo = vis_residuals(st)
        th = jnp.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
        inlier = obs.valid & (chi2 <= th)

    st = unpack(x)
    # next-frame prior: J^T J of all factors at the solution (15x15)
    J = jax.jacfwd(lambda xx: full_residuals(xx, inlier))(x)
    H15 = J.T @ J
    next_prior = VIPrior(
        Rwb=st.Rwb, pwb=st.pwb, vel=st.vel, bias=st.bias,
        H=H15, valid=jnp.array(True),
    )
    n_inl = jnp.sum(inlier.astype(jnp.int32))
    return st, inlier, n_inl, next_prior
