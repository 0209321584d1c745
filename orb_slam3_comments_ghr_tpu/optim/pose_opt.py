"""Motion-only pose optimization (the per-frame hot path).

JAX replacement for Optimizer::PoseOptimization (reference:
src/Optimizer.cc:71-433): given the current frame's 3D-2D (and stereo 3D)
matches, refine the SE3 world->camera pose by Levenberg-Marquardt with Huber
weights, running 4 rounds x 10 iterations with chi-square inlier
re-classification between rounds (Huber on for the first two rounds, off
after, th 5.991 mono / 7.815 stereo — Optimizer.cc:122-126, 310-350).

Everything is batched over the (padded) match set; the LM loop is a
lax.fori_loop; the 4 rounds are unrolled at trace time. One jit, zero
host-device chatter until the final inlier count is read."""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie, cameras
from . import robust


class PoseObs(NamedTuple):
    """Padded frame<->map matches for pose optimization.

    p_world: (N,3) map point positions
    uv:      (N,2) observed pixels
    u_right: (N,)  observed right-image u (stereo/RGB-D), <0 if mono obs
    level:   (N,)  keypoint octave (information ladder)
    valid:   (N,)  padding/match mask
    """

    p_world: jnp.ndarray
    uv: jnp.ndarray
    u_right: jnp.ndarray
    level: jnp.ndarray
    valid: jnp.ndarray


def _residuals_jacobians(cam: cameras.Camera, R, t, obs: PoseObs):
    """Per-observation residual r (N,3), Jacobian J = dr/dxi (N,3,6) for the
    left-multiplicative update T <- exp(xi) T, and stereo mask.

    Rows 0..1 are the mono (u,v) residual; row 2 is the right-u residual,
    active only for stereo observations (EdgeStereoSE3ProjectXYZOnlyPose,
    OptimizableTypes.h:94)."""
    pc = lie.se3_apply(R, t, obs.p_world)  # (N,3) camera frame
    z = jnp.maximum(pc[..., 2], 1e-6)
    uv_hat = cameras.project(cam, pc)  # (N,2)
    is_stereo = obs.u_right >= 0.0
    ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], z)

    r_uv = obs.uv - uv_hat
    r_ur = jnp.where(is_stereo, obs.u_right - ur_hat, 0.0)
    r = jnp.concatenate([r_uv, r_ur[..., None]], axis=-1)  # (N,3)

    # d(pc)/dxi = [I | -hat(pc)]  (xi = [rho, phi], left perturbation)
    J_proj = cameras.project_jac(cam, pc)  # (N,2,3)
    dpc = jnp.concatenate(
        [
            jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3)),
            -lie.hat(pc),
        ],
        axis=-1,
    )  # (N,3,6)
    J_uv = -jnp.einsum("nij,njk->nik", J_proj, dpc)  # (N,2,6)
    # right-u row: d(ur)/dpc = d(u)/dpc + [0,0, bf/z^2]
    d_ur_dpc = J_proj[:, 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), cam.bf / (z * z)], axis=-1
    )
    J_ur = -jnp.einsum("nj,njk->nk", d_ur_dpc, dpc)  # (N,6)
    J = jnp.concatenate([J_uv, J_ur[:, None, :]], axis=1)  # (N,3,6)
    r = jnp.where(is_stereo[:, None], r, r.at[:, 2].set(0.0))
    row_mask = jnp.concatenate(
        [jnp.ones_like(r[..., :2], bool), is_stereo[:, None]], axis=-1
    )
    return r, J, row_mask, is_stereo


def _chi2(r, row_mask, info):
    return jnp.sum(jnp.where(row_mask, r * r, 0.0), axis=-1) * info


@functools.partial(jax.jit, static_argnames=("cam", "iters_per_round"))
def optimize_pose(
    cam: cameras.Camera,
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    obs: PoseObs,
    iters_per_round: int = 10,
):
    """Returns (R, t, inlier_mask, n_inliers). Mirrors the 4-round schedule of
    Optimizer::PoseOptimization: inliers re-classified by chi2 each round,
    Huber kernel active in rounds 0-1 only (Optimizer.cc:310-350).

    Traced under matmul precision 'highest': reduced-precision matmul
    inputs (bf16, or TF32 on a GPU) in the normal equations bias the pose by
    up to ~0.4 px worth of error."""
    with jax.default_matmul_precision("highest"):
        return _optimize_pose_body(cam, R0, t0, obs, iters_per_round)


def _optimize_pose_body(cam, R0, t0, obs, iters_per_round):
    """One residual/Jacobian evaluation per LM iteration: the evaluation at
    the TRIAL state doubles as the next iteration's linearization when the
    step is accepted, and a rejected step re-uses the carried linearization
    with a larger lambda (identical values to re-evaluating at the unchanged
    state). A while_loop exits the round early once a step both succeeds and
    moves less than 1e-8 — the serial LM chain is the latency floor of the
    per-frame program, so halving its evaluations cuts real frame time."""
    info = robust.inv_level_sigma2(obs.level)
    inlier = obs.valid

    R, t = R0, t0
    r, J, row_mask, is_stereo = _residuals_jacobians(cam, R, t, obs)
    delta2 = jnp.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    for rnd in range(4):
        use_huber = rnd < 2

        def cost_of(chi2):
            c = robust.huber_cost(chi2, delta2) if use_huber else chi2
            return jnp.sum(jnp.where(inlier, c, 0.0))

        def lm_cond(carry):
            _R, _t, _lam, _r, _J, _rm, it, done = carry
            return (it < iters_per_round) & ~done

        def lm_body(carry):
            R, t, lam, r, J, row_mask, it, _ = carry
            chi2 = _chi2(r, row_mask, info)
            w = (robust.huber_weight(chi2, delta2) if use_huber
                 else jnp.ones_like(chi2))
            w = jnp.where(inlier, w * info, 0.0)
            # H = J^T W J, b = J^T W r  (rows masked)
            Jm = jnp.where(row_mask[..., None], J, 0.0)
            rm = jnp.where(row_mask, r, 0.0)
            H = jnp.einsum("nri,n,nrj->ij", Jm, w, Jm)
            b = jnp.einsum("nri,n,nr->i", Jm, w, rm)
            cost0 = cost_of(chi2)
            # GN step: r(xi) ~ r0 + J dxi  =>  (J'WJ) dxi = -J'W r0
            dx = jnp.linalg.solve(
                H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6), -b
            )
            dR, dt = lie.se3_exp(dx)
            R_new, t_new = lie.se3_mul(dR, dt, R, t)
            r2, J2, rm2, _ = _residuals_jacobians(cam, R_new, t_new, obs)
            cost1 = cost_of(_chi2(r2, rm2, info))
            better = cost1 < cost0
            R = jnp.where(better, R_new, R)
            t = jnp.where(better, t_new, t)
            r = jnp.where(better, r2, r)
            J = jnp.where(better, J2, J)
            row_mask = jnp.where(better, rm2, row_mask)
            lam = jnp.where(better, lam * 0.5, lam * 4.0)
            # |dx| < 1e-6: pose moved sub-micrometer/sub-microradian —
            # orders below the chi2 re-classification sensitivity
            done = better & (jnp.sum(dx * dx) < 1e-12)
            return R, t, lam, r, J, row_mask, it + 1, done

        R, t, _, r, J, row_mask, _, _ = jax.lax.while_loop(
            lm_cond, lm_body,
            (R, t, jnp.array(1e-3, R0.dtype), r, J, row_mask,
             jnp.array(0, jnp.int32), jnp.array(False)),
        )
        # chi2 re-classification for the next round from the carried
        # linearization (exactly the state's residuals)
        chi2 = _chi2(r, row_mask, info)
        th = jnp.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
        inlier = obs.valid & (chi2 <= th)

    return R, t, inlier, jnp.sum(inlier.astype(jnp.int32))
