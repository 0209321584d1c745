"""Visual-inertial bundle adjustment (FullInertialBA / LocalInertialBA).

JAX replacement for Optimizer::FullInertialBA (reference:
src/Optimizer.cc:3254) and Optimizer::LocalInertialBA (:2221): per-keyframe
15-dof body state (pose 6, velocity 3, gyro+acc bias 6) + landmarks, with
reprojection factors, preintegration factors between consecutive keyframes
(EdgeInertial), bias random-walk factors (EdgeGyroRW/EdgeAccRW), and Huber
robust weighting.

Structure: landmarks are Schur-eliminated exactly as in optim.ba (the
reprojection factor touches only the 6 pose components, so the expensive
(P,D,D) pair expansion stays 6-wide); the inertial and walk factors are
added directly to the 15-wide reduced camera system, which is then one dense
scaled-Cholesky solve — the window sizes (<=25 KFs -> <=375 dims) keep it
small and dense.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie, cameras
from . import ba, robust
from . import imu as imu_mod

CDIM = 15  # per-keyframe block: [phi(3), dp(3), dv(3), dbg(3), dba(3)]


class VIBAProblem(NamedTuple):
    """K body states, P landmarks, D obs per landmark, K-1 inertial factors.

    Rwb/pwb/vel/bias: (K,...) body states (world frame)
    fixed: (K,) bool
    Rcb/tcb: body->cam extrinsics (camera = Tcb * body)
    p, p_valid, obs_*: landmark/observation tables as in ba.BAProblem
                       (obs_cam indexes the K body states)
    pre: stacked Preintegrated (leading dim K-1) between consecutive states
    pre_valid: (K-1,) bool
    obs_rig/rig_R/rig_t: optional second-camera rig slots exactly as in
                       ba.BAProblem (EdgeSE3ProjectXYZToBody for fisheye
                       stereo, OptimizableTypes.h:96-160) — the offset is
                       applied AFTER the body->cam0 chain
    """

    Rwb: jnp.ndarray
    pwb: jnp.ndarray
    vel: jnp.ndarray
    bias: jnp.ndarray
    fixed: jnp.ndarray
    Rcb: jnp.ndarray
    tcb: jnp.ndarray
    p: jnp.ndarray
    p_valid: jnp.ndarray
    obs_cam: jnp.ndarray
    obs_uv: jnp.ndarray
    obs_ur: jnp.ndarray
    obs_level: jnp.ndarray
    obs_valid: jnp.ndarray
    pre: imu_mod.Preintegrated
    pre_valid: jnp.ndarray
    obs_rig: jnp.ndarray | None = None
    rig_R: jnp.ndarray | None = None
    rig_t: jnp.ndarray | None = None


def _camera_from_body(prob, Rwb, pwb):
    """Tcw per state: Rcw = Rcb Rbw, tcw = tcb - Rcw pwb."""
    Rcw = jnp.einsum("ij,kjl->kil", prob.Rcb, jnp.swapaxes(Rwb, -1, -2))
    tcw = prob.tcb[None] - jnp.einsum("kij,kj->ki", Rcw, pwb)
    return Rcw, tcw


def _vis_terms(cam, prob: VIBAProblem, Rwb, pwb, p, use_huber):
    """Reprojection residuals + Jacobians wrt the BODY right-perturbation
    [phi, dp] and the landmark. Mirrors ba._obs_terms with the body chain
    rule: q = Rbw (x - pwb); dq/dphi = hat(q); dq/ddp = -Rbw; dq/dx = Rbw."""
    Rcw, tcw = _camera_from_body(prob, Rwb, pwb)
    Ro = Rcw[prob.obs_cam]          # (P,D,3,3)
    to = tcw[prob.obs_cam]
    Rbw_o = jnp.swapaxes(Rwb, -1, -2)[prob.obs_cam]  # (P,D,3,3)
    pc0 = jnp.einsum("pdij,pj->pdi", Ro, p) + to  # cam0 frame
    if prob.obs_rig is None:
        pc = pc0
    else:  # second-camera offset (EdgeSE3ProjectXYZToBody chain)
        A_rig = prob.rig_R[prob.obs_rig]          # (P,D,3,3)
        pc = (jnp.einsum("pdij,pdj->pdi", A_rig, pc0)
              + prob.rig_t[prob.obs_rig])
    z = jnp.maximum(pc[..., 2], 1e-6)
    uv_hat = cameras.project(cam, pc)
    is_stereo = prob.obs_ur >= 0.0
    ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], z)
    r_uv = prob.obs_uv - uv_hat
    r_ur = jnp.where(is_stereo, prob.obs_ur - ur_hat, 0.0)
    r = jnp.concatenate([r_uv, r_ur[..., None]], axis=-1)
    row_mask = jnp.concatenate(
        [
            jnp.broadcast_to(prob.obs_valid[..., None], r_uv.shape),
            (prob.obs_valid & is_stereo)[..., None],
        ],
        axis=-1,
    )
    J_proj = cameras.project_jac(cam, pc)
    d_ur_dpc = J_proj[..., 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), cam.bf / (z * z)], axis=-1
    )
    dh_dpc = jnp.concatenate([J_proj, d_ur_dpc[..., None, :]], axis=-2)  # (P,D,3,3)

    q = jnp.einsum("pdij,pdj->pdi", Rbw_o, p[:, None] - pwb[prob.obs_cam])
    A = jnp.einsum("ij,pdjk->pdik", prob.Rcb, lie.hat(q))       # dpc0/dphi
    B = -jnp.einsum("ij,pdjk->pdik", prob.Rcb, Rbw_o)           # dpc0/ddp
    if prob.obs_rig is not None:  # chain through the rig offset: dpc = A_rig dpc0
        A = jnp.einsum("pdij,pdjk->pdik", A_rig, A)
        B = jnp.einsum("pdij,pdjk->pdik", A_rig, B)
    Jpose = -jnp.concatenate(
        [jnp.einsum("pdri,pdik->pdrk", dh_dpc, A),
         jnp.einsum("pdri,pdik->pdrk", dh_dpc, B)], axis=-1
    )  # (P,D,3,6)
    Jp = -jnp.einsum("pdri,pdik->pdrk", dh_dpc, -B)             # (P,D,3,3) via (A_rig) Rcb Rbw

    info = robust.inv_level_sigma2(prob.obs_level)
    chi2 = jnp.sum(jnp.where(row_mask, r * r, 0.0), axis=-1) * info
    delta2 = jnp.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    w = robust.huber_weight(chi2, delta2) if use_huber else jnp.ones_like(chi2)
    w = jnp.where(prob.obs_valid, w * info, 0.0)
    return r, Jpose, Jp, w, chi2, row_mask, delta2


def _inertial_terms(prob: VIBAProblem, Rwb, pwb, vel, bias):
    """Per-consecutive-pair 9-dim residuals + autodiff Jacobians wrt both
    15-dim states. Returns (r (F,9), Ji (F,9,15), Jj (F,9,15), info (F,9,9),
    walk residual/Jacobian pieces)."""
    K = Rwb.shape[0]

    def factor(i):
        pre_i = jax.tree.map(lambda a: a[i], prob.pre)
        info = imu_mod.information(pre_i)

        def res(xi, xj):
            Ri = Rwb[i] @ lie.so3_exp(xi[:3])
            pi = pwb[i] + xi[3:6]
            vi = vel[i] + xi[6:9]
            bi = bias[i] + xi[9:15]
            Rj = Rwb[i + 1] @ lie.so3_exp(xj[:3])
            pj = pwb[i + 1] + xj[3:6]
            vj = vel[i + 1] + xj[6:9]
            return imu_mod.inertial_residual(Ri, pi, vi, Rj, pj, vj, bi, pre_i)

        z = jnp.zeros(CDIM)
        r = res(z, z)
        Ji = jax.jacfwd(lambda x: res(x, z))(z)
        Jj = jax.jacfwd(lambda x: res(z, x))(z)
        # whiten
        Lt = jnp.linalg.cholesky(info + 1e-8 * jnp.eye(9)).T
        return Lt @ r, Lt @ Ji, Lt @ Jj

    r, Ji, Jj = jax.vmap(factor)(jnp.arange(K - 1))
    m = prob.pre_valid.astype(r.dtype)
    return r * m[:, None], Ji * m[:, None, None], Jj * m[:, None, None]


def _walk_terms(prob: VIBAProblem, bias):
    """Bias random-walk factors between consecutive states."""
    K = bias.shape[0]

    def factor(i):
        pre_i_C = prob.pre.C[i][9:15, 9:15]
        info = jnp.linalg.inv(pre_i_C + 1e-9 * jnp.eye(6))
        Lt = jnp.linalg.cholesky(info + 1e-9 * jnp.eye(6)).T
        r = Lt @ (bias[i + 1] - bias[i])
        return r, Lt

    r, Lts = jax.vmap(factor)(jnp.arange(K - 1))
    m = prob.pre_valid.astype(r.dtype)
    return r * m[:, None], Lts * m[:, None, None]


def _total_cost(cam, prob, Rwb, pwb, vel, bias, p, use_huber):
    _, _, _, _, chi2, _, delta2 = _vis_terms(cam, prob, Rwb, pwb, p, use_huber)
    c_vis = jnp.sum(
        jnp.where(
            prob.obs_valid,
            robust.huber_cost(chi2, delta2) if use_huber else chi2,
            0.0,
        )
    )
    r_imu, _, _ = _inertial_terms(prob, Rwb, pwb, vel, bias)
    r_walk, _ = _walk_terms(prob, bias)
    return c_vis + jnp.sum(r_imu**2) + jnp.sum(r_walk**2)


@functools.partial(jax.jit, static_argnames=("cam", "iters", "use_huber"))
def vi_bundle_adjust(cam: cameras.Camera, prob: VIBAProblem, iters: int = 10,
                     use_huber: bool = True):
    """LM over (body states, landmarks). Returns (Rwb, pwb, vel, bias, p,
    obs_inlier, cost). Traced at matmul precision 'highest', as
    ba.bundle_adjust: the inertial factors' large information weights make
    the 15-wide normal equations sensitive to reduced-precision matmul
    inputs. At 'high' an H100 (TF32) ended 0.2% above the CPU's final cost
    with keyframes 3 mm apart."""
    with jax.default_matmul_precision("highest"):
        return _vi_ba_body(cam, prob, iters, use_huber)


@functools.partial(jax.jit, static_argnames=("cam", "iters", "use_huber"))
def vi_bundle_adjust_step(cam: cameras.Camera, prob: VIBAProblem,
                          lam0: jnp.ndarray, iters: int = 2,
                          use_huber: bool = True):
    """A lam-threaded BITE of VI-LM iterations (no final classification pass).
    Chained bites are bit-identical to one `vi_bundle_adjust` of the same
    total iters; the mapper yields the device stream between bites when it
    shares the chip with the tracker (see optim.ba.bundle_adjust_step).
    Returns (Rwb, pwb, vel, bias, p, lam)."""
    with jax.default_matmul_precision("highest"):
        return _vi_ba_loop(cam, prob, lam0, iters, use_huber)


def _vi_ba_body(cam, prob, iters, use_huber):
    Rwb, pwb, vel, bias, p, _ = _vi_ba_loop(
        cam, prob, jnp.array(1e-4), iters, use_huber
    )
    _, _, _, _, chi2, _, delta2 = _vis_terms(cam, prob, Rwb, pwb, p, False)
    inlier = prob.obs_valid & (chi2 <= delta2)
    cost = _total_cost(cam, prob, Rwb, pwb, vel, bias, p, False)
    return Rwb, pwb, vel, bias, p, inlier, cost


def _solve_body_system(prob, Rwb, pwb, vel, bias, S6, rhs6, lam):
    """Embed the visual reduced camera system (6-wide) into the 15-wide body
    system, add the inertial + bias-walk factors, damp, and solve. Returns
    the (K, 15) state update dx with fixed poses zeroed."""
    K = Rwb.shape[0]
    eye15 = jnp.eye(CDIM)
    S = jnp.zeros((K, K, CDIM, CDIM))
    S = S.at[:, :, :6, :6].set(S6)
    rhs = jnp.zeros((K, CDIM)).at[:, :6].set(rhs6)

    # inertial factors
    ri, Ji, Jj = _inertial_terms(prob, Rwb, pwb, vel, bias)
    idx_i = jnp.arange(K - 1)
    idx_j = idx_i + 1
    S = S.at[idx_i, idx_i].add(jnp.einsum("fri,frj->fij", Ji, Ji))
    S = S.at[idx_j, idx_j].add(jnp.einsum("fri,frj->fij", Jj, Jj))
    S = S.at[idx_i, idx_j].add(jnp.einsum("fri,frj->fij", Ji, Jj))
    S = S.at[idx_j, idx_i].add(jnp.einsum("fri,frj->fij", Jj, Ji))
    rhs = rhs.at[idx_i].add(-jnp.einsum("fri,fr->fi", Ji, ri))
    rhs = rhs.at[idx_j].add(-jnp.einsum("fri,fr->fi", Jj, ri))

    # bias random walk (acts on components 9:15 of both states)
    rw, Lts = _walk_terms(prob, bias)
    Jw = jnp.zeros((K - 1, 6, CDIM)).at[:, :, 9:15].set(-Lts)
    Jw2 = jnp.zeros((K - 1, 6, CDIM)).at[:, :, 9:15].set(Lts)
    S = S.at[idx_i, idx_i].add(jnp.einsum("fri,frj->fij", Jw, Jw))
    S = S.at[idx_j, idx_j].add(jnp.einsum("fri,frj->fij", Jw2, Jw2))
    S = S.at[idx_i, idx_j].add(jnp.einsum("fri,frj->fij", Jw, Jw2))
    S = S.at[idx_j, idx_i].add(jnp.einsum("fri,frj->fij", Jw2, Jw))
    rhs = rhs.at[idx_i].add(-jnp.einsum("fri,fr->fi", Jw, rw))
    rhs = rhs.at[idx_j].add(-jnp.einsum("fri,fr->fi", Jw2, rw))

    # damping + fixed priors. `fixed` pins only the POSE components —
    # velocities/biases of fixed keyframes stay free (FullInertialBA
    # fixes VertexPose but not VertexVelocity, Optimizer.cc:3284-3320).
    diag = jnp.maximum(jnp.diagonal(S[jnp.arange(K), jnp.arange(K)], axis1=-2, axis2=-1), 1e-6)
    damp = lam * diag[..., None, :] * eye15
    pose_eye = jnp.diag(jnp.concatenate([jnp.ones(6), jnp.zeros(9)]))
    fixed = prob.fixed[:, None, None] * ba.FIXED_PRIOR * pose_eye
    S = S.at[jnp.arange(K), jnp.arange(K)].add(damp + fixed + 1e-5 * eye15)

    Sd = S.transpose(0, 2, 1, 3).reshape(K * CDIM, K * CDIM)
    rd = rhs.reshape(K * CDIM)
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(Sd), 1e-12))
    L = jax.scipy.linalg.cho_factor(Sd / d[:, None] / d[None, :])
    dx = (jax.scipy.linalg.cho_solve(L, rd / d) / d).reshape(K, CDIM)
    # zero only the pose update of fixed states
    pose_mask = jnp.concatenate([jnp.ones(6, bool), jnp.zeros(9, bool)])
    return jnp.where(prob.fixed[:, None] & pose_mask[None, :], 0.0, dx)


def _vi_ba_loop(cam, prob, lam0, iters, use_huber):
    K = prob.Rwb.shape[0]

    def body_step(_, carry):
        Rwb, pwb, vel, bias, p, lam = carry
        r, Jpose, Jp, w, chi2, row_mask, delta2 = _vis_terms(
            cam, prob, Rwb, pwb, p, use_huber
        )
        cost0 = _total_cost(cam, prob, Rwb, pwb, vel, bias, p, use_huber)

        # visual blocks (6-wide) + Schur pieces, reusing optim.ba internals
        vis_prob = ba.BAProblem(
            cam_R=jnp.zeros((K, 3, 3)), cam_t=jnp.zeros((K, 3)),
            cam_fixed=prob.fixed, p=p, p_valid=prob.p_valid,
            obs_cam=prob.obs_cam, obs_uv=prob.obs_uv, obs_ur=prob.obs_ur,
            obs_level=prob.obs_level, obs_valid=prob.obs_valid,
        )
        H_pp, b_p, H_cc6, b_c6, W = ba._assemble(
            vis_prob, r, Jpose, Jp, w, row_mask, K
        )
        Hpp_inv = ba._point_blocks_inv(H_pp, prob.p_valid, lam)
        S6, rhs6 = ba._reduced_system(prob.obs_cam, H_cc6, b_c6, W, Hpp_inv, b_p, K)

        dx = _solve_body_system(prob, Rwb, pwb, vel, bias, S6, rhs6, lam)

        dp_pts = ba._backsubstitute(
            prob.obs_cam, W, Hpp_inv, b_p, prob.p_valid, dx[:, :6]
        )

        Rwb_n = jnp.einsum("kij,kjl->kil", Rwb, jax.vmap(lie.so3_exp)(dx[:, :3]))
        pwb_n = pwb + dx[:, 3:6]
        vel_n = vel + dx[:, 6:9]
        bias_n = bias + dx[:, 9:15]
        p_n = p + dp_pts

        cost1 = _total_cost(cam, prob, Rwb_n, pwb_n, vel_n, bias_n, p_n, use_huber)
        better = cost1 < cost0
        Rwb = jnp.where(better, Rwb_n, Rwb)
        pwb = jnp.where(better, pwb_n, pwb)
        vel = jnp.where(better, vel_n, vel)
        bias = jnp.where(better, bias_n, bias)
        p = jnp.where(better, p_n, p)
        lam = jnp.where(better, lam * 0.5, lam * 5.0)
        return Rwb, pwb, vel, bias, p, lam

    return jax.lax.fori_loop(
        0, iters, body_step,
        (prob.Rwb, prob.pwb, prob.vel, prob.bias, prob.p,
         lam0.astype(prob.pwb.dtype)),
    )


# --------------------------------------------------------------------------
# Whole-map FullInertialBA: same LM math, visual Schur assembled as a
# lax.scan over point CHUNKS so HBM stays flat as the map grows — the
# inertial-GBA equivalent of ba.bundle_adjust_resumable. The reference's
# FullInertialBA optimizes ALL map points (Optimizer.cc:3254); this path
# removes the first-N-by-id truncation the dense solver's memory ceiling
# used to force.


def _vi_vis_chunk(cam, prob, Rwb, pwb, p_c, pv_c, oc, ouv, our, olv, ovd,
                  lam, K, use_huber, orc=None):
    """One point-chunk's contribution to the reduced 6-wide camera system
    (mirrors ba._camera_system_chunk with body-frame pose Jacobians)."""
    from . import robust as _robust

    prob_c = prob._replace(p=p_c, p_valid=pv_c, obs_cam=oc, obs_uv=ouv,
                           obs_ur=our, obs_level=olv, obs_valid=ovd,
                           obs_rig=orc)
    r, Jpose, Jp, w, chi2, row_mask, delta2 = _vis_terms(
        cam, prob_c, Rwb, pwb, p_c, use_huber
    )
    cost = jnp.sum(jnp.where(
        ovd, _robust.huber_cost(chi2, delta2) if use_huber else chi2, 0.0))
    P, D = oc.shape
    Jcm = jnp.where(row_mask[..., None], Jpose, 0.0)
    Jpm = jnp.where(row_mask[..., None], Jp, 0.0)
    rm = jnp.where(row_mask, r, 0.0)

    H_pp = jnp.einsum("pdri,pd,pdrj->pij", Jpm, w, Jpm)
    b_p = -jnp.einsum("pdri,pd,pdr->pi", Jpm, w, rm)
    Hpp_inv = ba._point_blocks_inv(H_pp, pv_c, lam)

    Hc_blocks = jnp.einsum("pdri,pd,pdrj->pdij", Jcm, w, Jcm)   # (P,D,6,6)
    bc_blocks = -jnp.einsum("pdri,pd,pdr->pdi", Jcm, w, rm)     # (P,D,6)
    W = jnp.einsum("pdri,pd,pdrj->pdij", Jcm, w, Jpm)           # (P,D,6,3)

    flat_cam = oc.reshape(P * D)
    H_cc = jax.ops.segment_sum(Hc_blocks.reshape(P * D, 6, 6), flat_cam, K)
    b_c = jax.ops.segment_sum(bc_blocks.reshape(P * D, 6), flat_cam, K)

    WHinv = jnp.einsum("pdij,pjk->pdik", W, Hpp_inv)            # (P,D,6,3)
    WHb = jnp.einsum("pdia,pa->pdi", WHinv, b_p)                # (P,D,6)
    rhs = b_c - jax.ops.segment_sum(WHb.reshape(P * D, 6), flat_cam, K)
    S_pair = jnp.einsum("pdia,peja->pdeij", WHinv, W)           # (P,D,D,6,6)
    pair_idx = oc[:, :, None] * K + oc[:, None, :]
    S_corr = jax.ops.segment_sum(
        S_pair.reshape(P * D * D, 6, 6), pair_idx.reshape(P * D * D), K * K
    ).reshape(K, K, 6, 6)
    S = -S_corr
    S = S.at[jnp.arange(K), jnp.arange(K)].add(H_cc)
    return S, rhs, cost, W, Hpp_inv, b_p


@functools.partial(
    jax.jit, static_argnames=("cam", "iters", "use_huber", "point_chunk")
)
def vi_bundle_adjust_chunked(cam: cameras.Camera, prob: VIBAProblem,
                             lam0: jnp.ndarray, iters: int = 2,
                             use_huber: bool = True, point_chunk: int = 2048):
    """A lam-threaded BITE of whole-map VI-LM iterations with the visual
    Schur system accumulated over point chunks. P must be a multiple of
    point_chunk (pad with invalid points). Returns
    (Rwb, pwb, vel, bias, p, lam) for host-side bite chaining with abort
    checks between bites (mbStopGBA, LoopClosing.cc:3067)."""
    with jax.default_matmul_precision("highest"):
        K = prob.Rwb.shape[0]
        P, D = prob.obs_cam.shape
        C = P // point_chunk

        def reshape_c(x):
            return x.reshape((C, point_chunk) + x.shape[1:])

        has_rig = prob.obs_rig is not None
        obs_c = (reshape_c(prob.p_valid), reshape_c(prob.obs_cam),
                 reshape_c(prob.obs_uv), reshape_c(prob.obs_ur),
                 reshape_c(prob.obs_level), reshape_c(prob.obs_valid))
        if has_rig:
            obs_c = obs_c + (reshape_c(prob.obs_rig),)

        def lm_iter(carry, _):
            Rwb, pwb, vel, bias, p, lam = carry

            def scan_body(acc, xs):
                S_a, rhs_a, cost_a = acc
                p_c, pv, oc, ouv, our, olv, ovd = xs[:7]
                S, rhs, cost, W, Hpp_inv, b_p = _vi_vis_chunk(
                    cam, prob, Rwb, pwb, p_c, pv, oc, ouv, our, olv, ovd,
                    lam, K, use_huber, orc=xs[7] if has_rig else None,
                )
                return (S_a + S, rhs_a + rhs, cost_a + cost), (W, Hpp_inv, b_p)

            init = (jnp.zeros((K, K, 6, 6), p.dtype),
                    jnp.zeros((K, 6), p.dtype), jnp.zeros((), p.dtype))
            (S6, rhs6, cost_vis), (Ws, Hinvs, b_ps) = jax.lax.scan(
                scan_body, init, (reshape_c(p),) + obs_c
            )
            r_imu, _, _ = _inertial_terms(prob, Rwb, pwb, vel, bias)
            r_walk, _ = _walk_terms(prob, bias)
            cost0 = cost_vis + jnp.sum(r_imu**2) + jnp.sum(r_walk**2)

            dx = _solve_body_system(prob, Rwb, pwb, vel, bias, S6, rhs6, lam)
            dp_pts = ba._backsubstitute(
                prob.obs_cam, Ws.reshape(P, D, 6, 3), Hinvs.reshape(P, 3, 3),
                b_ps.reshape(P, 3), prob.p_valid, dx[:, :6]
            )

            Rwb_n = jnp.einsum(
                "kij,kjl->kil", Rwb, jax.vmap(lie.so3_exp)(dx[:, :3]))
            pwb_n = pwb + dx[:, 3:6]
            vel_n = vel + dx[:, 6:9]
            bias_n = bias + dx[:, 9:15]
            p_n = p + dp_pts

            cost1 = _total_cost(
                cam, prob, Rwb_n, pwb_n, vel_n, bias_n, p_n, use_huber)
            better = cost1 < cost0
            Rwb = jnp.where(better, Rwb_n, Rwb)
            pwb = jnp.where(better, pwb_n, pwb)
            vel = jnp.where(better, vel_n, vel)
            bias = jnp.where(better, bias_n, bias)
            p = jnp.where(better, p_n, p)
            lam = jnp.where(better, lam * 0.5, lam * 5.0)
            return (Rwb, pwb, vel, bias, p, lam), cost0

        (Rwb, pwb, vel, bias, p, lam), _ = jax.lax.scan(
            lm_iter,
            (prob.Rwb, prob.pwb, prob.vel, prob.bias, prob.p,
             lam0.astype(prob.pwb.dtype)),
            None, length=iters,
        )
        return Rwb, pwb, vel, bias, p, lam
