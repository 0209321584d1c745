"""Windowed / global bundle adjustment: batched Levenberg-Marquardt with
sparse Schur-complement reduction of landmarks.

JAX replacement for the reference's g2o BlockSolver_6_3 +
OptimizationAlgorithmLevenberg pipeline with marginalized landmarks
(reference: src/Optimizer.cc:1758 LocalBundleAdjustment, :2850
BundleAdjustment with setMarginalized(true) at :1991 => Schur).

Design (SURVEY.md §7.1): the problem ships as fixed-shape padded SoA arrays —
K camera poses, P landmarks, observations laid out as a dense (P, D) per-point
table (D = max observations per point). Per LM iteration, everything is one
fused XLA program:

  residuals/Jacobians  : vmapped closed forms over (P, D)
  H_pp (P,3,3), b_p    : reductions over the D axis
  H_cc, b_c            : segment_sum over flattened observations by camera
  W = Jc^T Omega Jp    : per-observation (6,3) blocks
  Schur complement     : S = H_cc - sum_p W_p Hpp^-1 W_p^T assembled via a
                         (P, D, D) pair expansion + segment_sum into (K,K)
                         6x6 blocks; reduced system is dense (6K x 6K) and
                         small — a dense matmul + Cholesky
  back-substitution    : dp = Hpp^-1 (b_p - W^T dxc), batched 3x3 solves

Fixed cameras are handled by a large diagonal prior on their blocks (their
updates are numerically zero), replacing g2o's setFixed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie, cameras
from . import robust


class BAProblem(NamedTuple):
    """Padded BA problem. K cams, P points, D max obs per point.

    cam_R: (K,3,3) world->cam rotations; cam_t: (K,3)
    cam_fixed: (K,) bool — gauge/boundary cameras (LocalBA fixed observers)
    p: (P,3) landmark positions
    p_valid: (P,) bool
    obs_cam: (P,D) int32 camera index (0 if padded)
    obs_uv: (P,D,2) observed pixels
    obs_ur: (P,D) right-u, <0 for mono observations
    obs_level: (P,D) keypoint octave
    obs_valid: (P,D) bool

    Optional second-camera rig support (the reference's
    EdgeSE3ProjectXYZToBody for non-rectified fisheye stereo,
    OptimizableTypes.h:96-160): obs_rig selects a per-observation rigid
    offset applied AFTER the keyframe pose — slot 0 is the primary camera
    (identity), slot 1 the right camera (x_r = rig_R[1] x_0 + rig_t[1]).
    All three default to None (single-camera problems pay nothing).

    obs_rig: (P,D) int32 rig-camera slot, or None
    rig_R: (S,3,3) cam0->rig-cam rotations (rig_R[0] = I), or None
    rig_t: (S,3) matching translations, or None
    """

    cam_R: jnp.ndarray
    cam_t: jnp.ndarray
    cam_fixed: jnp.ndarray
    p: jnp.ndarray
    p_valid: jnp.ndarray
    obs_cam: jnp.ndarray
    obs_uv: jnp.ndarray
    obs_ur: jnp.ndarray
    obs_level: jnp.ndarray
    obs_valid: jnp.ndarray
    obs_rig: jnp.ndarray | None = None
    rig_R: jnp.ndarray | None = None
    rig_t: jnp.ndarray | None = None


FIXED_PRIOR = 1e12


def _obs_terms(cam: cameras.Camera, prob: BAProblem, R, t, p, use_huber: bool):
    """Per-observation residuals, Jacobians, robust weights.

    Returns r (P,D,3), Jc (P,D,3,6), Jp (P,D,3,3), w (P,D), chi2 (P,D),
    row_mask (P,D,3)."""
    Ro = R[prob.obs_cam]          # (P,D,3,3)
    to = t[prob.obs_cam]          # (P,D,3)
    pc0 = jnp.einsum("pdij,pj->pdi", Ro, p) + to  # primary-camera frame
    if prob.obs_rig is None:
        pc = pc0
    else:
        # rig-camera chain (EdgeSE3ProjectXYZToBody): x_rig = A x_0 + b
        A = prob.rig_R[prob.obs_rig]              # (P,D,3,3)
        pc = jnp.einsum("pdij,pdj->pdi", A, pc0) + prob.rig_t[prob.obs_rig]
    z = jnp.maximum(pc[..., 2], 1e-6)
    uv_hat = cameras.project(cam, pc)
    is_stereo = prob.obs_ur >= 0.0
    ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], z)

    r_uv = prob.obs_uv - uv_hat
    r_ur = jnp.where(is_stereo, prob.obs_ur - ur_hat, 0.0)
    r = jnp.concatenate([r_uv, r_ur[..., None]], axis=-1)  # (P,D,3)
    row_mask = jnp.concatenate(
        [
            jnp.broadcast_to(prob.obs_valid[..., None], r_uv.shape),
            (prob.obs_valid & is_stereo)[..., None],
        ],
        axis=-1,
    )

    J_proj = cameras.project_jac(cam, pc)  # (P,D,2,3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))
    # perturbation acts on the PRIMARY-camera pose: dpc0/dxi = [I, -hat(pc0)]
    dpc0_dxi = jnp.concatenate([eye, -lie.hat(pc0)], axis=-1)  # (P,D,3,6)
    if prob.obs_rig is None:
        dpc_dxi = dpc0_dxi
        Rp = Ro
    else:  # chain through the rig offset: dpc = A dpc0
        dpc_dxi = jnp.einsum("pdij,pdjk->pdik", A, dpc0_dxi)
        Rp = jnp.einsum("pdij,pdjk->pdik", A, Ro)
    d_ur_dpc = J_proj[..., 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), cam.bf / (z * z)], axis=-1
    )  # (P,D,3)
    dh_dpc = jnp.concatenate([J_proj, d_ur_dpc[..., None, :]], axis=-2)  # (P,D,3,3)
    Jc = -jnp.einsum("pdri,pdik->pdrk", dh_dpc, dpc_dxi)  # (P,D,3,6)
    Jp = -jnp.einsum("pdri,pdik->pdrk", dh_dpc, Rp)       # (P,D,3,3)

    info = robust.inv_level_sigma2(prob.obs_level)
    chi2 = jnp.sum(jnp.where(row_mask, r * r, 0.0), axis=-1) * info
    delta2 = jnp.where(is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    w = robust.huber_weight(chi2, delta2) if use_huber else jnp.ones_like(chi2)
    w = jnp.where(prob.obs_valid, w * info, 0.0)
    return r, Jc, Jp, w, chi2, row_mask, delta2


def _assemble(prob: BAProblem, r, Jc, Jp, w, row_mask, K: int):
    """Normal-equation blocks + Schur complement pieces."""
    P, D = prob.obs_cam.shape
    Jcm = jnp.where(row_mask[..., None], Jc, 0.0)
    Jpm = jnp.where(row_mask[..., None], Jp, 0.0)
    rm = jnp.where(row_mask, r, 0.0)

    # Landmark blocks. RHS uses b = -J^T W r so that H dx = b is the descent
    # Gauss-Newton system (J = dr/dx).
    H_pp = jnp.einsum("pdri,pd,pdrj->pij", Jpm, w, Jpm)  # (P,3,3)
    b_p = -jnp.einsum("pdri,pd,pdr->pi", Jpm, w, rm)     # (P,3)

    # Camera blocks via one-hot contraction (scatter-free; a dense einsum)
    G = jax.nn.one_hot(prob.obs_cam, K, dtype=Jcm.dtype)             # (P,D,K)
    Hc_blocks = jnp.einsum("pdri,pd,pdrj->pdij", Jcm, w, Jcm)
    bc_blocks = -jnp.einsum("pdri,pd,pdr->pdi", Jcm, w, rm)
    H_cc = jnp.einsum("pdk,pdij->kij", G, Hc_blocks)                 # (K,6,6)
    b_c = jnp.einsum("pdk,pdi->ki", G, bc_blocks)                    # (K,6)

    # Coupling blocks W_o = Jc^T w Jp per observation: (P,D,6,3)
    W = jnp.einsum("pdri,pd,pdrj->pdij", Jcm, w, Jpm)
    return H_pp, b_p, H_cc, b_c, W


def _point_blocks_inv(H_pp, p_valid, lam):
    """Damped inverse of the landmark 3x3 blocks (local to a shard)."""
    dtype = H_pp.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    H_pp_d = H_pp + lam * jnp.eye(3, dtype=dtype) * jnp.maximum(
        jnp.diagonal(H_pp, axis1=-2, axis2=-1), 1e-6
    )[..., None, :] * eye3
    H_pp_d = H_pp_d + (~p_valid)[:, None, None] * eye3
    return jnp.linalg.inv(H_pp_d + 1e-8 * eye3)


def _reduced_system(obs_cam, H_cc, b_c, W, Hpp_inv, b_p, K: int):
    """Schur-reduced camera system pieces (S (K,K,6,6), rhs (K,6)). This is
    the part a distributed BA psums across landmark shards (SURVEY.md §5.8):
    every term is a sum over points/observations."""
    P, D = obs_cam.shape
    # one-hot camera-slot contraction: materializing the per-point pair
    # tensor (P,D,D,6,6) + a 524k-segment scatter-add costs ~75 MB of HBM
    # traffic per LM iteration; phrasing the same sums as dense einsums
    # keeps everything in matmuls with (P,K,6,3)-sized intermediates
    G = jax.nn.one_hot(obs_cam, K, dtype=W.dtype)          # (P,D,K)
    WHb = jnp.einsum("pdij,pjk,pk->pdi", W, Hpp_inv, b_p)  # (P,D,6)
    rhs = b_c - jnp.einsum("pdk,pdi->ki", G, WHb)
    WG = jnp.einsum("pdij,pjk->pdik", W, Hpp_inv)          # (P,D,6,3)
    T1 = jnp.einsum("pdk,pdia->pkia", G, WG)               # (P,K,6,3)
    T2 = jnp.einsum("pdk,pdja->pkja", G, W)                # (P,K,6,3)
    S_corr = jnp.einsum("pkia,plja->klij", T1, T2)         # (K,K,6,6)
    S = -S_corr
    S = S.at[jnp.arange(K), jnp.arange(K)].add(H_cc)
    return S, rhs


def _solve_reduced(S, rhs, cam_fixed, H_cc_diag, lam, K: int):
    """Dense scaled-Cholesky solve of the reduced camera system."""
    dtype = S.dtype
    eye6 = jnp.eye(6, dtype=dtype)
    diag_scale = jnp.maximum(H_cc_diag, 1e-6)
    damp = lam * diag_scale[..., None, :] * eye6
    fixed = cam_fixed[:, None, None] * FIXED_PRIOR * eye6
    S = S.at[jnp.arange(K), jnp.arange(K)].add(damp + fixed + 1e-6 * eye6)
    S_dense = S.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
    rhs_dense = rhs.reshape(K * 6)
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(S_dense), 1e-12))
    S_scaled = S_dense / d[:, None] / d[None, :]
    L = jax.scipy.linalg.cho_factor(S_scaled)
    dxc = jax.scipy.linalg.cho_solve(L, rhs_dense / d) / d
    dxc = dxc.reshape(K, 6)
    return jnp.where(cam_fixed[:, None], 0.0, dxc)


def _backsubstitute(obs_cam, W, Hpp_inv, b_p, p_valid, dxc):
    """dp = Hpp_inv (b_p - sum_o W_o^T dxc_o) — local per landmark shard."""
    Wtdx = jnp.einsum("pdij,pdi->pj", W, dxc[obs_cam])  # (P,3)
    dp = jnp.einsum("pij,pj->pi", Hpp_inv, b_p - Wtdx)
    return jnp.where(p_valid[:, None], dp, 0.0)


def _schur_solve(prob: BAProblem, H_pp, b_p, H_cc, b_c, W, lam, K: int):
    """Form the reduced camera system and solve; back-substitute landmarks."""
    Hpp_inv = _point_blocks_inv(H_pp, prob.p_valid, lam)
    S, rhs = _reduced_system(prob.obs_cam, H_cc, b_c, W, Hpp_inv, b_p, K)
    H_cc_diag = jnp.diagonal(H_cc, axis1=-2, axis2=-1)
    dxc = _solve_reduced(S, rhs, prob.cam_fixed, H_cc_diag, lam, K)
    dp = _backsubstitute(prob.obs_cam, W, Hpp_inv, b_p, prob.p_valid, dxc)
    return dxc, dp


def _cost(chi2, delta2, obs_valid, use_huber: bool):
    c = robust.huber_cost(chi2, delta2) if use_huber else chi2
    return jnp.sum(jnp.where(obs_valid, c, 0.0))


# --------------------------------------------------------------------------
# Full-map ("global") BA: the same LM/Schur math, restructured for problems
# where K is hundreds of cameras and P is the whole map. Two changes vs the
# windowed path:
#   * camera-system assembly runs as a lax.scan over point CHUNKS, so the
#     K-sized intermediates are bounded by the chunk (HBM stays flat as the
#     map grows);
#   * the Schur cross-term is assembled by observation-pair expansion +
#     segment_sum into (K*K) 6x6 blocks instead of the dense one-hot einsum —
#     at large K the dense route costs O(P K^2) flops for a matrix that is
#     actually D^2-sparse per point.
# The LM loop is dispatched in host-sized bites (`bundle_adjust_resumable`)
# so the mapper can check an abort flag between bites — the reference's
# mbStopGBA pattern (LoopClosing.cc:3067, Optimizer.cc:2831).


def _camera_system_chunk(cam, prob_c, R, t, lam, K, use_huber):
    """One point-chunk's contribution to the reduced camera system."""
    P, D = prob_c.obs_cam.shape
    r, Jc, Jp, w, chi2, row_mask, delta2 = _obs_terms(
        cam, prob_c, R, t, prob_c.p, use_huber
    )
    cost = _cost(chi2, delta2, prob_c.obs_valid, use_huber)
    Jcm = jnp.where(row_mask[..., None], Jc, 0.0)
    Jpm = jnp.where(row_mask[..., None], Jp, 0.0)
    rm = jnp.where(row_mask, r, 0.0)

    H_pp = jnp.einsum("pdri,pd,pdrj->pij", Jpm, w, Jpm)
    b_p = -jnp.einsum("pdri,pd,pdr->pi", Jpm, w, rm)
    Hpp_inv = _point_blocks_inv(H_pp, prob_c.p_valid, lam)

    Hc_blocks = jnp.einsum("pdri,pd,pdrj->pdij", Jcm, w, Jcm)   # (P,D,6,6)
    bc_blocks = -jnp.einsum("pdri,pd,pdr->pdi", Jcm, w, rm)     # (P,D,6)
    W = jnp.einsum("pdri,pd,pdrj->pdij", Jcm, w, Jpm)           # (P,D,6,3)

    flat_cam = prob_c.obs_cam.reshape(P * D)
    H_cc = jax.ops.segment_sum(Hc_blocks.reshape(P * D, 6, 6), flat_cam, K)
    b_c = jax.ops.segment_sum(bc_blocks.reshape(P * D, 6), flat_cam, K)

    # Schur pieces: rhs -= sum_o W_o Hpp^-1 b_p ; S -= W Hpp^-1 W^T per
    # camera PAIR of each point (observation-pair expansion)
    WHinv = jnp.einsum("pdij,pjk->pdik", W, Hpp_inv)            # (P,D,6,3)
    WHb = jnp.einsum("pdia,pa->pdi", WHinv, b_p)                # (P,D,6)
    rhs = b_c - jax.ops.segment_sum(WHb.reshape(P * D, 6), flat_cam, K)
    S_pair = jnp.einsum("pdia,peja->pdeij", WHinv, W)           # (P,D,D,6,6)
    pair_idx = (prob_c.obs_cam[:, :, None] * K + prob_c.obs_cam[:, None, :])
    S_corr = jax.ops.segment_sum(
        S_pair.reshape(P * D * D, 6, 6), pair_idx.reshape(P * D * D), K * K
    ).reshape(K, K, 6, 6)
    S = -S_corr
    S = S.at[jnp.arange(K), jnp.arange(K)].add(H_cc)
    H_cc_diag = jnp.diagonal(H_cc, axis1=-2, axis2=-1)
    return S, rhs, H_cc_diag, cost, W, Hpp_inv, b_p


@functools.partial(
    jax.jit, static_argnames=("cam", "iters", "use_huber", "point_chunk")
)
def bundle_adjust_resumable(
    cam: cameras.Camera,
    prob: BAProblem,
    lam0: jnp.ndarray,
    iters: int = 2,
    use_huber: bool = True,
    point_chunk: int = 2048,
):
    """A bite of `iters` LM iterations on a full-map problem. Returns
    (cam_R, cam_t, p, lam) so the host can chain bites with abort checks
    between them (mbStopGBA, LoopClosing.cc:3067). P must be a multiple of
    point_chunk (pad with invalid points)."""
    with jax.default_matmul_precision("highest"):
        K = prob.cam_R.shape[0]
        P, D = prob.obs_cam.shape
        C = P // point_chunk

        def reshape_c(x):
            return x.reshape((C, point_chunk) + x.shape[1:])

        has_rig = prob.obs_rig is not None
        chunks = BAProblem(
            cam_R=prob.cam_R, cam_t=prob.cam_t, cam_fixed=prob.cam_fixed,
            p=reshape_c(prob.p), p_valid=reshape_c(prob.p_valid),
            obs_cam=reshape_c(prob.obs_cam), obs_uv=reshape_c(prob.obs_uv),
            obs_ur=reshape_c(prob.obs_ur), obs_level=reshape_c(prob.obs_level),
            obs_valid=reshape_c(prob.obs_valid),
            obs_rig=reshape_c(prob.obs_rig) if has_rig else None,
            rig_R=prob.rig_R, rig_t=prob.rig_t,
        )

        def lm_iter(carry, _):
            R, t, p, lam = carry
            p_c_all = p.reshape(C, point_chunk, 3)

            def scan_body(acc, xs):
                S_a, rhs_a, diag_a, cost_a = acc
                p_c, pv, oc, ouv, our, olv, ovd = xs[:7]
                prob_c = BAProblem(
                    cam_R=R, cam_t=t, cam_fixed=prob.cam_fixed,
                    p=p_c, p_valid=pv, obs_cam=oc, obs_uv=ouv,
                    obs_ur=our, obs_level=olv, obs_valid=ovd,
                    obs_rig=xs[7] if has_rig else None,
                    rig_R=prob.rig_R, rig_t=prob.rig_t,
                )
                S, rhs, diag, cost, W, Hpp_inv, b_p = _camera_system_chunk(
                    cam, prob_c, R, t, lam, K, use_huber
                )
                return (
                    (S_a + S, rhs_a + rhs, diag_a + diag, cost_a + cost),
                    (W, Hpp_inv, b_p),
                )

            init = (
                jnp.zeros((K, K, 6, 6), prob.p.dtype),
                jnp.zeros((K, 6), prob.p.dtype),
                jnp.zeros((K, 6), prob.p.dtype),
                jnp.zeros((), prob.p.dtype),
            )
            xs_scan = (
                p_c_all, chunks.p_valid, chunks.obs_cam, chunks.obs_uv,
                chunks.obs_ur, chunks.obs_level, chunks.obs_valid,
            )
            if has_rig:
                xs_scan = xs_scan + (chunks.obs_rig,)
            (S, rhs, diag, cost0), (Ws, Hinvs, b_ps) = jax.lax.scan(
                scan_body, init, xs_scan,
            )
            dxc = _solve_reduced(S, rhs, prob.cam_fixed, diag, lam, K)
            W_full = Ws.reshape(P, D, 6, 3)
            Hinv_full = Hinvs.reshape(P, 3, 3)
            bp_full = b_ps.reshape(P, 3)
            dp = _backsubstitute(
                prob.obs_cam, W_full, Hinv_full, bp_full, prob.p_valid, dxc
            )
            dR, dt = lie.se3_exp(dxc)
            R_new, t_new = lie.se3_mul(dR, dt, R, t)
            p_new = p + dp
            _, _, _, _, chi2_new, _, delta2 = _obs_terms(
                cam, prob, R_new, t_new, p_new, use_huber
            )
            cost1 = _cost(chi2_new, delta2, prob.obs_valid, use_huber)
            better = cost1 < cost0
            R = jnp.where(better, R_new, R)
            t = jnp.where(better, t_new, t)
            p = jnp.where(better, p_new, p)
            lam = jnp.where(better, lam * 0.5, lam * 5.0)
            return (R, t, p, lam), cost0

        (R, t, p, lam), _ = jax.lax.scan(
            lm_iter, (prob.cam_R, prob.cam_t, prob.p, lam0), None, length=iters
        )
        return R, t, p, lam


@functools.partial(jax.jit, static_argnames=("cam",))
def classify_observations(cam: cameras.Camera, prob: BAProblem):
    """Final chi2 inlier classification for a (possibly updated) problem —
    the post-GBA outlier-erase pass (Optimizer.cc:2100-2160)."""
    with jax.default_matmul_precision("highest"):
        _, _, _, _, chi2, _, delta2 = _obs_terms(
            cam, prob, prob.cam_R, prob.cam_t, prob.p, use_huber=False
        )
        inlier = prob.obs_valid & (chi2 <= delta2)
        return inlier


@functools.partial(jax.jit, static_argnames=("cam", "iters", "use_huber"))
def bundle_adjust_step(
    cam: cameras.Camera,
    prob: BAProblem,
    lam0: jnp.ndarray,
    iters: int = 2,
    use_huber: bool = True,
):
    """A BITE of LM iterations with the damping threaded in/out, and NO final
    classification pass. Chaining bites host-side is bit-identical to one
    `bundle_adjust` call of the same total iters, but each device dispatch is
    short — on a single shared chip the mapper yields the stream between
    bites so the tracker's latency-critical per-frame programs interleave
    instead of stalling behind one long BA program (the reference gets the
    same property from preemptive CPU threads, Optimizer.cc:5082 vs
    Tracking thread)."""
    with jax.default_matmul_precision("highest"):
        K = prob.cam_R.shape[0]

        def body(_, carry):
            R, t, p, lam = carry
            r, Jc, Jp, w, chi2, row_mask, delta2 = _obs_terms(
                cam, prob, R, t, p, use_huber
            )
            cost0 = _cost(chi2, delta2, prob.obs_valid, use_huber)
            H_pp, b_p, H_cc, b_c, W = _assemble(prob, r, Jc, Jp, w, row_mask, K)
            dxc, dp = _schur_solve(prob, H_pp, b_p, H_cc, b_c, W, lam, K)
            dR, dt = lie.se3_exp(dxc)
            R_new, t_new = lie.se3_mul(dR, dt, R, t)
            p_new = p + dp
            _, _, _, _, chi2_new, _, _ = _obs_terms(
                cam, prob, R_new, t_new, p_new, use_huber
            )
            cost1 = _cost(chi2_new, delta2, prob.obs_valid, use_huber)
            better = cost1 < cost0
            R = jnp.where(better, R_new, R)
            t = jnp.where(better, t_new, t)
            p = jnp.where(better, p_new, p)
            lam = jnp.where(better, lam * 0.5, lam * 5.0)
            return R, t, p, lam

        R, t, p, lam = jax.lax.fori_loop(
            0, iters, body,
            (prob.cam_R, prob.cam_t, prob.p, lam0.astype(prob.cam_R.dtype)),
        )
        return R, t, p, lam


@functools.partial(jax.jit, static_argnames=("cam", "iters", "use_huber"))
def bundle_adjust(
    cam: cameras.Camera,
    prob: BAProblem,
    iters: int = 10,
    use_huber: bool = True,
):
    """LM loop. Returns (cam_R, cam_t, points, obs_inlier_mask, final_cost).

    The iteration count is a static cap like the reference's
    optimizer.optimize(10) calls; early-exit-on-abort (mbAbortBA) is the
    host's job — it simply doesn't dispatch the next call. Traced under matmul
    precision 'highest': at 'high' an H100 runs the normal equations with
    TF32 inputs, which still matched the CPU on a well-conditioned synthetic
    problem (5e-7 relative cost) but raised the ATE of a live monocular map
    with inline mapping fivefold (0.7 cm -> 3.6 cm, chip_smoke.py phase 5)."""
    with jax.default_matmul_precision("highest"):
        return _bundle_adjust_body(cam, prob, iters, use_huber)


def _bundle_adjust_body(cam, prob, iters, use_huber):
    K = prob.cam_R.shape[0]
    R, t, p = prob.cam_R, prob.cam_t, prob.p

    def body(_, carry):
        R, t, p, lam = carry
        r, Jc, Jp, w, chi2, row_mask, delta2 = _obs_terms(cam, prob, R, t, p, use_huber)
        cost0 = _cost(chi2, delta2, prob.obs_valid, use_huber)
        H_pp, b_p, H_cc, b_c, W = _assemble(prob, r, Jc, Jp, w, row_mask, K)
        dxc, dp = _schur_solve(prob, H_pp, b_p, H_cc, b_c, W, lam, K)
        dR, dt = lie.se3_exp(dxc)
        R_new, t_new = lie.se3_mul(dR, dt, R, t)
        p_new = p + dp
        _, _, _, _, chi2_new, _, _ = _obs_terms(cam, prob, R_new, t_new, p_new, use_huber)
        cost1 = _cost(chi2_new, delta2, prob.obs_valid, use_huber)
        better = cost1 < cost0
        R = jnp.where(better, R_new, R)
        t = jnp.where(better, t_new, t)
        p = jnp.where(better, p_new, p)
        lam = jnp.where(better, lam * 0.5, lam * 5.0)
        return R, t, p, lam

    R, t, p, _ = jax.lax.fori_loop(0, iters, body, (R, t, p, jnp.array(1e-4, R.dtype)))

    # final chi2-based observation classification (LocalBA's post-pass that
    # erases outlier observations, Optimizer.cc:2100-2160)
    _, _, _, _, chi2, _, delta2 = _obs_terms(cam, prob, R, t, p, use_huber=False)
    inlier = prob.obs_valid & (chi2 <= delta2)
    cost = _cost(chi2, delta2, prob.obs_valid, False)
    return R, t, p, inlier, cost
