"""Two-view reconstruction for monocular map initialization.

JAX replacement for TwoViewReconstruction (reference:
src/TwoViewReconstruction.cc): instead of two pthreads racing Homography vs
Fundamental RANSAC (:124-129), ALL hypotheses of BOTH models are scored in one
vmapped batch; model selection keeps the reference's score-ratio rule, motion
recovery mirrors ReconstructH (Faugeras decomposition, 8 motions) and
ReconstructF (E from F, 4 motions) with cheirality/parallax model selection
(CheckRT semantics).

Constants follow the reference: 200 RANSAC iterations, sigma=1.0,
chi2 3.841 (F, 1 dof) / 5.991 (H, 2 dof), RH > 0.50 picks H
(TwoViewReconstruction.cc:146), min 50 triangulated, parallax >= 1 deg.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cameras, triangulate

RANSAC_ITERS = 200
SIGMA = 1.0
TH_F = 3.841
TH_H = 5.991
SCORE_TH = 5.991  # both models accumulate (SCORE_TH - chi2), ref :481,:559
MIN_TRIANGULATED = 50
MIN_PARALLAX_DEG = 1.0


def _normalize(pts: jnp.ndarray, valid: jnp.ndarray):
    """Hartley normalization (TwoViewReconstruction::Normalize, :753)."""
    n = jnp.maximum(jnp.sum(valid), 1)
    mean = jnp.sum(jnp.where(valid[:, None], pts, 0.0), axis=0) / n
    d = jnp.where(valid[:, None], jnp.abs(pts - mean), 0.0)
    meandev = jnp.sum(d, axis=0) / n
    s = 1.0 / jnp.maximum(meandev, 1e-8)
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], pts.dtype
    )
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return (pts - mean) * s, T


def _sample_minimal(key, n_matches, valid, n_sets, set_size):
    """(n_sets, set_size) indices drawn from valid matches. Uses weighted
    gumbel top-k per set so all sets draw in parallel."""
    logits = jnp.where(valid, 0.0, -1e9)
    g = jax.random.gumbel(key, (n_sets, n_matches)) + logits[None]
    _, idx = jax.lax.top_k(g, set_size)
    return idx


def _fit_homography(x1, x2):
    """4+-point DLT: x1, x2 (S,2) normalized -> H (3,3) with x2 ~ H x1."""
    s = x1.shape[0]
    zeros = jnp.zeros((s,), x1.dtype)
    ones = jnp.ones((s,), x1.dtype)
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    rows_a = jnp.stack([zeros, zeros, zeros, -u1, -v1, -ones, v2 * u1, v2 * v1, v2], -1)
    rows_b = jnp.stack([u1, v1, ones, zeros, zeros, zeros, -u2 * u1, -u2 * v1, -u2], -1)
    A = jnp.concatenate([rows_a, rows_b], axis=0)  # (2S, 9)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    return vt[8].reshape(3, 3)


def _fit_fundamental(x1, x2):
    """8-point: A f = 0; enforce rank 2."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1
    )
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[8].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return U @ jnp.diag(S) @ Vt


def _score_homography(H, x1, x2, valid):
    """Symmetric transfer error score (CheckHomography, :414)."""
    Hinv = jnp.linalg.inv(H)

    def transfer(M, a, b):
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], axis=-1)
        p = ah @ M.T
        w = jnp.where(jnp.abs(p[:, 2]) < 1e-9, 1e-9, p[:, 2])
        proj = p[:, :2] / w[:, None]
        return jnp.sum((b - proj) ** 2, axis=-1) / (SIGMA * SIGMA)

    c1 = transfer(H, x1, x2)
    c2 = transfer(Hinv, x2, x1)
    ok = valid & (c1 < TH_H) & (c2 < TH_H)
    score = jnp.sum(
        jnp.where(valid & (c1 < TH_H), SCORE_TH - c1, 0.0)
        + jnp.where(valid & (c2 < TH_H), SCORE_TH - c2, 0.0)
    )
    return score, ok


def _score_fundamental(F, x1, x2, valid):
    """Epipolar distance score (CheckFundamental, :558)."""
    oh = jnp.ones_like(x1[:, :1])
    p1 = jnp.concatenate([x1, oh], -1)
    p2 = jnp.concatenate([x2, oh], -1)
    l2 = p1 @ F.T  # epipolar line in image 2
    l1 = p2 @ F
    num = jnp.sum(p2 * l2, axis=-1)
    d2 = num * num / jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12) / (SIGMA * SIGMA)
    num1 = jnp.sum(p1 * l1, axis=-1)
    d1 = num1 * num1 / jnp.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12) / (SIGMA * SIGMA)
    ok = valid & (d1 < TH_F) & (d2 < TH_F)
    score = jnp.sum(
        jnp.where(valid & (d2 < TH_F), SCORE_TH - d2, 0.0)
        + jnp.where(valid & (d1 < TH_F), SCORE_TH - d1, 0.0)
    )
    return score, ok


def _check_rt(R, t, K, x1, x2, inliers):
    """Triangulate all matches under (R, t) and count good points
    (CheckRT, :905): cheirality in both views, finite, parallax, reprojection
    < 4 sigma^2. Returns (n_good, median_parallax_cos, points, good_mask)."""
    P1 = triangulate.projection_matrix(K, jnp.eye(3, dtype=K.dtype), jnp.zeros(3, K.dtype))
    P2 = triangulate.projection_matrix(K, R, t)
    X = triangulate.triangulate(P1, P2, x1, x2)  # world = cam1 frame
    finite = jnp.all(jnp.isfinite(X), axis=-1)

    C2 = -R.T @ t  # cam2 center in cam1 frame
    n1 = X
    n2 = X - C2
    cosp = jnp.sum(n1 * n2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(n1, axis=-1) * jnp.linalg.norm(n2, axis=-1), 1e-12
    )
    z1 = X[:, 2]
    Xc2 = (R @ X.T).T + t
    z2 = Xc2[:, 2]
    good_depth = (z1 > 0) & (z2 > 0)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj(Xc, x):
        u = fx * Xc[:, 0] / jnp.maximum(Xc[:, 2], 1e-9) + cx
        v = fy * Xc[:, 1] / jnp.maximum(Xc[:, 2], 1e-9) + cy
        return (u - x[:, 0]) ** 2 + (v - x[:, 1]) ** 2

    e1 = reproj(X, x1)
    e2 = reproj(Xc2, x2)
    th2 = 4.0 * SIGMA * SIGMA
    good = inliers & finite & good_depth & (e1 < th2) & (e2 < th2) & (cosp < 0.99998)
    n_good = jnp.sum(good.astype(jnp.int32))
    # parallax of the good points: take a mid-quantile cosine as the ref takes
    # the 50th-best parallax
    cos_masked = jnp.where(good, cosp, 1.0)
    cos_sorted = jnp.sort(cos_masked)
    k = jnp.minimum(49, jnp.maximum(n_good - 1, 0))
    parallax_cos = cos_sorted[k]
    return n_good, parallax_cos, X, good


def _motions_from_f(F, K):
    """E = K^T F K -> 4 candidate (R, t) (DecomposeE, :1079)."""
    E = K.T @ F @ K
    U, _, Vt = jnp.linalg.svd(E)
    # ensure proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], F.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _motions_from_h(H, K):
    """Faugeras SVD decomposition of a calibrated homography -> 8 candidate
    motions (ReconstructH, :661). A = K^-1 H K = d R + t n^T."""
    Kinv = jnp.linalg.inv(K)
    A = Kinv @ H @ K
    U, w, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(V)
    d1, d2, d3 = w[0], w[1], w[2]

    # d' = d2 case
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1v = jnp.array([aux1, aux1, -aux1, -aux1])
    x3v = jnp.array([aux3, -aux3, aux3, -aux3])

    # case d' > 0
    sin_t = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    cos_t = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    stheta = jnp.array([1.0, -1.0, -1.0, 1.0]) * sin_t

    def make_pos(i):
        Rp = jnp.array(
            [
                [cos_t, 0.0, -stheta[i]],
                [0.0, 1.0, 0.0],
                [stheta[i], 0.0, cos_t],
            ],
            H.dtype,
        )
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1v[i], 0.0, -x3v[i]]) * (d1 - d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    # case d' < 0
    sin_p = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cos_p = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sphi = jnp.array([1.0, -1.0, -1.0, 1.0]) * sin_p

    def make_neg(i):
        Rp = jnp.array(
            [
                [cos_p, 0.0, sphi[i]],
                [0.0, -1.0, 0.0],
                [sphi[i], 0.0, -cos_p],
            ],
            H.dtype,
        )
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1v[i], 0.0, x3v[i]]) * (d1 + d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs, ts = [], []
    for i in range(4):
        R, t = make_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = make_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts)


class TwoViewResult(NamedTuple):
    success: jnp.ndarray      # bool
    R: jnp.ndarray            # (3,3) cam1->cam2
    t: jnp.ndarray            # (3,) unit norm
    points: jnp.ndarray       # (N,3) in cam1 frame
    good: jnp.ndarray         # (N,) triangulated-point mask
    used_homography: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cam",))
def reconstruct(
    cam: cameras.Camera,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
) -> TwoViewResult:
    """uv1/uv2: (N,2) matched pixels in frames 1/2; valid: (N,) mask.
    Mirrors TwoViewReconstruction::Reconstruct (:81). Full-f32 matmuls:
    the reconstruction fixes the INITIAL map's geometry - bf16 here would
    seed every downstream estimate with ~0.4% relative error."""
    with jax.default_matmul_precision("highest"):
        return _reconstruct_body(cam, uv1, uv2, valid, key)


def _reconstruct_body(cam, uv1, uv2, valid, key):
    K = cam.K
    n = uv1.shape[0]
    x1n, T1 = _normalize(uv1, valid)
    x2n, T2 = _normalize(uv2, valid)

    k_h, k_f = jax.random.split(key)
    idx_h = _sample_minimal(k_h, n, valid, RANSAC_ITERS, 4)
    idx_f = _sample_minimal(k_f, n, valid, RANSAC_ITERS, 8)

    def h_hyp(idx):
        Hn = _fit_homography(x1n[idx], x2n[idx])
        H = jnp.linalg.inv(T2) @ Hn @ T1
        score, ok = _score_homography(H, uv1, uv2, valid)
        return score, H

    def f_hyp(idx):
        Fn = _fit_fundamental(x1n[idx], x2n[idx])
        F = T2.T @ Fn @ T1
        score, ok = _score_fundamental(F, uv1, uv2, valid)
        return score, F

    h_scores, Hs = jax.vmap(h_hyp)(idx_h)
    f_scores, Fs = jax.vmap(f_hyp)(idx_f)
    bi_h = jnp.argmax(h_scores)
    bi_f = jnp.argmax(f_scores)
    SH, H = h_scores[bi_h], Hs[bi_h]
    SF, F = f_scores[bi_f], Fs[bi_f]
    _, inl_h = _score_homography(H, uv1, uv2, valid)
    _, inl_f = _score_fundamental(F, uv1, uv2, valid)

    RH = SH / jnp.maximum(SH + SF, 1e-9)
    prefer_h = RH > 0.50

    Rs_h, ts_h = _motions_from_h(H, K)  # (8,3,3)
    Rs_f, ts_f = _motions_from_f(F, K)  # (4,3,3)
    Rs = jnp.concatenate([Rs_h, Rs_f])  # (12,...)
    ts = jnp.concatenate([ts_h, ts_f])
    from_h = jnp.arange(12) < 8
    # each candidate is checked against its own model's inlier set
    inl12 = jnp.where(from_h[:, None], inl_h[None, :], inl_f[None, :])

    n_good, par_cos, X, good = jax.vmap(
        lambda R, t, m: _check_rt(R, t, K, uv1, uv2, m)
    )(Rs, ts, inl12)

    def family_pick(member_mask, inl):
        ng = jnp.where(member_mask, n_good, -1)
        best = jnp.argmax(ng)
        best_good = ng[best]
        second = jnp.sort(ng)[-2]
        n_inl = jnp.sum(inl.astype(jnp.int32))
        min_good = jnp.maximum(
            jnp.array(MIN_TRIANGULATED, jnp.int32),
            (0.9 * n_inl.astype(jnp.float32)).astype(jnp.int32),
        )
        parallax_ok = par_cos[best] < jnp.cos(jnp.deg2rad(MIN_PARALLAX_DEG))
        unique = second.astype(jnp.float32) < 0.75 * best_good.astype(jnp.float32)
        ok = (best_good >= min_good) & unique & parallax_ok
        return ok, best

    ok_h, best_h = family_pick(from_h, inl_h)
    ok_f, best_f = family_pick(~from_h, inl_f)

    # Reference picks one family by RH and gives up if it fails; since both
    # families' motions are already verified here, fall back to the other
    # family when the preferred one fails its cheirality/parallax gates.
    use_h = (prefer_h & ok_h) | (~prefer_h & ~ok_f & ok_h)
    success = ok_h | ok_f
    best = jnp.where(use_h, best_h, best_f)

    return TwoViewResult(
        success=success,
        R=Rs[best],
        t=ts[best],
        points=X[best],
        good=good[best],
        used_homography=use_h,
    )
