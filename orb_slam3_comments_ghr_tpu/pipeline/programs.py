"""Jitted device programs composing the per-frame and per-keyframe pipelines.

These are the device-program equivalents of the reference's hot call paths —
each is ONE XLA program (SURVEY.md §7.1 'three pipelined device programs'):

  track_against_points  : SearchLocalPoints + SearchByProjection +
                          PoseOptimization fused (Tracking.cc:3571 TrackLocalMap
                          / :3444 TrackWithMotionModel)
  epipolar_match        : SearchForTriangulation (ORBmatcher.cc:1045)
  triangulate_matches   : CreateNewMapPoints geometry checks
                          (LocalMapping.cc:526-938)
  fuse_project          : ORBmatcher::Fuse (ORBmatcher.cc:1330)

Shapes are static per (L points, N features) bucket; the host state machine
reads back only small scalars/indices.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie, cameras, matching, triangulate
from ..optim import pose_opt, robust
from ..utils.precision import f32_matmuls


class LocalPoints(NamedTuple):
    """Compact device view of candidate map points (padded to L)."""

    pos: jnp.ndarray       # (L,3)
    desc: jnp.ndarray      # (L,8) uint32
    normal: jnp.ndarray    # (L,3)
    min_dist: jnp.ndarray  # (L,)
    max_dist: jnp.ndarray  # (L,)
    valid: jnp.ndarray     # (L,)
    angle: jnp.ndarray     # (L,) keypoint angle of the distinctive
    #                        descriptor's observation (rotation histogram)


class TrackResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    match_feat: jnp.ndarray   # (L,) feature index per point, -1 if unmatched
    inlier: jnp.ndarray       # (L,) bool — matched AND pose-opt inlier
    visible: jnp.ndarray      # (L,) bool — passed frustum gate
    n_inliers: jnp.ndarray


def _frustum_gate(cam, R, t, pts: LocalPoints, n_levels: int, scale: float):
    """isInFrustum (Frame.cc:676): image bounds, distance band, viewing angle;
    returns (visible mask, predicted uv, predicted level, search radius)."""
    pc = lie.se3_apply(R, t, pts.pos)
    z = pc[..., 2]
    uv = cameras.project(cam, pc)
    center = -jnp.einsum("ji,j->i", R, t)
    d = pts.pos - center
    dist = jnp.linalg.norm(d, axis=-1)
    in_band = (dist > 0.8 * pts.min_dist) & (dist < 1.2 * pts.max_dist)
    view_cos = jnp.sum(d * pts.normal, axis=-1) / jnp.maximum(dist, 1e-9)
    visible = (
        pts.valid
        & (z > 0.1)
        & cameras.in_image(cam, uv)
        & in_band
        & (view_cos > 0.5)
    )
    # predicted octave from distance (MapPoint::PredictScale)
    ratio = pts.max_dist / jnp.maximum(dist, 1e-9)
    level = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / jnp.log(scale))
    level = jnp.clip(level, 0, n_levels - 1).astype(jnp.int32)
    # RadiusByViewingCos (ORBmatcher.cc:245)
    radius = jnp.where(view_cos > 0.998, 2.5, 4.0) * (scale ** level.astype(jnp.float32))
    return visible, uv, level, radius


@functools.partial(
    jax.jit,
    static_argnames=("cam", "n_levels", "scale", "th", "iters_per_round"),
)
def track_against_points(
    cam: cameras.Camera,
    feats,                      # frontend.Features
    pts: LocalPoints,
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    th: float = 1.0,            # radius multiplier (ref th arg of SBP)
    n_levels: int = 8,
    scale: float = 1.2,
    iters_per_round: int = 10,
) -> TrackResult:
    visible, uv_pred, level_pred, radius = _frustum_gate(
        cam, R0, t0, pts, n_levels, scale
    )
    mask = matching.window_mask(
        uv_pred,
        level_pred,
        feats.xy,
        feats.level,
        feats.valid,
        radius * th,
        level_lo=level_pred - 1,
        level_hi=level_pred + 1,
    )
    mask = mask & visible[:, None]
    idx, dist, ok = matching.search_by_window(
        pts.desc, feats.desc, mask, th=matching.TH_HIGH, ratio=0.8
    )
    ok = matching.resolve_duplicates(idx, dist, ok, feats.xy.shape[0])
    # rotation-histogram consistency between each point's reference-KF
    # keypoint angle and its matched frame keypoint (the local-map analog of
    # the last-frame orientation check, ORBmatcher.cc:2077-2168): local
    # points come overwhelmingly from nearby keyframes, so a dominant
    # relative in-plane rotation exists and false matches scatter outside
    # the top histogram bins
    ok = matching.rotation_consistency(pts.angle, feats.angle, idx, ok)

    obs = pose_opt.PoseObs(
        p_world=pts.pos,
        uv=feats.xy[idx],
        u_right=feats.u_right[idx],
        level=feats.level[idx],
        valid=ok,
    )
    R, t, inlier, n = pose_opt.optimize_pose(
        cam, R0, t0, obs, iters_per_round=iters_per_round
    )
    match_feat = jnp.where(ok, idx, -1)
    return TrackResult(
        R=R, t=t, match_feat=match_feat, inlier=inlier & ok, visible=visible,
        n_inliers=n,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "extract_cam", "geom_cam", "n_features", "n_levels", "scale",
        "ini_th", "min_th", "th", "undistort",
    ),
)
def extract_and_track(
    extract_cam: cameras.Camera,
    geom_cam: cameras.Camera,
    img: jnp.ndarray,
    pts: LocalPoints,
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    n_features: int = 1024,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    th: float = 1.0,
    undistort: bool = False,
):
    """THE per-frame fast path: ORB extraction + (optional fisheye
    undistortion) + frustum-gated projection matching + pose LM, fused into
    ONE device program — one dispatch and one host sync per tracked frame
    instead of two-plus. Returns (Features, TrackResult)."""
    from ..frontend.batched import extract_batched

    feats = extract_batched(
        img, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th,
    )
    if undistort:
        feats = feats._replace(xy=cameras.undistort_points(extract_cam, feats.xy))
    res = track_against_points(
        geom_cam, feats, pts, R0, t0, th=th, n_levels=n_levels, scale=scale,
    )
    return feats, res


@functools.partial(
    jax.jit,
    static_argnames=(
        "extract_cam", "n_features", "n_levels", "scale", "ini_th", "min_th",
        "undistort",
    ),
)
def extract_only(
    extract_cam: cameras.Camera,
    img: jnp.ndarray,
    n_features: int = 1024,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    undistort: bool = False,
):
    """Extraction half of the per-frame program, dispatched on its own for the
    CROSS-FRAME pipeline: frame N+1's pyramid/FAST/BRIEF runs on device while
    the host does frame N's map bookkeeping (the reference overlaps these via
    its Tracking/LocalMapping threads; here the overlap is device-vs-host
    within the tracking loop)."""
    from ..frontend.batched import extract_batched

    feats = extract_batched(
        img, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th,
    )
    if undistort:
        feats = feats._replace(xy=cameras.undistort_points(extract_cam, feats.xy))
    return feats


track_only = jax.jit(
    track_against_points,
    static_argnames=("cam", "th", "n_levels", "scale", "iters_per_round"),
)


@functools.partial(
    jax.jit,
    static_argnames=(
        "extract_cam", "n_features", "n_levels", "scale", "ini_th", "min_th",
        "undistort",
    ),
)
def extract_stereo_only(
    extract_cam: cameras.Camera,
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    n_features: int = 1024,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    undistort: bool = False,
):
    """Stereo extraction half for the CROSS-FRAME pipeline: both extractions
    + row-constrained stereo matching in one dispatch, the projection-track
    chained separately (see track_stereo_pipelined). The reference's
    stereo front end runs the two ORBextractor passes on two threads
    (Frame.cc stereo ctor, threadLeft/threadRight); here they are one
    batched device program."""
    from ..frontend.batched import extract_batched
    from ..frontend import stereo as stereo_mod

    fl = extract_batched(
        img_l, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th,
    )
    fr = extract_batched(
        img_r, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th,
    )
    u_right, depth = stereo_mod.stereo_match(
        extract_cam, fl, fr, img_l.astype(jnp.float32),
        img_r.astype(jnp.float32), scale=scale,
    )
    fl = fl._replace(u_right=u_right, depth=depth)
    if undistort:
        fl = fl._replace(xy=cameras.undistort_points(extract_cam, fl.xy))
    return fl


@functools.partial(jax.jit, static_argnames=("min_matches",))
@f32_matmuls
def chain_seed(prev_R, prev_t, prev_n, vR, vt, R0, t0, min_matches: int):
    """Pose seed for the deep pipeline: advance the PREVIOUS frame's
    device-resident track result one velocity step, falling back to the host
    prediction when that frame tracked thin. One dispatch, where eager jnp
    ops would cost ~6 separate dispatches per frame."""
    Rc = vR @ prev_R
    tc = vR @ prev_t + vt
    good = prev_n >= min_matches
    return jnp.where(good, Rc, R0), jnp.where(good, tc, t0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "extract_cam", "geom_cam", "n_features", "n_levels", "scale",
        "ini_th", "min_th", "th", "undistort",
    ),
)
def extract_and_track_stereo(
    extract_cam: cameras.Camera,
    geom_cam: cameras.Camera,
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    pts: LocalPoints,
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    n_features: int = 1024,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    th: float = 1.0,
    undistort: bool = False,
):
    """Stereo per-frame fast path: both extractions + row-constrained stereo
    matching + projection matching + pose LM in ONE device program."""
    from ..frontend.batched import extract_batched
    from ..frontend import stereo as stereo_mod

    fl = extract_batched(
        img_l, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th,
    )
    fr = extract_batched(
        img_r, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th,
    )
    u_right, depth = stereo_mod.stereo_match(
        extract_cam, fl, fr, img_l.astype(jnp.float32), img_r.astype(jnp.float32),
        scale=scale,
    )
    fl = fl._replace(u_right=u_right, depth=depth)
    if undistort:
        fl = fl._replace(xy=cameras.undistort_points(extract_cam, fl.xy))
    res = track_against_points(
        geom_cam, fl, pts, R0, t0, th=th, n_levels=n_levels, scale=scale,
    )
    return fl, res


def _epipolar_match_impl(
    cam: cameras.Camera,
    desc1, xy1, level1, free1,
    desc2, xy2, level2, free2,
    R12, t12,
):
    """SearchForTriangulation: match unassociated features across two KFs with
    an epipolar constraint (ORBmatcher.cc:1045). The reference walks shared
    BoW nodes to limit candidates; here the dense mask is the epipolar band —
    the same acceptance region, evaluated in one kernel."""
    # Fundamental from relative pose: F = K^-T [t]x R K^-1 (GeometricTools
    # ComputeF12). Lines for features of image 1 evaluated at image 2.
    K = cam.K
    Kinv = jnp.linalg.inv(K)
    E = lie.hat(t12) @ R12
    F = Kinv.T @ E @ Kinv  # x1^T F x2 = 0
    oh1 = jnp.concatenate([xy1, jnp.ones_like(xy1[:, :1])], -1)
    oh2 = jnp.concatenate([xy2, jnp.ones_like(xy2[:, :1])], -1)
    lines2 = oh1 @ F          # (N1,3): line in image 2 for each feat of 1
    num = jnp.einsum("mi,ni->mn", lines2, oh2)
    den = jnp.maximum(lines2[:, 0:1] ** 2 + lines2[:, 1:2] ** 2, 1e-12)
    d2 = num * num / den      # squared point-line distance, (N1,N2)
    sigma2 = (1.2 ** level2.astype(jnp.float32)) ** 2
    epi_ok = d2 < 3.84 * sigma2[None, :]
    mask = epi_ok & free1[:, None] & free2[None, :]
    idx, dist, ok = matching.search_by_window(
        desc1, desc2, mask, th=matching.TH_LOW, ratio=0.6
    )
    ok = matching.resolve_duplicates(idx, dist, ok, desc2.shape[0])
    return idx, ok


epipolar_match = functools.partial(jax.jit, static_argnames=("cam",))(
    _epipolar_match_impl
)


@functools.partial(jax.jit, static_argnames=("cam1", "cam2", "n_pairs"))
@f32_matmuls
def fisheye_stereo_depth(
    cam1: cameras.Camera,          # left virtual pinhole (undistorted coords)
    cam2: cameras.Camera,          # right virtual pinhole
    xy1, level1, desc1, valid1,    # undistorted left features
    xy2, level2, desc2, valid2,    # undistorted right features
    R12, t12,                      # right->left extrinsics: x_l = R12 x_r + t12
    n_pairs: int = 0,
):
    """KannalaBrandt8::matchAndtriangulate equivalent for non-rectified
    stereo (KannalaBrandt8.cpp:438): epipolar-constrained descriptor matching
    across the two (already undistorted) views + DLT triangulation; returns
    (depth, right_idx, matched) per left feature — depth -1 where
    unmatched/rejected, right_idx the matched right-feature index, matched
    the validity mask.

    The rectified-stereo u_right parameterization does not apply; depths
    seed map points like RGB-D, and the matched right-view pixels become
    second-camera observations constrained in BA via BAProblem.obs_rig
    (the reference's EdgeSE3ProjectXYZToBody, OptimizableTypes.h:96-160)."""
    K1 = cam1.K
    K2 = cam2.K
    E = lie.hat(t12) @ R12
    F = jnp.linalg.inv(K1).T @ E @ jnp.linalg.inv(K2)  # x1^T F x2 = 0
    oh1 = jnp.concatenate([xy1, jnp.ones_like(xy1[:, :1])], -1)
    oh2 = jnp.concatenate([xy2, jnp.ones_like(xy2[:, :1])], -1)
    lines2 = oh1 @ F
    num = jnp.einsum("mi,ni->mn", lines2, oh2)
    den = jnp.maximum(lines2[:, 0:1] ** 2 + lines2[:, 1:2] ** 2, 1e-12)
    d2 = num * num / den
    sigma2 = (1.2 ** level2.astype(jnp.float32)) ** 2
    mask = (d2 < 3.84 * sigma2[None, :]) & valid1[:, None] & valid2[None, :]
    idx, dist, ok = matching.search_by_window(
        desc1, desc2, mask, th=matching.TH_LOW, ratio=0.7
    )
    ok = matching.resolve_duplicates(idx, dist, ok, xy2.shape[0])

    # triangulate in the LEFT camera frame: P1 = K1 [I|0]; right camera pose
    # (left->right): R21 = R12^T, t21 = -R12^T t12
    R21 = R12.T
    t21 = -R21 @ t12
    P1 = triangulate.projection_matrix(K1, jnp.eye(3), jnp.zeros(3))
    P2 = triangulate.projection_matrix(K2, R21, t21)
    X = triangulate.triangulate(P1, P2, xy1, xy2[idx])
    z1 = X[..., 2]
    Xr = X @ R21.T + t21
    good = (
        ok & (z1 > 0.05) & (Xr[..., 2] > 0.05)
        & jnp.all(jnp.isfinite(X), axis=-1)
    )
    # reprojection gate in both views (chi2 5.991 per view)
    uv1_hat = cameras.project(cam1, X)
    uv2_hat = cameras.project(cam2, Xr)
    e1 = jnp.sum((uv1_hat - xy1) ** 2, -1)
    e2 = jnp.sum((uv2_hat - xy2[idx]) ** 2, -1)
    good = good & (e1 < 5.991) & (e2 < 5.991 * sigma2[idx])
    return jnp.where(good, z1, -1.0), idx, good


@functools.partial(jax.jit, static_argnames=("cam", "scale"))
@f32_matmuls
def map_new_points_multi(
    cam: cameras.Camera,
    desc1, xy1, level1, ur1, free1,          # current KF features
    R1, t1,
    desc2s, xy2s, level2s, ur2s, free2s,     # (B, ...) stacked neighbors
    R2s, t2s,
    scale: float = 1.2,
):
    """CreateNewMapPoints over ALL covisible neighbors in ONE program:
    vmapped epipolar matching + triangulation + acceptance gates per
    neighbor (the host loop of LocalMapping.cc:526 becomes a batch axis).
    Returns (idx (B,N), X (B,N,3), good (B,N))."""

    def per_neighbor(desc2, xy2, level2, ur2, free2, R2, t2):
        R12 = R1 @ R2.T
        t12 = t1 - R12 @ t2
        idx, ok = _epipolar_match_impl(
            cam, desc1, xy1, level1, free1, desc2, xy2, level2, free2, R12, t12
        )
        X, good = _triangulate_matches_impl(
            cam, R1, t1, R2, t2,
            xy1, xy2[idx], level1, level2[idx], ok, ur1, ur2[idx], scale,
        )
        return idx, X, good

    return jax.vmap(per_neighbor)(desc2s, xy2s, level2s, ur2s, free2s, R2s, t2s)


def _triangulate_matches_impl(
    cam: cameras.Camera,
    R1, t1, R2, t2,                     # world->cam poses
    uv1, uv2, level1, level2, ok,       # matched pixel pairs
    ur1, ur2,                           # stereo right-u (<0 if mono)
    scale: float = 1.2,
):
    """Triangulate candidate pairs and run CreateNewMapPoints' acceptance
    gates (LocalMapping.cc:640-930): parallax, cheirality, per-view chi2
    (5.991 mono / 7.815 stereo), scale-consistency. Returns (points world,
    good mask)."""
    P1 = triangulate.projection_matrix(cam.K, R1, t1)
    P2 = triangulate.projection_matrix(cam.K, R2, t2)
    X = triangulate.triangulate(P1, P2, uv1, uv2)

    def checks(Rk, tk, uvk, urk, lvlk):
        pc = lie.se3_apply(Rk, tk, X)
        z = pc[..., 2]
        uv_hat = cameras.project(cam, pc)
        sigma2 = scale ** (2.0 * lvlk.astype(jnp.float32))
        e2 = jnp.sum((uvk - uv_hat) ** 2, axis=-1)
        is_stereo = urk >= 0
        ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], jnp.maximum(z, 1e-6))
        e2s = e2 + jnp.where(is_stereo, (urk - ur_hat) ** 2, 0.0)
        th = jnp.where(is_stereo, 7.8, 5.991) * sigma2
        return (z > 0) & (e2s < th), z

    ok1, z1 = checks(R1, t1, uv1, ur1, level1)
    ok2, z2 = checks(R2, t2, uv2, ur2, level2)

    # parallax between rays
    c1 = -jnp.einsum("ji,j->i", R1, t1)
    c2 = -jnp.einsum("ji,j->i", R2, t2)
    r1v = X - c1
    r2v = X - c2
    cosp = jnp.sum(r1v * r2v, -1) / jnp.maximum(
        jnp.linalg.norm(r1v, axis=-1) * jnp.linalg.norm(r2v, axis=-1), 1e-12
    )
    # scale consistency (ratioDist vs ratioFactor = 1.5*scale)
    d1 = jnp.linalg.norm(r1v, axis=-1)
    d2n = jnp.linalg.norm(r2v, axis=-1)
    ratio_dist = d2n / jnp.maximum(d1, 1e-9)
    ratio_octave = scale ** (level1.astype(jnp.float32) - level2.astype(jnp.float32))
    rf = 1.5 * scale
    scale_ok = (ratio_dist * rf > ratio_octave) & (ratio_dist < ratio_octave * rf)

    good = (
        ok
        & ok1
        & ok2
        & (cosp < 0.9998)
        & scale_ok
        & jnp.all(jnp.isfinite(X), axis=-1)
    )
    return X, good


triangulate_matches = functools.partial(
    jax.jit, static_argnames=("cam", "scale")
)(_triangulate_matches_impl)


def _fuse_project_impl(
    cam: cameras.Camera,
    R, t,
    pts: LocalPoints,
    feat_xy, feat_level, feat_desc, feat_valid, feat_mp,
    n_levels: int = 8,
    scale: float = 1.2,
):
    """ORBmatcher::Fuse (ORBmatcher.cc:1330): project points into a KF, find
    the best feature within radius 3*scale^level; if that feature already has
    a point, report a (point, existing) duplicate; else an (point, feat)
    association. Decisions returned to the host which owns Replace()."""
    visible, uv_pred, level_pred, _ = _frustum_gate(cam, R, t, pts, n_levels, scale)
    radius = 3.0 * (scale ** level_pred.astype(jnp.float32))
    mask = matching.window_mask(
        uv_pred, level_pred, feat_xy, feat_level, feat_valid, radius,
        level_lo=level_pred - 1, level_hi=level_pred + 1,
    )
    mask = mask & visible[:, None]
    idx, dist, ok = matching.search_by_window(
        pts.desc, feat_desc, mask, th=matching.TH_LOW, ratio=1.0
    )
    ok = matching.resolve_duplicates(idx, dist, ok, feat_xy.shape[0])
    existing = feat_mp[idx]       # (L,) map point already on that feature
    return idx, ok, existing


fuse_project = functools.partial(
    jax.jit, static_argnames=("cam", "n_levels", "scale")
)(_fuse_project_impl)


@functools.partial(jax.jit, static_argnames=("cam", "n_levels", "scale"))
def fuse_project_multi(
    cam: cameras.Camera,
    Rs, ts,                                   # (B,3,3), (B,3)
    pts: LocalPoints,
    feat_xys, feat_levels, feat_descs, feat_valids, feat_mps,  # (B, ...)
    n_levels: int = 8,
    scale: float = 1.2,
):
    """SearchInNeighbors' per-neighbor Fuse over ALL neighbors in one
    program (batch axis over keyframes)."""

    def per_kf(R, t, fxy, flvl, fdesc, fval, fmp):
        return _fuse_project_impl(
            cam, R, t, pts, fxy, flvl, fdesc, fval, fmp, n_levels, scale
        )

    return jax.vmap(per_kf)(Rs, ts, feat_xys, feat_levels, feat_descs,
                            feat_valids, feat_mps)
