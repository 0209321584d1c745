"""Rectified stereo feature matching.

JAX replacement for Frame::ComputeStereoMatches (reference:
src/Frame.cc:1117-1370): the reference builds per-row candidate lists, does a
coarse Hamming match within a +-2*scale row band, then an 11x11 SAD sub-pixel
refinement. Here the row-band + disparity-range constraint is a dense mask
over the (left, right) feature pair matrix and the coarse match is one masked
Hamming argmin; sub-pixel comes from a parabola fit over SAD on blurred
level-0 patches (same W=5 window semantics), all batched.

Acceptance mirrors the reference: best distance < (TH_HIGH+TH_LOW)/2 = 75
(Frame.cc:1138), disparity in [0, bf/b_min], final median-deviation outlier
pass (dist > 1.5*1.4*median culled, Frame.cc:1340-1365).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import matching, cameras
from .types import Features

TH_STEREO = (matching.TH_HIGH + matching.TH_LOW) // 2  # 75


@functools.partial(jax.jit, static_argnames=("cam", "scale"))
def stereo_match(
    cam: cameras.Camera,
    feats_l: Features,
    feats_r: Features,
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    scale: float = 1.2,
):
    """Returns (u_right (N,), depth (N,)) for the left features (-1 where
    unmatched). img_l/img_r are the level-0 grayscale images for SAD refine."""
    min_z = cam.baseline
    min_d = 0.0
    max_d = cam.bf / max(min_z, 1e-6)

    # row band: |vR - vL| <= 2 * scale^octave(L)
    band = 2.0 * scale ** feats_l.level.astype(jnp.float32)
    dv = jnp.abs(feats_l.xy[:, 1:2] - feats_r.xy[None, :, 1])
    disp = feats_l.xy[:, 0:1] - feats_r.xy[None, :, 0]
    level_ok = (
        jnp.abs(feats_l.level[:, None] - feats_r.level[None, :]) <= 1
    )
    mask = (
        (dv <= band[:, None])
        & (disp >= min_d - 2.0)
        & (disp <= max_d)
        & feats_l.valid[:, None]
        & feats_r.valid[None, :]
        & level_ok
    )
    idx, dist, ok = matching.search_by_window(
        feats_l.desc, feats_r.desc, mask, th=TH_STEREO, ratio=1.0
    )

    # SAD sub-pixel refinement on 11x11 patches, +-5 px sweep (W=5, L=5)
    W = 5
    xl = feats_l.xy[:, 0]
    yl = feats_l.xy[:, 1]
    xr0 = feats_r.xy[idx, 0]

    def patch(img, xc, yc):
        x0 = jnp.clip(xc.astype(jnp.int32) - W, 0, img.shape[1] - (2 * W + 1))
        y0 = jnp.clip(yc.astype(jnp.int32) - W, 0, img.shape[0] - (2 * W + 1))
        return jax.vmap(
            lambda yy, xx: jax.lax.dynamic_slice(img, (yy, xx), (2 * W + 1, 2 * W + 1))
        )(y0, x0)

    pl = patch(img_l, xl, yl)                     # (N,11,11)
    offsets = jnp.arange(-5, 6)

    def sad_at(off):
        pr = patch(img_r, xr0 + off.astype(jnp.float32), yl)
        return jnp.sum(jnp.abs(pl - pr), axis=(-2, -1))

    sads = jax.vmap(sad_at)(offsets)              # (11,N)
    best_off = jnp.argmin(sads, axis=0)           # (N,)
    n = xl.shape[0]
    c0 = sads[jnp.clip(best_off - 1, 0, 10), jnp.arange(n)]
    c1 = sads[best_off, jnp.arange(n)]
    c2 = sads[jnp.clip(best_off + 1, 0, 10), jnp.arange(n)]
    denom = jnp.maximum(c0 + c2 - 2 * c1, 1e-6)
    delta = jnp.clip(0.5 * (c0 - c2) / denom, -1.0, 1.0)
    interior = (best_off > 0) & (best_off < 10)
    delta = jnp.where(interior, delta, 0.0)
    u_r = xr0 + (best_off - 5).astype(jnp.float32) + delta

    disparity = xl - u_r
    ok = ok & (disparity > min_d) & (disparity < max_d)

    # median-deviation outlier pass on the accepted Hamming distances
    dist_ok = jnp.where(ok, dist, 10**6)
    med = jnp.median(jnp.where(ok, dist.astype(jnp.float32), jnp.nan))
    med = jnp.nan_to_num(med, nan=float(TH_STEREO))
    ok = ok & (dist.astype(jnp.float32) <= 1.5 * 1.4 * med)

    depth = cam.bf / jnp.maximum(disparity, 1e-6)
    u_right = jnp.where(ok, u_r, -1.0)
    depth = jnp.where(ok, depth, -1.0)
    return u_right, depth


def depth_to_stereo(cam: cameras.Camera, feats: Features, depth_map: jnp.ndarray):
    """RGB-D: virtual right coordinates from a depth image
    (Frame::ComputeStereoFromRGBD, Frame.cc:1376)."""
    xy = feats.xy.astype(jnp.int32)
    x = jnp.clip(xy[:, 0], 0, depth_map.shape[1] - 1)
    y = jnp.clip(xy[:, 1], 0, depth_map.shape[0] - 1)
    d = depth_map[y, x]
    ok = feats.valid & (d > 0)
    u_right = jnp.where(ok, feats.xy[:, 0] - cam.bf / jnp.maximum(d, 1e-6), -1.0)
    depth = jnp.where(ok, d, -1.0)
    return u_right, depth
