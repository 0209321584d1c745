"""End-to-end ORB feature extraction program (jittable per image shape).

Orchestrates pyramid -> FAST -> selection -> orientation -> descriptors,
mirroring ORBextractor::operator() (reference: src/ORBextractor.cc:1557-1686)
with batched device stages. The Python loop over the 8 pyramid levels is unrolled
at trace time (static level shapes), so the whole extractor compiles to one
XLA program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import brief, fast, pyramid, select
from .types import Features

DEFAULT_N_FEATURES = 1024


@functools.partial(
    jax.jit,
    static_argnames=("n_features", "n_levels", "scale", "ini_th", "min_th"),
)
def extract(
    img: jnp.ndarray,
    n_features: int = DEFAULT_N_FEATURES,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
) -> Features:
    """img: (H, W) grayscale in [0, 255] (any real dtype; cast to float32).
    Returns padded Features with exactly n_features slots (valid mask marks
    real keypoints)."""
    if img.ndim != 2:
        raise ValueError(
            f"extract() wants a (H, W) grayscale image, got shape {img.shape}; "
            "convert RGB with e.g. img.mean(-1) before calling"
        )
    if min(img.shape) < 31 * 2:
        raise ValueError(
            f"extract() needs images of at least 62px per side (patch 31 + "
            f"borders); got {img.shape}"
        )
    img = img.astype(jnp.float32)
    levels = pyramid.build_pyramid(img, n_levels, scale)
    quotas = select.level_quotas(n_features, n_levels, scale)
    sfac = [scale ** i for i in range(n_levels)]
    # Drop pyramid levels too small for the 31px descriptor patch (small input
    # images); their quota rolls down to the last usable level.
    usable = [lv for lv in range(n_levels) if min(levels[lv].shape) >= 35]
    if len(usable) < n_levels:
        dropped = sum(quotas[lv] for lv in range(n_levels) if lv not in usable)
        quotas = [q if lv in usable else 0 for lv, q in enumerate(quotas)]
        quotas[usable[-1]] += dropped
        n_levels = len(usable)

    xs, ys, lvls, angs, resps, vals, descs = [], [], [], [], [], [], []
    for lv in range(n_levels):
        im = levels[lv]
        resp = fast.dual_threshold_response(im, ini_th, min_th)
        xy, r, v = select.select_keypoints(resp, quotas[lv])
        ang = brief.ic_angles(im, xy)
        blurred = pyramid.gaussian_blur(im)
        d = brief.descriptors(blurred, xy, ang)
        xs.append(xy[:, 0].astype(jnp.float32) * sfac[lv])
        ys.append(xy[:, 1].astype(jnp.float32) * sfac[lv])
        lvls.append(jnp.full((quotas[lv],), lv, jnp.int32))
        angs.append(ang)
        resps.append(jnp.where(v, r, -jnp.inf))
        vals.append(v)
        descs.append(d)

    n = sum(quotas)
    feats = Features(
        xy=jnp.stack([jnp.concatenate(xs), jnp.concatenate(ys)], axis=-1),
        level=jnp.concatenate(lvls),
        angle=jnp.concatenate(angs),
        response=jnp.concatenate(resps),
        desc=jnp.concatenate(descs),
        valid=jnp.concatenate(vals),
        u_right=jnp.full((n,), -1.0, jnp.float32),
        depth=jnp.full((n,), -1.0, jnp.float32),
    )
    if n != n_features:
        # pad/trim to the requested static capacity
        def fix(a):
            if a.shape[0] >= n_features:
                return a[:n_features]
            pad = [(0, n_features - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, pad)

        feats = jax.tree.map(fix, feats)
    return feats
