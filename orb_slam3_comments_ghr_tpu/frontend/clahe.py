"""Contrast-limited adaptive histogram equalization (CLAHE) on device.

The reference's ROS drivers equalize every frame with
cv::createCLAHE(clipLimit=3.0, tileGrid=8x8) before handing it to the SLAM
system (ros_stereo_inertial.cc:68-69,102-120) — it materially improves FAST
repeatability in dark / high-dynamic-range sequences (EuRoC V2, TUM-VI
corridors). This is the same algorithm as ONE jitted XLA program: per-tile
histogram -> clip + redistribute -> CDF LUT -> per-pixel bilinear blend of
the 4 neighboring tile LUTs. All steps are gathers and segment sums.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("tiles", "clip_limit", "n_bins"))
def clahe(img: jnp.ndarray, tiles: int = 8, clip_limit: float = 3.0,
          n_bins: int = 256) -> jnp.ndarray:
    """img: (H, W) float32 in [0, 255]. Returns equalized float32 (H, W)."""
    h, w = img.shape
    th = -(-h // tiles)
    tw = -(-w // tiles)
    ph, pw = th * tiles - h, tw * tiles - w
    padded = jnp.pad(img, ((0, ph), (0, pw)), mode="edge")

    bins = jnp.clip(padded.astype(jnp.int32), 0, n_bins - 1)
    ty = jnp.arange(th * tiles)[:, None] // th
    tx = jnp.arange(tw * tiles)[None, :] // tw
    tile_id = ty * tiles + tx                       # (H', W')
    flat_idx = tile_id * n_bins + bins
    hist = jnp.zeros((tiles * tiles * n_bins,), jnp.float32).at[
        flat_idx.reshape(-1)
    ].add(1.0).reshape(tiles * tiles, n_bins)

    # clip + redistribute (OpenCV semantics: limit = clipLimit * area / bins)
    area = float(th * tw)
    limit = jnp.maximum(clip_limit * area / n_bins, 1.0)
    excess = jnp.sum(jnp.maximum(hist - limit, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, limit) + excess / n_bins

    cdf = jnp.cumsum(hist, axis=1)
    lut = (cdf * ((n_bins - 1) / area)).reshape(tiles, tiles, n_bins)

    # bilinear blend of the 4 neighboring tile LUTs, evaluated at each
    # pixel's own bin (interpolation between tile mappings, not pixels)
    yy = (jnp.arange(h, dtype=jnp.float32) + 0.5) / th - 0.5
    xx = (jnp.arange(w, dtype=jnp.float32) + 0.5) / tw - 0.5
    y0 = jnp.clip(jnp.floor(yy), 0, tiles - 1).astype(jnp.int32)
    x0 = jnp.clip(jnp.floor(xx), 0, tiles - 1).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, tiles - 1)
    x1 = jnp.minimum(x0 + 1, tiles - 1)
    fy = jnp.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = jnp.clip(xx - x0, 0.0, 1.0)[None, :]

    b = bins[:h, :w]
    lut_flat = lut.reshape(-1)

    def at(tyi, txi):
        idx = (tyi[:, None] * tiles + txi[None, :]) * n_bins + b
        return lut_flat[idx]

    v00 = at(y0, x0)
    v01 = at(y0, x1)
    v10 = at(y1, x0)
    v11 = at(y1, x1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy
