"""Keypoint orientation (intensity centroid) + rotation-steered 256-bit binary
descriptors.

Replaces IC_Angle + computeOrbDescriptor (reference: src/ORBextractor.cc:89,
148, and the learned bit_pattern_31_ table at :212). The sampling pattern here
is NOT copied from the reference: it is regenerated from the original BRIEF
recipe — 256 point pairs drawn i.i.d. from an isotropic Gaussian with
sigma = patch/5, clipped to the 31x31 patch — with a fixed seed. Descriptors
are therefore self-consistent across the whole framework (matching, BoW
vocabulary, place recognition) without reproducing the reference's constants.

Descriptors are bit-packed uint32[8] so Hamming distances reduce to
XOR + population_count.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

PATCH_SIZE = 31
HALF_PATCH = 15
N_BITS = 256


def _make_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) int32: (x1, y1, x2, y2) sample offsets, Gaussian sigma=patch/5."""
    rng = np.random.RandomState(seed)
    sigma = PATCH_SIZE / 5.0
    pts = rng.randn(N_BITS, 4) * sigma
    pts = np.clip(np.round(pts), -HALF_PATCH + 2, HALF_PATCH - 2)
    return pts.astype(np.int32)


PATTERN = jnp.asarray(_make_pattern())  # (256, 4)

# Circular patch mask offsets for the intensity centroid (radius 15, matching
# the umax table construction in ORBextractor.cc ctor).
def _centroid_offsets():
    dy, dx = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
    mask = (dx * dx + dy * dy) <= HALF_PATCH * HALF_PATCH
    return (
        jnp.asarray(dx, jnp.float32),
        jnp.asarray(dy, jnp.float32),
        jnp.asarray(mask, jnp.float32),
    )


_CDX, _CDY, _CMASK = _centroid_offsets()


def ic_angles(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation (IC_Angle, ORBextractor.cc:89).

    img: (H, W) level image; xy: (N, 2) int32 level coords (inside border).
    Returns (N,) angle radians."""

    def one(pt):
        x0 = jnp.clip(pt[0] - HALF_PATCH, 0, img.shape[1] - PATCH_SIZE)
        y0 = jnp.clip(pt[1] - HALF_PATCH, 0, img.shape[0] - PATCH_SIZE)
        patch = jax.lax.dynamic_slice(img, (y0, x0), (PATCH_SIZE, PATCH_SIZE))
        m10 = jnp.sum(_CDX * _CMASK * patch)
        m01 = jnp.sum(_CDY * _CMASK * patch)
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(xy)


def _gather_pixels(img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray) -> jnp.ndarray:
    h, w = img.shape
    ys = jnp.clip(ys, 0, h - 1)
    xs = jnp.clip(xs, 0, w - 1)
    return img.reshape(-1)[ys * w + xs]


def descriptors(img_blur: jnp.ndarray, xy: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Steered binary descriptors.

    img_blur: (H, W) Gaussian-blurred level image; xy: (N, 2) int32 level
    coords; angle: (N,) radians. Returns (N, 8) uint32 (256 bits)."""
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # (N,)
    px1 = PATTERN[:, 0].astype(jnp.float32)  # (256,)
    py1 = PATTERN[:, 1].astype(jnp.float32)
    px2 = PATTERN[:, 2].astype(jnp.float32)
    py2 = PATTERN[:, 3].astype(jnp.float32)

    def rot(px, py):
        # (N, 256) rotated integer offsets, nearest like cvRound in the ref
        rx = jnp.round(ca[:, None] * px[None] - sa[:, None] * py[None]).astype(jnp.int32)
        ry = jnp.round(sa[:, None] * px[None] + ca[:, None] * py[None]).astype(jnp.int32)
        return rx, ry

    r1x, r1y = rot(px1, py1)
    r2x, r2y = rot(px2, py2)
    x0 = xy[:, 0:1]
    y0 = xy[:, 1:2]
    v1 = _gather_pixels(img_blur, y0 + r1y, x0 + r1x)  # (N, 256)
    v2 = _gather_pixels(img_blur, y0 + r2y, x0 + r2x)
    bits = (v1 < v2).astype(jnp.uint32)  # (N, 256)
    # pack into 8 words of 32 bits
    bits = bits.reshape(-1, 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)
