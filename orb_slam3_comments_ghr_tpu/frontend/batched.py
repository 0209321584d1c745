"""Batched (single-program) ORB extraction over a padded pyramid.

The naive extractor unrolls 8 pyramid levels into 8 copies of every kernel —
XLA compiles ~8x the code and per-keypoint patch gathers dominate runtime.
Here all levels are padded to the level-0 shape and stacked (L, H, W), so:

  * FAST / NMS / blur run once with a leading batch axis;
  * the intensity-centroid orientation becomes two 31x31 convolutions
    (moment maps m10/m01), turning 1024 patch gathers into one conv + one
    1024-element gather — conv work becomes matmuls;
  * descriptors sample all (keypoint, pattern-bit) pairs with a single flat
    gather from the stacked blurred pyramid.

Out-of-bounds padding is masked with per-level validity. Behavior parity with
the per-level extractor (same FAST thresholds, selection, steering) — only
the schedule differs. Reference: src/ORBextractor.cc:1557-1686.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import brief, fast, pyramid, select
from .types import Features


def _padded_pyramid(img, n_levels, scale):
    """(L, H, W) stack, plus static per-level (h, w)."""
    levels = pyramid.build_pyramid(img, n_levels, scale)
    h, w = img.shape
    stack = []
    for lv in levels:
        ph, pw = h - lv.shape[0], w - lv.shape[1]
        stack.append(jnp.pad(lv, ((0, ph), (0, pw))))
    shapes = [lv.shape for lv in levels]
    return jnp.stack(stack), shapes


def _bounds_mask(h, w, shapes, dtype=bool):
    m = np.zeros((len(shapes), h, w), np.bool_)
    for i, (hh, ww) in enumerate(shapes):
        m[i, :hh, :ww] = True
    return jnp.asarray(m)


def _batched_select(resp, quotas, border, bucket=16):
    """Per-level spatially-balanced top-quota selection on (L, H, W) response
    maps; returns flattened (N,) arrays (N = sum(quotas)) of x, y, level,
    response, valid."""
    L, h, w = resp.shape
    row = jnp.arange(h)[None, :, None]
    col = jnp.arange(w)[None, None, :]
    inb = (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    resp = jnp.where(inb, resp, 0.0)

    gh, gw = -(-h // bucket), -(-w // bucket)
    rp = jnp.pad(resp, ((0, 0), (0, gh * bucket - h), (0, gw * bucket - w)))
    tiles = rp.reshape(L, gh, bucket, gw, bucket).transpose(0, 1, 3, 2, 4).reshape(
        L, gh * gw, bucket * bucket
    )
    best_val = tiles.max(-1)               # (L, G)
    best_idx = tiles.argmax(-1)
    ty = jnp.arange(gh * gw) // gw
    tx = jnp.arange(gh * gw) % gw
    y = ty[None] * bucket + best_idx // bucket   # (L, G)
    x = tx[None] * bucket + best_idx % bucket

    # coarse-champion priority (same construction as select.select_keypoints)
    import math

    kmax = max(quotas)
    c = max(1, math.ceil(math.sqrt(gh * gw / max(kmax, 1))))
    ch, cw = -(-gh // c), -(-gw // c)
    vpad = jnp.pad(
        best_val.reshape(L, gh, gw),
        ((0, 0), (0, ch * c - gh), (0, cw * c - gw)),
        constant_values=-jnp.inf,
    ).reshape(L, ch, c, cw, c)
    champ = vpad.max(axis=(2, 4), keepdims=True)
    is_champ_t = (vpad >= champ) & (vpad > 0.0)
    flat = is_champ_t.transpose(0, 1, 3, 2, 4).reshape(L, ch, cw, c * c)
    first = jnp.argmax(flat, axis=-1)
    only_first = jnp.zeros_like(flat)
    li = jnp.arange(L)[:, None, None]
    ci = jnp.arange(ch)[None, :, None]
    cj = jnp.arange(cw)[None, None, :]
    only_first = only_first.at[li, ci, cj, first].set(flat.max(-1))
    is_champ = (
        only_first.reshape(L, ch, cw, c, c)
        .transpose(0, 1, 3, 2, 4)
        .reshape(L, ch * c, cw * c)[:, :gh, :gw]
        .reshape(L, gh * gw)
    )
    OFFSET = 1e12
    priority = best_val + jnp.where(is_champ, OFFSET, 0.0)

    k = min(kmax, gh * gw)
    topp, topi = jax.lax.top_k(priority, k)      # (L, k)
    topv = jnp.take_along_axis(best_val, topi, 1)
    sel_x = jnp.take_along_axis(x, topi, 1)
    sel_y = jnp.take_along_axis(y, topi, 1)
    quota_arr = jnp.asarray(quotas)[:, None]
    valid = (topv > 0.0) & (jnp.arange(k)[None, :] < quota_arr)

    lvl = jnp.broadcast_to(jnp.arange(L)[:, None], (L, k))
    return (
        sel_x.reshape(-1), sel_y.reshape(-1), lvl.reshape(-1),
        topv.reshape(-1), valid.reshape(-1),
    )


def _moment_kernels():
    dy, dx = np.mgrid[-brief.HALF_PATCH : brief.HALF_PATCH + 1,
                      -brief.HALF_PATCH : brief.HALF_PATCH + 1]
    mask = (dx * dx + dy * dy) <= brief.HALF_PATCH * brief.HALF_PATCH
    kx = (dx * mask).astype(np.float32)
    ky = (dy * mask).astype(np.float32)
    # lax.conv_general_dilated computes correlation (no kernel flip), which
    # is exactly the moment sum over (dy, dx) offsets.
    return jnp.asarray(kx), jnp.asarray(ky)


def _ic_angles_at(P, xs, ys, lvls):
    """IC orientation at the selected keypoints only. A full-image 31x31
    moment convolution is single-channel spatial work over every pixel of
    every level; slicing one 31x31 patch per keypoint and reducing with a
    (961, 2) static weight matrix is one small matmul (~1 M MACs). Numerically identical to the conv at every keypoint."""
    kx, ky = _moment_kernels()
    S = 2 * brief.HALF_PATCH + 1
    kmat = jnp.stack([kx.reshape(-1), ky.reshape(-1)], axis=1)  # (961, 2)
    half = brief.HALF_PATCH
    padded = jnp.pad(P, ((0, 0), (half, half), (half, half)))
    L, Hp, Wp = padded.shape
    # slice from the (L*Hp, Wp) flattening with the level folded into the
    # row offset: vmapping `padded[l]` makes XLA emit a per-keypoint gather
    # of the whole level (~3x the cost of the slices themselves)
    flat2d = padded.reshape(L * Hp, Wp)

    def get_patch(l, y, x):
        return jax.lax.dynamic_slice(flat2d, (l * Hp + y, x), (S, S))

    patches = jax.vmap(get_patch)(lvls, ys, xs).reshape(-1, S * S)
    m = patches @ kmat  # (n, 2): [m10, m01]
    return jnp.arctan2(m[:, 1], m[:, 0])


def _blur_band(n: int) -> jnp.ndarray:
    """(n, n) banded matrix applying the 7-tap sigma=2 Gaussian along one
    axis with edge-replicate boundaries (index clipping accumulates the
    out-of-range taps at the border, exactly like 'edge' padding)."""
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    k /= k.sum()
    M = np.zeros((n, n), np.float32)
    i = np.arange(n)
    for o, kv in zip(range(-3, 4), k):
        np.add.at(M, (i, np.clip(i + o, 0, n - 1)), kv)
    return jnp.asarray(M)


def _batched_blur(P):
    # separable Gaussian as two banded dense matmuls (the contraction a
    # single-channel spatial conv performs, in the form matrix units take)
    L, H, W = P.shape
    BR = _blur_band(H)
    BC = _blur_band(W)
    return jnp.einsum(
        "rh,lhw,cw->lrc", BR, P, BC, precision=jax.lax.Precision.DEFAULT
    )


PATCH_SIDE = 48  # covers rotated pattern offsets (|r| <= sqrt(2)*15 + round)
N_ROT_BINS = 30  # 12-degree steering steps — OpenCV ORB discretizes the same


def _rotation_tables() -> np.ndarray:
    """(B, 512) static flat indices into a PATCH_SIDE^2 patch: for each
    rotation bin, the 2x256 rotated pattern sample positions."""
    out = []
    half = PATCH_SIDE // 2
    pat = np.asarray(brief.PATTERN)
    for b in range(N_ROT_BINS):
        a = 2 * np.pi * b / N_ROT_BINS
        ca, sa = np.cos(a), np.sin(a)
        idx = []
        for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
            rx = np.round(ca * px - sa * py).astype(np.int64) + half
            ry = np.round(sa * px + ca * py).astype(np.int64) + half
            idx.append(
                np.clip(ry, 0, PATCH_SIDE - 1) * PATCH_SIDE
                + np.clip(rx, 0, PATCH_SIDE - 1)
            )
        out.append(np.concatenate(idx))
    return np.stack(out)


_ROT_TAB = jnp.asarray(_rotation_tables())  # (B, 512)


def _diff_matrix() -> np.ndarray:
    """(PATCH_SIDE^2, B*256) +-1 matrix: column (b, s) computes the rBRIEF
    pixel difference I[p2] - I[p1] for pattern pair s steered to bin b, so
    bit = (patch @ D > 0). One dense matmul replaces the (n, B*512) patch
    gather and its dynamic addressing."""
    tab = _rotation_tables()
    D = np.zeros((PATCH_SIDE * PATCH_SIDE, N_ROT_BINS * 256), np.float32)
    col = 0
    for b in range(N_ROT_BINS):
        for s in range(256):
            D[tab[b, 256 + s], col] += 1.0
            D[tab[b, s], col] -= 1.0
            col += 1
    return D


_DIFF_MAT = jnp.asarray(_diff_matrix())  # (2304, B*256)
_DIFF_MAT_I8 = jnp.asarray(_diff_matrix().astype(np.int8))


def _batched_descriptors(blurred, xs, ys, lvls, angles, shapes):
    """rBRIEF via rotation-binned STATIC pattern differences: per keypoint
    slice one 48x48 patch (contiguous, cheap), compute all B*256 steered
    pixel differences with ONE dense matmul against a +-1 matrix, threshold,
    then select the keypoint's rotation bin, in place of a flat image
    gather or a per-patch (B*512) gather."""
    L, H, W = blurred.shape
    half = PATCH_SIDE // 2
    n = xs.shape[0]
    padded = jnp.pad(blurred, ((0, 0), (half, half), (half, half)))
    Hp, Wp = padded.shape[1:]
    # level folded into the row offset (see _ic_angles_at): avoids the
    # per-keypoint whole-level gather XLA emits for `padded[l]` under vmap
    flat2d = padded.reshape(L * Hp, Wp)

    def get_patch(l, y, x):
        return jax.lax.dynamic_slice(
            flat2d, (l * Hp + y, x), (PATCH_SIDE, PATCH_SIDE)
        )

    patches = jax.vmap(get_patch)(lvls, ys, xs).reshape(n, PATCH_SIDE * PATCH_SIDE)
    # Quantize the blurred patch to integers (the reference computes rBRIEF
    # on the uint8 GaussianBlur output, ORBextractor.cc:1631) and run the
    # +-1 contraction as TWO int8 matmuls (q = 2*hi + lo with
    # hi = q>>1 <= 127, lo = q&1): int32 accumulation makes the pixel
    # difference EXACT for the rounded image on any backend.
    q = jnp.clip(jnp.round(patches), 0, 255).astype(jnp.int32)
    hi = (q >> 1).astype(jnp.int8)
    lo = (q & 1).astype(jnp.int8)
    dimn = (((1,), (0,)), ((), ()))
    mm = lambda a: jax.lax.dot_general(
        a, _DIFF_MAT_I8, dimn, preferred_element_type=jnp.int32
    )
    diff = 2 * mm(hi) + mm(lo)  # (n, B*256) exact int32
    bits_all = (diff > 0).reshape(n, N_ROT_BINS, 256)
    bidx = (
        jnp.round(angles / (2 * jnp.pi) * N_ROT_BINS).astype(jnp.int32) % N_ROT_BINS
    )
    onehot = jax.nn.one_hot(bidx, N_ROT_BINS, dtype=jnp.float32)
    bits = jnp.einsum("nb,nbs->ns", onehot, bits_all.astype(jnp.float32),
                      precision=jax.lax.Precision.DEFAULT) > 0.5
    bits = bits.astype(jnp.uint32).reshape(-1, 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)


PATCH_IN = PATCH_SIDE + 6  # 48 + two 3-tap blur borders


def _blur_valid() -> jnp.ndarray:
    """(PATCH_SIDE, PATCH_IN) 'valid' 7-tap sigma=2 Gaussian band: row i of
    the blurred 48-patch from rows [i, i+6] of the 54-patch. Interior pixels
    match the whole-image separable blur to float roundoff."""
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    k /= k.sum()
    M = np.zeros((PATCH_SIDE, PATCH_IN), np.float32)
    for i in range(PATCH_SIDE):
        M[i, i : i + 7] = k
    return jnp.asarray(M)


_BLUR_VALID = _blur_valid()


def _per_keypoint_stages(P, xs, ys, lvls, shapes):
    """Orientation + blur + descriptors from ONE 54x54 patch gather per
    keypoint. The previous schedule gathered twice (31x31 for IC moments,
    48x48 from a separately whole-image-blurred stack); slicing a single
    PATCH_IN patch from the unblurred pyramid and blurring IN-PATCH with two
    small 'valid' matmuls drops the full-stack Gaussian blur and one
    1024-way gather pass from the per-frame program. Interior
    blur values are identical to the whole-image blur; only pattern samples
    of keypoints within 27 px of a level border see (already zero-padded)
    context differences. Returns (angles, desc)."""
    half_in = PATCH_IN // 2
    n = xs.shape[0]
    padded = jnp.pad(P, ((0, 0), (half_in, half_in), (half_in, half_in)))
    L, Hp, Wp = padded.shape
    flat2d = padded.reshape(L * Hp, Wp)

    def get_patch(l, y, x):
        return jax.lax.dynamic_slice(
            flat2d, (l * Hp + y, x), (PATCH_IN, PATCH_IN)
        )

    patches = jax.vmap(get_patch)(lvls, ys, xs)  # (n, 54, 54)

    # IC-angle from the central 31x31 of the unblurred patch
    S = 2 * brief.HALF_PATCH + 1
    off = half_in - brief.HALF_PATCH
    kx, ky = _moment_kernels()
    kmat = jnp.stack([kx.reshape(-1), ky.reshape(-1)], axis=1)  # (961, 2)
    central = jax.lax.dynamic_slice(
        patches, (0, off, off), (n, S, S)
    ).reshape(n, S * S)
    m = central @ kmat
    angles = jnp.arctan2(m[:, 1], m[:, 0])

    # in-patch separable blur: (48,54) @ (n,54,54) @ (54,48)
    blurred = jnp.einsum(
        "rh,nhw,cw->nrc", _BLUR_VALID, patches, _BLUR_VALID,
        precision=jax.lax.Precision.DEFAULT,
    ).reshape(n, PATCH_SIDE * PATCH_SIDE)

    # quantize + two int8 matmuls (see _batched_descriptors)
    q = jnp.clip(jnp.round(blurred), 0, 255).astype(jnp.int32)
    hi = (q >> 1).astype(jnp.int8)
    lo = (q & 1).astype(jnp.int8)
    dimn = (((1,), (0,)), ((), ()))
    mm = lambda a: jax.lax.dot_general(
        a, _DIFF_MAT_I8, dimn, preferred_element_type=jnp.int32
    )
    diff = 2 * mm(hi) + mm(lo)
    bits_all = (diff > 0).reshape(n, N_ROT_BINS, 256)
    bidx = (
        jnp.round(angles / (2 * jnp.pi) * N_ROT_BINS).astype(jnp.int32)
        % N_ROT_BINS
    )
    onehot = jax.nn.one_hot(bidx, N_ROT_BINS, dtype=jnp.float32)
    bits = jnp.einsum("nb,nbs->ns", onehot, bits_all.astype(jnp.float32),
                      precision=jax.lax.Precision.DEFAULT) > 0.5
    bits = bits.astype(jnp.uint32).reshape(-1, 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    desc = jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)
    return angles, desc


@functools.partial(
    jax.jit,
    static_argnames=("n_features", "n_levels", "scale", "ini_th", "min_th"),
)
def extract_batched(
    img: jnp.ndarray,
    n_features: int = 1024,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
) -> Features:
    """Drop-in equivalent of extractor.extract, one fused program."""
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
    h, w = img.shape
    P, shapes = _padded_pyramid(img, n_levels, scale)
    usable = [i for i, (hh, ww) in enumerate(shapes) if min(hh, ww) >= 35]
    quotas = select.level_quotas(n_features, n_levels, scale)
    if len(usable) < n_levels:
        dropped = sum(quotas[i] for i in range(n_levels) if i not in usable)
        quotas = [q if i in usable else 0 for i, q in enumerate(quotas)]
        quotas[usable[-1]] += dropped

    bmask = _bounds_mask(h, w, shapes)
    resp = fast.dual_threshold_response(P, ini_th, min_th)
    # kill responses in the padded region AND within 19px of level borders
    hb = jnp.asarray([s[0] for s in shapes])[:, None, None]
    wb = jnp.asarray([s[1] for s in shapes])[:, None, None]
    row = jnp.arange(h)[None, :, None]
    col = jnp.arange(w)[None, None, :]
    inb = (row >= 19) & (row < hb - 19) & (col >= 19) & (col < wb - 19)
    resp = jnp.where(inb & bmask, resp, 0.0)

    xs, ys, lvls, rs, valid = _batched_select(resp, quotas, border=0)

    # compact to exactly n_features BEFORE the per-keypoint stages so the
    # orientation/descriptor work never runs on padding candidates
    n_cand = xs.shape[0]
    pri = jnp.where(valid, 1e6 + rs, 0.0) - jnp.arange(n_cand) * 1e-6
    _, order = jax.lax.top_k(pri, n_features)
    xs, ys, lvls, rs, valid = (
        xs[order], ys[order], lvls[order], rs[order], valid[order]
    )

    angles, desc = _per_keypoint_stages(P, xs, ys, lvls, shapes)

    sfac = jnp.asarray([scale ** i for i in range(n_levels)])[lvls]
    xy = jnp.stack([xs.astype(jnp.float32) * sfac, ys.astype(jnp.float32) * sfac], -1)

    return Features(
        xy=xy,
        level=lvls.astype(jnp.int32),
        angle=angles,
        response=jnp.where(valid, rs, -jnp.inf),
        desc=desc,
        valid=valid,
        u_right=jnp.full((n_features,), -1.0, jnp.float32),
        depth=jnp.full((n_features,), -1.0, jnp.float32),
    )
