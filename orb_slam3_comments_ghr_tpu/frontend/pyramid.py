"""Image pyramid + Gaussian blur.

Replaces ORBextractor::ComputePyramid (reference: src/ORBextractor.cc:1692,
8 levels, scale factor 1.2, bilinear resize) and the pre-descriptor 7x7
sigma=2 GaussianBlur (ORBextractor.cc:1628-1636).

Images are float32 (H, W) grayscale. All shapes static per (H, W, n_levels)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEFAULT_N_LEVELS = 8
DEFAULT_SCALE = 1.2


def level_shapes(h: int, w: int, n_levels: int = DEFAULT_N_LEVELS, scale: float = DEFAULT_SCALE):
    """Static per-level (h, w) list."""
    out = []
    for lv in range(n_levels):
        f = 1.0 / (scale ** lv)
        out.append((max(8, int(round(h * f))), max(8, int(round(w * f)))))
    return out


def scale_factors(n_levels: int = DEFAULT_N_LEVELS, scale: float = DEFAULT_SCALE):
    return jnp.array([scale ** i for i in range(n_levels)], jnp.float32)


import numpy as _np


def _interp_matrix(n_out: int, n_in: int) -> jnp.ndarray:
    """(n_out, n_in) bilinear resampling matrix with half-pixel centers
    (cv::resize INTER_LINEAR convention). Dense on purpose: separable resize
    becomes two matmuls instead of jax.image.resize's gather-based
    lowering. At default precision a GPU may run them in TF32 (see
    utils/precision.py)."""
    scale = n_out / n_in
    x = (_np.arange(n_out, dtype=_np.float64) + 0.5) / scale - 0.5
    j = _np.arange(n_in, dtype=_np.float64)
    # antialiased triangle kernel (support widened by 1/scale when
    # downsampling), matching jax.image.resize(method="linear") so detector
    # thresholds stay calibrated
    M = _np.maximum(0.0, 1.0 - _np.abs(j[None, :] - x[:, None]) * min(scale, 1.0))
    M /= M.sum(axis=1, keepdims=True)
    return jnp.asarray(M.astype(_np.float32))


def build_pyramid(img: jnp.ndarray, n_levels: int = DEFAULT_N_LEVELS, scale: float = DEFAULT_SCALE):
    """Returns a list of n_levels arrays, level 0 = input. Bilinear, matching
    cv::resize INTER_LINEAR; each level resampled from the previous via
    separable interpolation matmuls (A_rows @ img @ A_cols^T)."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    cur = img
    for lv in range(1, n_levels):
        h_in, w_in = cur.shape
        h_out, w_out = shapes[lv]
        A_r = _interp_matrix(h_out, h_in)
        A_c = _interp_matrix(w_out, w_in)
        cur = A_r @ cur @ A_c.T
        levels.append(cur)
    return levels


def _gauss_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    half = ksize // 2
    x = jnp.arange(-half, half + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian with reflect padding (~cv BORDER_REFLECT_101)."""
    k = _gauss_kernel_1d(ksize, sigma)
    half = ksize // 2
    x = jnp.pad(img, ((half, half), (half, half)), mode="reflect")
    # rows
    x = jax.lax.conv_general_dilated(
        x[None, None, :, :],
        k[None, None, :, None],
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.DEFAULT,
    )
    # cols
    x = jax.lax.conv_general_dilated(
        x,
        k[None, None, None, :],
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.DEFAULT,
    )
    return x[0, 0]
