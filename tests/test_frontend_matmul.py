"""The matmul-phrased frontend stages (matmul pyramid/blur, patch-moment
angles) must match their direct conv/resize formulations."""

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam3_comments_ghr_tpu.frontend import batched, pyramid


def _img(seed=0, h=240, w=376):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.random((h, w)).astype(np.float32) * 255)


class TestMatmulPyramid:
    def test_matches_jax_image_resize(self):
        img = _img()
        new = pyramid.build_pyramid(img, 6, 1.2)
        shapes = pyramid.level_shapes(240, 376, 6, 1.2)
        cur = img
        for lv in range(1, 6):
            cur = jax.image.resize(cur, shapes[lv], method="linear")
            d = np.abs(np.asarray(new[lv]) - np.asarray(cur)).max()
            assert d < 0.02, (lv, d)  # float accumulation only

    def test_upsample_also_consistent(self):
        # interpolation matrix must handle scale >= 1 (used nowhere in the
        # pyramid but keeps the helper total)
        M = pyramid._interp_matrix(20, 10)
        ref = np.asarray(
            jax.image.resize(jnp.arange(10.0), (20,), method="linear")
        )
        got = np.asarray(M) @ np.arange(10.0, dtype=np.float32)
        assert np.abs(got - ref).max() < 1e-5


class TestBandedBlur:
    def test_matches_separable_conv(self):
        P = jnp.asarray(
            np.random.default_rng(1).random((4, 120, 200)).astype(np.float32) * 255
        )
        new = np.asarray(batched._batched_blur(P))
        k = pyramid._gauss_kernel_1d(7, 2.0)
        x = jnp.pad(P, ((0, 0), (3, 3), (3, 3)), mode="edge")[:, None]
        x = jax.lax.conv_general_dilated(
            x, k[None, None, :, None], (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))
        x = jax.lax.conv_general_dilated(
            x, k[None, None, None, :], (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))
        old = np.asarray(x[:, 0])
        assert np.abs(new - old).max() < 1e-3


class TestPatchMomentAngles:
    def test_matches_full_conv_moments(self):
        rng = np.random.default_rng(2)
        img = _img(2, 480, 752)
        P, shapes = batched._padded_pyramid(img, 8, 1.2)
        xs = jnp.asarray(rng.integers(30, 340, 100, dtype=np.int32))
        ys = jnp.asarray(rng.integers(30, 200, 100, dtype=np.int32))
        lv = jnp.asarray(rng.integers(0, 4, 100, dtype=np.int32))
        new = np.asarray(batched._ic_angles_at(P, xs, ys, lv))

        kx, ky = batched._moment_kernels()
        out = jax.lax.conv_general_dilated(
            P[:, None], jnp.stack([kx, ky])[:, None], (1, 1), "SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))
        h, w = img.shape
        idx = lv * (h * w) + ys * w + xs
        old = np.asarray(jnp.arctan2(
            out[:, 1].reshape(-1)[idx], out[:, 0].reshape(-1)[idx]))
        d = np.abs(new - old)
        d = np.minimum(d, 2 * np.pi - d)
        assert d.max() < 1e-3
