"""Camera projection models as vmappable pure functions.

JAX replacement for the reference's GeometricCamera hierarchy
(reference: include/CameraModels/GeometricCamera.h:63-100,
src/CameraModels/Pinhole.cpp, src/CameraModels/KannalaBrandt8.cpp).

Instead of virtual dispatch, a camera is a small dataclass of static intrinsics
plus a `kind`; projection functions switch on kind statically (each pipeline is
jitted per camera model — there is never a per-point dynamic model choice in
the reference either).

All functions broadcast over leading batch dims and return analytic Jacobians
where the reference does (projectJac, GeometricCamera.h:77).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

PINHOLE = 0
KANNALA_BRANDT8 = 1


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera intrinsics. fx, fy, cx, cy always; k1..k4 for KB8
    (equidistant fisheye, KannalaBrandt8.cpp:40-118); width/height for frustum
    and grid bounds; bf = baseline*fx for stereo (Frame.cc usage)."""

    kind: int
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    width: int = 752
    height: int = 480
    bf: float = 0.0  # stereo baseline * fx
    fps: float = 20.0

    @property
    def K(self):
        return jnp.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=jnp.float32,
        )

    @property
    def baseline(self):
        return self.bf / self.fx if self.bf > 0 else 0.0


def project(cam: Camera, pc: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame 3D points (...,3) -> pixel coords (...,2).

    Pinhole: Pinhole.cpp project; KB8: theta-polynomial equidistant projection
    (KannalaBrandt8.cpp:40-118)."""
    if cam.kind == PINHOLE:
        z = pc[..., 2]
        inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * pc[..., 0] * inv_z + cam.cx
        v = cam.fy * pc[..., 1] * inv_z + cam.cy
        return jnp.stack([u, v], axis=-1)
    # KB8 fisheye
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(jnp.maximum(r2, 1e-18))
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (cam.k1 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * cam.k4))))
    scale = theta_d / jnp.maximum(r, 1e-12)
    small = r < 1e-8  # on-axis: pinhole limit
    u = jnp.where(small, cam.cx + cam.fx * x / jnp.maximum(z, 1e-9), cam.fx * x * scale + cam.cx)
    v = jnp.where(small, cam.cy + cam.fy * y / jnp.maximum(z, 1e-9), cam.fy * y * scale + cam.cy)
    return jnp.stack([u, v], axis=-1)


def project_jac(cam: Camera, pc: jnp.ndarray) -> jnp.ndarray:
    """d(u,v)/d(pc): (...,2,3). Pinhole closed-form (Pinhole.cpp projectJac);
    KB8 analytic (KannalaBrandt8.cpp:229-320)."""
    if cam.kind == PINHOLE:
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        inv_z2 = inv_z * inv_z
        zero = jnp.zeros_like(x)
        row_u = jnp.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], axis=-1)
        row_v = jnp.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], axis=-1)
        return jnp.stack([row_u, row_v], axis=-2)
    # KB8: use autodiff of the closed-form projection (shape-static, fuses fine).
    flat = pc.reshape(-1, 3)
    J = jax.vmap(jax.jacfwd(lambda p: project(cam, p)))(flat)
    return J.reshape(pc.shape[:-1] + (2, 3))


def unproject(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """Pixel (...,2) -> unit-depth bearing (...,3) with z=1 for pinhole;
    KB8 uses fixed-iteration Newton inversion of the theta polynomial
    (KannalaBrandt8.cpp:142-228, reference runs 10 iterations)."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    if cam.kind == PINHOLE:
        return jnp.stack([mx, my, jnp.ones_like(mx)], axis=-1)
    theta_d = jnp.sqrt(mx * mx + my * my)
    theta_d_c = jnp.clip(theta_d, -jnp.pi / 2, jnp.pi / 2)

    def newton_step(theta, _):
        t2 = theta * theta
        k_poly = cam.k1 * t2 + cam.k2 * t2 * t2 + cam.k3 * t2 ** 3 + cam.k4 * t2 ** 4
        k_poly_d = 3 * cam.k1 * t2 + 5 * cam.k2 * t2 * t2 + 7 * cam.k3 * t2 ** 3 + 9 * cam.k4 * t2 ** 4
        theta_fix = (theta * (1 + k_poly) - theta_d_c) / (1 + k_poly_d)
        return theta - theta_fix, None

    theta, _ = jax.lax.scan(newton_step, theta_d_c, None, length=10)
    scale = jnp.where(theta_d > 1e-8, jnp.tan(theta) / jnp.maximum(theta_d, 1e-12), 1.0)
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def in_image(cam: Camera, uv: jnp.ndarray, margin: float = 0.0) -> jnp.ndarray:
    """Bounds check (...,2) -> bool (...,). Mirrors Frame::PosInGrid bounds."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= margin)
        & (u < cam.width - margin)
        & (v >= margin)
        & (v < cam.height - margin)
    )


def stereo_right_u(cam: Camera, u: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """Virtual right-image u coordinate: uR = u - bf/z (Frame.cc:1376
    ComputeStereoFromRGBD; used by stereo reprojection residuals)."""
    return u - cam.bf / jnp.maximum(depth, 1e-9)


def pinhole_equivalent(cam: Camera) -> Camera:
    """The virtual undistorted pinhole sharing cam's fx/fy/cx/cy — the
    geometry camera used with undistorted keypoints (Frame::UndistortKeyPoints
    pattern, Frame.cc:157: all downstream geometry runs on mvKeysUn)."""
    import dataclasses as _dc

    return _dc.replace(cam, kind=PINHOLE, k1=0.0, k2=0.0, k3=0.0, k4=0.0)


def undistort_points(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """Map raw (distorted) pixel coords to the virtual pinhole image."""
    if cam.kind == PINHOLE:
        return uv
    rays = unproject(cam, uv)
    return project(pinhole_equivalent(cam), rays)


def euroc_cam0() -> Camera:
    """EuRoC MAV cam0 intrinsics (rectified pinhole used across examples)."""
    return Camera(
        kind=PINHOLE,
        fx=435.2046959714599,
        fy=435.2046959714599,
        cx=367.4517211914062,
        cy=252.2008514404297,
        width=752,
        height=480,
        bf=47.90639384423901,
        fps=20.0,
    )
