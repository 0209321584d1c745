"""SO(3) / SE(3) / Sim(3) manifold operations with analytic Jacobians.

JAX replacement for the reference's Sophus + g2o type stack
(reference: Thirdparty/g2o/g2o/types/{se3quat.h,sim3.h}, include/ImuTypes.h:258-265
right-Jacobian utilities, src/G2oTypes.cc ExpSO3/LogSO3).

Conventions:
  * Rotations are 3x3 matrices (row-major), translations are length-3 vectors.
  * All functions are pure jnp, broadcast over arbitrary leading batch dims,
    and are safe under vmap/jit/grad.
  * Small-angle branches use jnp.where with Taylor series so gradients stay
    finite at theta -> 0 (both branches are always evaluated under XLA; the
    series arguments are clamped to avoid NaN poisoning).
  * se3 tangent ordering is [rho (trans), phi (rot)] — matching g2o SE3Quat
    ordering used throughout the reference optimizer.
  * sim3 tangent is [rho, phi, sigma] (sigma = log scale).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(v: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: v (...,3) -> skew-symmetric (...,3,3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(M: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def _theta(phi: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.norm(phi, axis=-1)


def _sinc_coeffs_sq(t2: jnp.ndarray):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) given
    t2 = theta^2 (smooth in phi, so gradients stay finite at theta -> 0).
    The sqrt is taken on a clamped value; where() picks the Taylor branch
    near zero so the non-differentiable point never contributes."""
    small = t2 < 1e-8
    safe_t = jnp.sqrt(jnp.where(small, 1.0, t2))
    A = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(safe_t) / safe_t)
    B = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(safe_t)) / (safe_t * safe_t))
    C = jnp.where(small, 1.0 / 6.0 - t2 / 120.0, (safe_t - jnp.sin(safe_t)) / (safe_t ** 3))
    return A, B, C


def _sinc_coeffs(theta: jnp.ndarray):
    return _sinc_coeffs_sq(theta * theta)


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (...,3) tangent -> (...,3,3) rotation."""
    t2 = jnp.sum(phi * phi, axis=-1)
    A, B, _ = _sinc_coeffs_sq(t2)
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return I + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Log map (...,3,3) -> (...,3) via the quaternion log — Shepperd's
    matrix->quat conversion is stable for all angles (including near pi, where
    the classic theta/(2 sin theta) * vee(R - R^T) formula loses float32
    precision), and atan2 is well-conditioned everywhere."""
    q = mat_to_quat(R)  # (w, x, y, z), w >= 0 so theta in [0, pi]
    w = q[..., 0]
    v = q[..., 1:]
    n = jnp.linalg.norm(v, axis=-1)
    theta = 2.0 * jnp.arctan2(n, w)
    small = n < 1e-6
    # phi = theta * v / n ; small-angle: theta ~= 2 n / w  =>  phi ~= 2 v / w
    safe_n = jnp.where(small, 1.0, n)
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-6), theta / safe_n)
    return scale[..., None] * v


def so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """J_l(phi): d exp(phi) perturbations. (...,3) -> (...,3,3)."""
    t2 = jnp.sum(phi * phi, axis=-1)
    _, B, C = _sinc_coeffs_sq(t2)
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return I + B[..., None, None] * K + C[..., None, None] * (K @ K)


def so3_right_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """J_r(phi) = J_l(-phi). Matches IMU::RightJacobianSO3 (ImuTypes.h:258)."""
    return so3_left_jacobian(-phi)


def so3_right_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    """J_r^{-1}(phi), closed form. Matches IMU::InverseRightJacobianSO3."""
    theta = _theta(phi)
    t2 = theta * theta
    small = theta < 1e-4
    safe_t = jnp.where(small, 1.0, theta)
    # coeff = 1/t^2 - (1 + cos t) / (2 t sin t)
    coef = jnp.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        1.0 / (safe_t * safe_t)
        - (1.0 + jnp.cos(safe_t)) / (2.0 * safe_t * jnp.sin(jnp.where(small, 1.0, safe_t))),
    )
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return I + 0.5 * K + coef[..., None, None] * (K @ K)


# ---------------------------------------------------------------------------
# SE(3): pose = (R: (...,3,3), t: (...,3)). Tangent xi = [rho, phi] (6,).
# ---------------------------------------------------------------------------


def se3_exp(xi: jnp.ndarray):
    """(...,6) tangent [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    J = so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", J, rho)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) -> (...,6) tangent [rho, phi]."""
    phi = so3_log(R)
    Jinv = _left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Jinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def _left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    return so3_right_jacobian_inv(-phi)


def se3_mul(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb)."""
    R = Ra @ Rb
    t = jnp.einsum("...ij,...j->...i", Ra, tb) + ta
    return R, t


def se3_inv(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, p):
    """Transform points p (...,3)."""
    return jnp.einsum("...ij,...j->...i", R, p) + t


# ---------------------------------------------------------------------------
# Sim(3): (s: (...,), R, t). Acts as p -> s R p + t.  Tangent [rho, phi, sigma].
# Matches g2o::Sim3 (Thirdparty/g2o/g2o/types/sim3.h) semantics.
# ---------------------------------------------------------------------------


def sim3_exp(xi: jnp.ndarray):
    """(...,7) [rho, phi, sigma] -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(phi)
    theta = _theta(phi)
    W = _sim3_W(theta, sigma, phi)
    t = jnp.einsum("...ij,...j->...i", W, rho)
    return s, R, t


def _sim3_W(theta, sigma, phi):
    """The Sim(3) 'W' matrix coupling translation with rotation+scale."""
    eps = 1e-5
    s = jnp.exp(sigma)
    t2 = theta * theta
    sig_small = jnp.abs(sigma) < eps
    th_small = theta < eps
    safe_sig = jnp.where(sig_small, 1.0, sigma)
    safe_th = jnp.where(th_small, 1.0, theta)

    # A-, B-, C-coefficients per Ethan Eade / Strasdat's thesis.
    C = jnp.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / safe_sig)

    # theta small & sigma small:
    A_ss = 0.5 + sigma / 6.0
    B_ss = 1.0 / 6.0 + sigma / 24.0
    # theta small, sigma general:
    A_sg = ((safe_sig - 1.0) * s + 1.0) / (safe_sig * safe_sig) * jnp.ones_like(theta)
    B_sg = (s * (safe_sig * safe_sig / 2.0 - safe_sig + 1.0) - 1.0) / (safe_sig ** 3)
    # theta general, sigma small:
    A_gs = (1.0 - jnp.cos(safe_th)) / t2.clip(eps ** 2)
    B_gs = (safe_th - jnp.sin(safe_th)) / (safe_th ** 3)
    # general/general:
    a = s * jnp.sin(safe_th)
    b = s * jnp.cos(safe_th)
    c2 = safe_th * safe_th + safe_sig * safe_sig
    A_gg = (a * safe_sig + (1.0 - b) * safe_th) / (safe_th * c2)
    B_gg = (C - ((b - 1.0) * safe_sig + a * safe_th) / c2) / t2.clip(eps ** 2)

    A = jnp.where(
        th_small, jnp.where(sig_small, A_ss, A_sg), jnp.where(sig_small, A_gs, A_gg)
    )
    B = jnp.where(
        th_small, jnp.where(sig_small, B_ss, B_sg), jnp.where(sig_small, B_gs, B_gg)
    )
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return C[..., None, None] * I + A[..., None, None] * K + B[..., None, None] * (K @ K)


def sim3_log(s, R, t):
    """(s, R, t) -> (...,7) [rho, phi, sigma]."""
    sigma = jnp.log(s)
    phi = so3_log(R)
    theta = _theta(phi)
    W = _sim3_W(theta, sigma, phi)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_mul(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) * (sb,Rb,tb): p -> sa Ra (sb Rb p + tb) + ta."""
    s = sa * sb
    R = Ra @ Rb
    t = sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta
    return s, R, t


def sim3_inv(s, R, t):
    s_inv = 1.0 / s
    Rt = jnp.swapaxes(R, -1, -2)
    t_inv = -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t)
    return s_inv, Rt, t_inv


def sim3_apply(s, R, t, p):
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, p) + t


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) — used for compact pose storage in the map SoA and
# for trajectory export (reference exports qx qy qz qw, System.cc:635).
# ---------------------------------------------------------------------------


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def mat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (w,x,y,z), branch-free Shepperd method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate quaternions (up to scale), one per Shepperd case.
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    # Pick the numerically best case.
    cases = jnp.stack([qw, qx, qy, qz], axis=-2)  # (...,4,4)
    scores = jnp.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], axis=-1
    )
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cases, idx[..., None, None].repeat(4, axis=-1), axis=-2)[
        ..., 0, :
    ]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation matrix back onto SO(3) via SVD (used after long
    products, mirroring IMU::NormalizeRotation, ImuTypes.cc bottom)."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape).at[..., 2, 2].set(det)
    return U @ D @ Vt
