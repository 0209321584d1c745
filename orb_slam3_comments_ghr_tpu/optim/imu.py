"""IMU preintegration and state prediction.

JAX replacement for IMU::Preintegrated (reference: src/ImuTypes.cc,
IntegrateNewMeasurement at :246-328): the per-sample forward integration with
15x15 covariance propagation and bias Jacobians is a lax.scan over the padded
sample buffer; reintegration with a new bias (Preintegrated::Reintegrate,
:230) is just re-running the scan — the raw samples ride along as arrays.

State layout matches the reference: [dR(0:3), dV(3:6), dP(6:9), bg(9:12),
ba(12:15)]; gravity constant 9.81 (ImuTypes.h:44).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie

GRAVITY = 9.81
GRAVITY_VEC = jnp.array([0.0, 0.0, -GRAVITY], jnp.float32)


class ImuCalib(NamedTuple):
    """IMU noise model + extrinsics (IMU::Calib, ImuTypes.h:70).

    Tbc: (R (3,3), t (3,)) camera-to-body transform.
    noise_g/a: continuous-time densities discretized by the caller as
    sigma*sqrt(freq); walk_g/a as sigma/sqrt(freq) (Tracking.cc:680-681:
    Calib(Tbc, Ng*sf, Na*sf, Ngw/sf, Naw/sf))."""

    Rbc: jnp.ndarray
    tbc: jnp.ndarray
    noise_g: float
    noise_a: float
    walk_g: float
    walk_a: float


def default_calib() -> ImuCalib:
    # EuRoC ADIS16448: noise sigma*sqrt(rate), walk sigma/sqrt(rate)
    return ImuCalib(
        Rbc=jnp.eye(3, dtype=jnp.float32),
        tbc=jnp.zeros(3, jnp.float32),
        noise_g=1.7e-4 * (200.0 ** 0.5),
        noise_a=2.0e-3 * (200.0 ** 0.5),
        walk_g=1.9e-5 / (200.0 ** 0.5),
        walk_a=3.0e-3 / (200.0 ** 0.5),
    )


class Preintegrated(NamedTuple):
    """Preintegrated IMU measurement between two frames/keyframes.

    dT: () total time; dR (3,3); dV, dP (3,)
    C: (15,15) covariance [phi, v, p, bg, ba]
    J_rg, J_vg, J_va, J_pg, J_pa: (3,3) bias Jacobians
    bias: (6,) [bg, ba] used during integration
    acc, gyr, dts: padded raw samples (for reintegration), n_valid mask via dts>0
    """

    dT: jnp.ndarray
    dR: jnp.ndarray
    dV: jnp.ndarray
    dP: jnp.ndarray
    C: jnp.ndarray
    J_rg: jnp.ndarray
    J_vg: jnp.ndarray
    J_va: jnp.ndarray
    J_pg: jnp.ndarray
    J_pa: jnp.ndarray
    bias: jnp.ndarray
    acc: jnp.ndarray
    gyr: jnp.ndarray
    dts: jnp.ndarray


def _scan_preintegrate(init, acc, gyr, dts, bias, calib):
    """Core lax.scan of IntegrateNewMeasurement over a (possibly padded)
    sample chunk, from an arbitrary starting carry."""
    dtype = acc.dtype
    Nga = jnp.diag(
        jnp.array(
            [calib.noise_g**2] * 3 + [calib.noise_a**2] * 3, dtype
        )
    )
    NgaWalk = jnp.diag(
        jnp.array([calib.walk_g**2] * 3 + [calib.walk_a**2] * 3, dtype)
    )
    bg, ba = bias[:3], bias[3:]

    def step(carry, inp):
        dR, dV, dP, C, J_rg, J_vg, J_va, J_pg, J_pa, dT = carry
        a_raw, w_raw, dt = inp
        a = a_raw - ba
        w = w_raw - bg
        active = dt > 0.0

        # position/velocity first (use pre-update dR), ImuTypes.cc:275-277
        dP_n = dP + dV * dt + 0.5 * dR @ a * dt * dt
        dV_n = dV + dR @ a * dt

        Wacc = lie.hat(a)
        # bias Jacobians (pre-update dR/J, ImuTypes.cc:292-296)
        J_pa_n = J_pa + J_va * dt - 0.5 * dR * dt * dt
        J_pg_n = J_pg + J_vg * dt - 0.5 * dR * dt * dt @ Wacc @ J_rg
        J_va_n = J_va - dR * dt
        J_vg_n = J_vg - dR * dt @ Wacc @ J_rg

        dRi = lie.so3_exp(w * dt)
        rightJ = lie.so3_right_jacobian(w * dt)
        dR_n = dR @ dRi

        # covariance propagation (9x9 visual part + bias walk)
        eye3 = jnp.eye(3, dtype=dtype)
        A = jnp.zeros((9, 9), dtype)
        A = A.at[0:3, 0:3].set(dRi.T)
        A = A.at[3:6, 0:3].set(-dR * dt @ Wacc)
        A = A.at[6:9, 0:3].set(-0.5 * dR * dt * dt @ Wacc)
        A = A.at[3:6, 3:6].set(eye3)
        A = A.at[6:9, 6:9].set(eye3)
        A = A.at[6:9, 3:6].set(eye3 * dt)
        B = jnp.zeros((9, 6), dtype)
        B = B.at[0:3, 0:3].set(rightJ * dt)
        B = B.at[3:6, 3:6].set(dR * dt)
        B = B.at[6:9, 3:6].set(0.5 * dR * dt * dt)
        # walk block grows per SAMPLE with the pre-discretized NgaWalk
        # (ImuTypes.cc:312 `C.block<6,6>(9,9) += NgaWalk` — no dt factor)
        C9 = A @ C[:9, :9] @ A.T + B @ Nga @ B.T
        C_n = C.at[:9, :9].set(C9)
        C_n = C_n.at[9:, 9:].add(NgaWalk)

        J_rg_n = dRi.T @ J_rg - rightJ * dt

        def sel(new, old):
            return jnp.where(active, new, old)

        carry = (
            sel(dR_n, dR), sel(dV_n, dV), sel(dP_n, dP), sel(C_n, C),
            sel(J_rg_n, J_rg), sel(J_vg_n, J_vg), sel(J_va_n, J_va),
            sel(J_pg_n, J_pg), sel(J_pa_n, J_pa), dT + jnp.where(active, dt, 0.0),
        )
        return carry, None

    (dR, dV, dP, C, J_rg, J_vg, J_va, J_pg, J_pa, dT), _ = jax.lax.scan(
        step, init, (acc, gyr, dts)
    )
    dR = lie.normalize_rotation(dR)
    return Preintegrated(
        dT=dT, dR=dR, dV=dV, dP=dP, C=C,
        J_rg=J_rg, J_vg=J_vg, J_va=J_va, J_pg=J_pg, J_pa=J_pa,
        bias=bias, acc=acc, gyr=gyr, dts=dts,
    )


@jax.jit
def preintegrate(
    acc: jnp.ndarray,
    gyr: jnp.ndarray,
    dts: jnp.ndarray,
    bias: jnp.ndarray,
    calib: ImuCalib,
) -> Preintegrated:
    """acc/gyr: (T,3) samples; dts: (T,) per-sample dt (0 = padding);
    bias: (6,) [bg, ba]. One lax.scan, mirroring IntegrateNewMeasurement."""
    dtype = acc.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    z3 = jnp.zeros(3, dtype)
    init = (
        eye3, z3, z3, jnp.zeros((15, 15), dtype),
        jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype),
        jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype), jnp.zeros((), dtype),
    )
    return _scan_preintegrate(init, acc, gyr, dts, bias, calib)


@jax.jit
def preintegrate_continue(
    pre: Preintegrated,
    acc: jnp.ndarray,
    gyr: jnp.ndarray,
    dts: jnp.ndarray,
    calib: ImuCalib,
) -> Preintegrated:
    """Integrate a NEW sample chunk onto an existing preintegration — the
    incremental per-frame accumulation of mpImuPreintegratedFromLastKF
    (Tracking.cc:1883 calling IntegrateNewMeasurement on both accumulators),
    avoiding the O(gap^2) rescan of every sample since the keyframe. Uses
    pre.bias. The returned raw-sample buffers hold only the NEW chunk;
    callers that need the full raw history (keyframe creation, preintegration
    merging on cull) must reintegrate from their stored rows."""
    init = (pre.dR, pre.dV, pre.dP, pre.C,
            pre.J_rg, pre.J_vg, pre.J_va, pre.J_pg, pre.J_pa, pre.dT)
    return _scan_preintegrate(init, acc, gyr, dts, pre.bias, calib)


def empty_preintegrated(capacity: int, bias=None, dtype=jnp.float32) -> Preintegrated:
    if bias is None:
        bias = jnp.zeros(6, dtype)
    return Preintegrated(
        dT=jnp.zeros((), dtype),
        dR=jnp.eye(3, dtype=dtype),
        dV=jnp.zeros(3, dtype),
        dP=jnp.zeros(3, dtype),
        C=jnp.eye(15, dtype=dtype) * 1e-9,
        J_rg=jnp.zeros((3, 3), dtype), J_vg=jnp.zeros((3, 3), dtype),
        J_va=jnp.zeros((3, 3), dtype), J_pg=jnp.zeros((3, 3), dtype),
        J_pa=jnp.zeros((3, 3), dtype),
        bias=bias,
        acc=jnp.zeros((capacity, 3), dtype),
        gyr=jnp.zeros((capacity, 3), dtype),
        dts=jnp.zeros((capacity,), dtype),
    )


def delta_with_bias(pre: Preintegrated, new_bias: jnp.ndarray):
    """First-order bias-corrected deltas (GetDeltaRotation/Velocity/Position,
    ImuTypes.h:189-204)."""
    dbg = new_bias[:3] - pre.bias[:3]
    dba = new_bias[3:] - pre.bias[3:]
    dR = pre.dR @ lie.so3_exp(pre.J_rg @ dbg)
    dV = pre.dV + pre.J_vg @ dbg + pre.J_va @ dba
    dP = pre.dP + pre.J_pg @ dbg + pre.J_pa @ dba
    return dR, dV, dP


def predict_state(
    Rwb: jnp.ndarray,
    pwb: jnp.ndarray,
    vwb: jnp.ndarray,
    bias: jnp.ndarray,
    pre: Preintegrated,
):
    """Dead-reckoning prediction from a previous body state
    (Tracking::PredictStateIMU, Tracking.cc:1929)."""
    dR, dV, dP = delta_with_bias(pre, bias)
    t = pre.dT
    g = GRAVITY_VEC.astype(Rwb.dtype)
    Rwb2 = lie.normalize_rotation(Rwb @ dR)
    vwb2 = vwb + g * t + Rwb @ dV
    pwb2 = pwb + vwb * t + 0.5 * g * t * t + Rwb @ dP
    return Rwb2, pwb2, vwb2


def inertial_residual(
    R1, p1, v1, R2, p2, v2, bias, pre: Preintegrated, Rwg=None, scale=None
):
    """9-dim preintegration residual [er, ev, ep] (EdgeInertial::computeError,
    G2oTypes.cc; EdgeInertialGS adds gravity-direction Rwg and scale s for the
    initialization problem).

    Poses are body-in-world (Rwb, pwb). Gravity g' = Rwg @ g0; monocular scale
    multiplies translations/velocities."""
    dR, dV, dP = delta_with_bias(pre, bias)
    t = pre.dT
    g = GRAVITY_VEC.astype(R1.dtype)
    if Rwg is not None:
        g = Rwg @ g
    s = 1.0 if scale is None else scale
    er = lie.so3_log(dR.T @ R1.T @ R2)
    ev = R1.T @ (s * (v2 - v1) - g * t) - dV
    ep = R1.T @ (s * (p2 - p1 - v1 * t) - 0.5 * g * t * t) - dP
    return jnp.concatenate([er, ev, ep])


def information(pre: Preintegrated):
    """9x9 information of the [er, ev, ep] residual = inverse of the
    preintegration covariance top-left block (EdgeInertial ctor)."""
    C9 = pre.C[:9, :9]
    C9 = 0.5 * (C9 + C9.T) + jnp.eye(9, dtype=C9.dtype) * 1e-9
    return jnp.linalg.inv(C9)
