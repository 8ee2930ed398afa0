"""IMU preintegration as a single `lax.scan` — JAX equivalent of the
reference's IMU::Preintegrated (ImuTypes.cc:106-421: IntegrateNewMeasurement,
delta-R/V/P accumulation, bias Jacobians JRg/JVg/JVa/JPg/JPa, covariance
propagation, and the GetDeltaRotation/Velocity/Position bias-update
first-order corrections ImuTypes.cc:296-344).

Design: the C++ class integrates measurement-by-measurement under a mutex;
here a fixed-size batch of (gyro, acc, dt) samples is scanned once inside
jit.  All state is a NamedTuple of arrays, so preintegration is pure,
differentiable, and batchable with vmap over many keyframe intervals at once
(the reference integrates each interval serially on the tracking thread).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie

GRAVITY = jnp.asarray([0.0, 0.0, -9.81])


class ImuBias(NamedTuple):
    """Gyro + accelerometer bias (reference IMU::Bias, ImuTypes.h)."""

    bg: jnp.ndarray  # [3]
    ba: jnp.ndarray  # [3]


def zero_bias(dtype=jnp.float32) -> ImuBias:
    return ImuBias(jnp.zeros(3, dtype), jnp.zeros(3, dtype))


class Preintegrated(NamedTuple):
    """Preintegrated IMU delta between two frames/keyframes.

    Mirrors IMU::Preintegrated's state (ImuTypes.h / ImuTypes.cc:184-294):
    dR (as quaternion), dV, dP, the five bias Jacobians, the 9x9 covariance
    of (phi, v, p), total dt, and the linearization bias.
    """

    dq: jnp.ndarray  # [4] quaternion of delta rotation body_i <- body_j
    dv: jnp.ndarray  # [3]
    dp: jnp.ndarray  # [3]
    JRg: jnp.ndarray  # [3,3] d(dR)/d(bg)
    JVg: jnp.ndarray  # [3,3]
    JVa: jnp.ndarray  # [3,3]
    JPg: jnp.ndarray  # [3,3]
    JPa: jnp.ndarray  # [3,3]
    cov: jnp.ndarray  # [9,9] order (phi, v, p)
    cov_walk: jnp.ndarray  # [6,6] accumulated bias random-walk covariance
    dt: jnp.ndarray  # [] total time
    bias: ImuBias  # linearization point


def _right_jacobian_so3(phi):
    """Right Jacobian of SO(3) (reference RightJacobianSO3, ImuTypes.cc:74)."""
    theta2 = jnp.dot(phi, phi)
    theta = jnp.sqrt(theta2 + 1e-24)
    W = lie.hat(phi)
    small = theta2 < 1e-10
    A = jnp.where(small, 0.5, (1.0 - jnp.cos(theta)) / (theta2 + 1e-24))
    B = jnp.where(
        small, 1.0 / 6.0, (theta - jnp.sin(theta)) / (theta2 * theta + 1e-24)
    )
    return jnp.eye(3) - A * W + B * (W @ W)


def preintegrate(
    gyro: jnp.ndarray,  # [N,3] rad/s
    acc: jnp.ndarray,  # [N,3] m/s^2
    dt: jnp.ndarray,  # [N] s (0 entries = padding, ignored)
    bias: ImuBias,
    *,
    gyro_noise: float = 1.7e-4,
    acc_noise: float = 2.0e-3,
    gyro_walk: float = 1.9e-5,
    acc_walk: float = 3.0e-3,
) -> Preintegrated:
    """Integrate a (padded) batch of IMU samples into one Preintegrated delta.

    Equivalent to looping IMU::Preintegrated::IntegrateNewMeasurement
    (ImuTypes.cc:184-294) over the samples; runs as one lax.scan so vmap over
    intervals turns per-keyframe preintegration into a batched kernel.
    Padding rows must have dt == 0 (they contribute nothing).
    """
    gyro = jnp.asarray(gyro, jnp.float32)
    acc = jnp.asarray(acc, jnp.float32)
    dt = jnp.asarray(dt, jnp.float32)
    Ng2 = gyro_noise * gyro_noise
    Na2 = acc_noise * acc_noise
    # per-sample bias random-walk covariance = walk_density^2 * dt
    # (reference Calib CovWalk = diag(ngw^2, naw^2)/freq, accumulated into
    # C.block<6,6>(9,9) each IntegrateNewMeasurement, ImuTypes.cc:249)
    walk_diag = jnp.asarray(
        [gyro_walk**2] * 3 + [acc_walk**2] * 3, jnp.float32
    )

    def step(carry, x):
        dq, dv, dp, JRg, JVg, JVa, JPg, JPa, cov, cov_walk, T = carry
        w, a, h = x
        w = w - bias.bg
        a = a - bias.ba
        R = lie.quat_to_matrix(dq)
        ah = lie.hat(a)

        # position/velocity updates use the pre-update rotation (ImuTypes.cc:208-216)
        dp_new = dp + dv * h + 0.5 * (R @ a) * h * h
        dv_new = dv + (R @ a) * h

        # covariance propagation A/B matrices (ImuTypes.cc:220-249)
        phi = w * h
        dR_inc = lie.so3_exp(phi)
        Rinc = lie.quat_to_matrix(dR_inc)
        Jr = _right_jacobian_so3(phi)
        A = jnp.eye(9)
        A = A.at[0:3, 0:3].set(Rinc.T)
        A = A.at[3:6, 0:3].set(-R @ ah * h)
        A = A.at[6:9, 0:3].set(-0.5 * R @ ah * h * h)
        A = A.at[6:9, 3:6].set(jnp.eye(3) * h)
        B = jnp.zeros((9, 6))
        B = B.at[0:3, 0:3].set(Jr * h)
        B = B.at[3:6, 3:6].set(R * h)
        B = B.at[6:9, 3:6].set(0.5 * R * h * h)
        Nga = jnp.diag(jnp.asarray([Ng2, Ng2, Ng2, Na2, Na2, Na2])) / jnp.maximum(
            h, 1e-9
        )
        cov_new = A @ cov @ A.T + B @ Nga @ B.T
        cov_walk_new = cov_walk + jnp.diag(walk_diag * h)

        # bias Jacobians (ImuTypes.cc:252-258)
        JPa_new = JPa + JVa * h - 0.5 * R * h * h
        JPg_new = JPg + JVg * h - 0.5 * R @ ah @ JRg * h * h
        JVa_new = JVa - R * h
        JVg_new = JVg - R @ ah @ JRg * h
        JRg_new = Rinc.T @ JRg - Jr * h

        dq_new = lie.quat_normalize(lie.quat_mul(dq, dR_inc))

        live = h > 0
        new = (dq_new, dv_new, dp_new, JRg_new, JVg_new, JVa_new, JPg_new,
               JPa_new, cov_new, cov_walk_new, T + h)
        old = (dq, dv, dp, JRg, JVg, JVa, JPg, JPa, cov, cov_walk, T)
        carry = jax.tree.map(lambda n, o: jnp.where(live, n, o), new, old)
        return carry, None

    Z3 = jnp.zeros((3, 3))
    # all bias Jacobians start at ZERO (reference Preintegrated::Initialize)
    init = (lie.quat_identity(), jnp.zeros(3), jnp.zeros(3),
            Z3, Z3, Z3, Z3, Z3, jnp.zeros((9, 9)), jnp.zeros((6, 6)),
            jnp.float32(0.0))
    (dq, dv, dp, JRg, JVg, JVa, JPg, JPa, cov, cov_walk, T), _ = jax.lax.scan(
        step, init, (gyro, acc, dt)
    )
    return Preintegrated(dq, dv, dp, JRg, JVg, JVa, JPg, JPa, cov, cov_walk,
                         T, bias)


def delta_with_bias(pre: Preintegrated, bias: ImuBias):
    """First-order bias-corrected deltas (GetDeltaRotation/Velocity/Position,
    ImuTypes.cc:296-323).  Returns (dq, dv, dp) at the new bias."""
    dbg = bias.bg - pre.bias.bg
    dba = bias.ba - pre.bias.ba
    dq = lie.quat_mul(pre.dq, lie.so3_exp(pre.JRg @ dbg))
    dv = pre.dv + pre.JVg @ dbg + pre.JVa @ dba
    dp = pre.dp + pre.JPg @ dbg + pre.JPa @ dba
    return lie.quat_normalize(dq), dv, dp


def inertial_residual(
    pre: Preintegrated,
    q_wb_i, p_wb_i, v_i,
    q_wb_j, p_wb_j, v_j,
    bias: ImuBias,
    gravity=GRAVITY,
):
    """9-vector residual (r_phi, r_v, r_p) of one inertial edge — the
    reference's EdgeInertial::computeError (G2oTypes.cc:569-600)."""
    dq, dv, dp = delta_with_bias(pre, bias)
    Ri_t = lie.quat_to_matrix(lie.quat_conj(q_wb_i))
    dt = pre.dt
    er_q = lie.quat_mul(
        lie.quat_conj(dq), lie.quat_mul(lie.quat_conj(q_wb_i), q_wb_j)
    )
    r_phi = lie.so3_log(er_q)
    r_v = Ri_t @ (v_j - v_i - gravity * dt) - dv
    r_p = Ri_t @ (p_wb_j - p_wb_i - v_i * dt - 0.5 * gravity * dt * dt) - dp
    return jnp.concatenate([r_phi, r_v, r_p])
