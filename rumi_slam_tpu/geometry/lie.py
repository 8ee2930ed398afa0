"""Lie groups for SLAM: SO(3), SE(3), Sim(3) as pure JAX array functions.

JAX replacement for the reference's Sophus dependency
(/root/reference/src/rumi-slam/Thirdparty/Sophus, used throughout e.g.
lib_src/KeyFrame.cc poses, lib_src/Optimizer.cc Sim3 vertices).  Everything is
batched-friendly: each function operates on the trailing axes and can be
``vmap``-ed / broadcast over leading axes.

Storage conventions
-------------------
* quaternion ``q``: ``[..., 4]`` in (w, x, y, z) Hamilton convention, unit norm.
* SE(3) ``T``:      ``[..., 7]`` = concat(q, t).  ``T @ x = R x + t``.
* Sim(3) ``S``:     ``[..., 8]`` = concat(q, t, log_s).  ``S @ x = exp(log_s) R x + t``.
* tangents: SO(3) ``[...,3]`` (omega), SE(3) ``[...,6]`` = (omega, v),
  Sim(3) ``[...,7]`` = (omega, v, sigma).

Poses follow the reference's ``Tcw`` convention (world -> camera) unless a
name says otherwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def _safe_norm(x, axis=-1, keepdims=False):
    """||x|| with a well-defined (zero) gradient at x = 0.

    ``jnp.linalg.norm`` back-propagates NaN at the origin (d sqrt(0)/dx);
    the double-where pattern routes the gradient through a constant branch
    there.  Every exp/log below must use this — the Sim3-refinement LM
    differentiates through exp at tau = 0 on every iteration.
    """
    n2 = jnp.sum(x * x, axis=axis, keepdims=keepdims)
    small = n2 < 1e-24
    n2_safe = jnp.where(small, 1.0, n2)
    return jnp.where(small, 0.0, jnp.sqrt(n2_safe))


# ---------------------------------------------------------------------------
# quaternion / SO(3)
# ---------------------------------------------------------------------------

def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def quat_mul(a, b):
    """Hamilton product a*b, shapes [...,4]."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q, v):
    """Rotate vectors v [...,3] by unit quaternions q [...,4]."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_to_matrix(q):
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_matrix(R):
    """Rotation matrix [...,3,3] -> unit quaternion [...,4] (w>=0 branch-safe).

    Uses the numerically-stable 4-branch construction, selected per element.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # candidate 0: trace
    s0 = jnp.sqrt(jnp.maximum(1.0 + tr, _EPS)) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    # candidate 1: m00 dominant
    s1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    # candidate 2: m11 dominant
    s2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, _EPS)) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    # candidate 3: m22 dominant
    s3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, _EPS)) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = jnp.where(
        cond0[..., None],
        q0,
        jnp.where(cond1[..., None], q1, jnp.where(cond2[..., None], q2, q3)),
    )
    q = jnp.where(q[..., :1] < 0, -q, q)  # canonical sign: w >= 0
    return quat_normalize(q)


def so3_exp(omega):
    """Axis-angle [...,3] -> quaternion [...,4]."""
    theta = _safe_norm(omega, keepdims=True)
    half = 0.5 * theta
    # sinc(half)/... guard small angles with Taylor
    small = theta < 1e-6
    k = jnp.where(small, 0.5 - theta * theta / 48.0, jnp.sin(half) / jnp.maximum(theta, _EPS))
    w = jnp.cos(half)
    return jnp.concatenate([w, k * omega], axis=-1)


def so3_log(q):
    """Unit quaternion [...,4] -> axis-angle [...,3]."""
    q = jnp.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    n = _safe_norm(v, keepdims=True)
    theta = 2.0 * jnp.arctan2(n[..., 0], w)[..., None]
    small = n < 1e-7
    k = jnp.where(small, 2.0 / jnp.maximum(w[..., None], _EPS), theta / jnp.maximum(n, _EPS))
    return k * v


def hat(omega):
    """[...,3] -> skew matrices [...,3,3]."""
    ox, oy, oz = jnp.moveaxis(omega, -1, 0)
    zero = jnp.zeros_like(ox)
    m = jnp.stack([zero, -oz, oy, oz, zero, -ox, -oy, ox, zero], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype)


def se3(q, t):
    return jnp.concatenate([q, t], axis=-1)


def se3_q(T):
    return T[..., :4]


def se3_t(T):
    return T[..., 4:7]


def se3_apply(T, x):
    """Apply [...,7] to points [...,3]."""
    return quat_rotate(T[..., :4], x) + T[..., 4:7]


def se3_compose(A, B):
    """A after B:  (A*B) @ x = A @ (B @ x)."""
    q = quat_mul(A[..., :4], B[..., :4])
    t = quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    return se3(quat_normalize(q), t)


def se3_inverse(T):
    qi = quat_conj(T[..., :4])
    return se3(qi, -quat_rotate(qi, T[..., 4:7]))


def _so3_left_jacobian(omega):
    """V matrix of SE(3) exp: t = V v.  [...,3] -> [...,3,3]."""
    theta = _safe_norm(omega)
    th2 = theta * theta
    small = theta < 1e-5
    A = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(th2, _EPS))
    B = jnp.where(
        small, 1.0 / 6.0 - th2 / 120.0, (theta - jnp.sin(theta)) / jnp.maximum(th2 * theta, _EPS)
    )
    W = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def se3_exp(tau):
    """Tangent [...,6]=(omega,v) -> SE(3) [...,7]."""
    omega, v = tau[..., :3], tau[..., 3:6]
    q = so3_exp(omega)
    V = _so3_left_jacobian(omega)
    t = jnp.einsum("...ij,...j->...i", V, v)
    return se3(q, t)


def se3_log(T):
    """SE(3) [...,7] -> tangent [...,6]=(omega,v)."""
    omega = so3_log(T[..., :4])
    V = _so3_left_jacobian(omega)
    v = jnp.linalg.solve(V, T[..., 4:7, None])[..., 0]
    return jnp.concatenate([omega, v], axis=-1)


def se3_to_matrix(T):
    R = quat_to_matrix(T[..., :4])
    t = T[..., 4:7]
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), top.shape[:-2] + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def se3_from_matrix(M):
    return se3(quat_from_matrix(M[..., :3, :3]), M[..., :3, 3])


def se3_retract(T, tau):
    """Left-multiplicative update exp(tau) * T — the LM update used by the
    optimizers (reference analogue: g2o VertexSE3Expmap oplus)."""
    return se3_compose(se3_exp(tau), T)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def sim3_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0, 0, 0, 0, 0, 0, 0.0], dtype=dtype)


def sim3_make(q, t, scale):
    """Build from rotation quat, translation, *linear* scale."""
    return jnp.concatenate([q, t, jnp.log(scale)[..., None]], axis=-1)


def sim3_scale(S):
    return jnp.exp(S[..., 7])


def sim3_apply(S, x):
    return sim3_scale(S)[..., None] * quat_rotate(S[..., :4], x) + S[..., 4:7]


def sim3_compose(A, B):
    """(A*B) @ x = A @ (B @ x)."""
    q = quat_normalize(quat_mul(A[..., :4], B[..., :4]))
    t = sim3_scale(A)[..., None] * quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    log_s = A[..., 7] + B[..., 7]
    return jnp.concatenate([q, t, log_s[..., None]], axis=-1)


def sim3_inverse(S):
    qi = quat_conj(S[..., :4])
    inv_s = jnp.exp(-S[..., 7])
    t = -inv_s[..., None] * quat_rotate(qi, S[..., 4:7])
    return jnp.concatenate([qi, t, -S[..., 7:8]], axis=-1)


def sim3_from_se3(T, scale=1.0):
    log_s = jnp.full(T.shape[:-1] + (1,), jnp.log(scale), dtype=T.dtype)
    return jnp.concatenate([T, log_s], axis=-1)


def sim3_to_se3(S):
    """Drop the scale (keep rotation+translation)."""
    return S[..., :7]


def sim3_exp(tau):
    """Tangent [...,7]=(omega,v,sigma) -> Sim(3) [...,8].

    Uses the closed-form Sim(3) exponential (W matrix with scale terms).
    """
    omega, v, sigma = tau[..., :3], tau[..., 3:6], tau[..., 6]
    q = so3_exp(omega)
    theta = _safe_norm(omega)
    s = jnp.exp(sigma)

    W = hat(omega)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=tau.dtype), W.shape)

    th2 = theta * theta
    sig2 = sigma * sigma
    small_sig = jnp.abs(sigma) < 1e-5
    small_th = theta < 1e-5

    # coefficients of W-matrix:  Wm = A*eye + B*W + C*W2  with
    #   A = (s-1)/sigma
    #   B = (sigma*(1-s*cos th) + s*sin th*theta) / (theta*(sig2+th2))   [general]
    #   C = ... ; guarded Taylor limits below.
    A = jnp.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0, (s - 1.0) / jnp.where(small_sig, 1.0, sigma))

    denom = (sig2 + th2) * jnp.maximum(theta, _EPS)
    sin_th, cos_th = jnp.sin(theta), jnp.cos(theta)

    # general branch (Ethan Eade, "Lie groups for 2D and 3D transformations"):
    #   B = (a*sigma + (1-b)*theta) / (theta*(sig2+th2))   with a = s*sin th, b = s*cos th
    a_ = s * sin_th
    b_ = s * cos_th
    B_gen = (a_ * sigma + (1.0 - b_) * theta) / jnp.maximum(denom, _EPS)
    C_gen = (A - ((b_ - 1.0) * sigma + a_ * theta) / jnp.maximum(sig2 + th2, _EPS)) / jnp.maximum(th2, _EPS)

    # sigma -> 0 limits: B -> (1-cos th)/th2, C -> (th - sin th)/th^3
    B_sig0 = jnp.where(small_th, 0.5 - th2 / 24.0, (1.0 - cos_th) / jnp.maximum(th2, _EPS))
    C_sig0 = jnp.where(
        small_th, 1.0 / 6.0 - th2 / 120.0, (theta - sin_th) / jnp.maximum(th2 * theta, _EPS)
    )
    # theta -> 0 limits: B -> ((sigma-1)*s+1)/sig2, C -> (s*(sig2/2 - sigma + 1) - 1)/ sig2? use
    B_th0 = jnp.where(
        small_sig, 0.5 + sigma / 6.0, ((sigma - 1.0) * s + 1.0) / jnp.maximum(sig2, _EPS)
    )
    C_th0 = jnp.where(
        small_sig,
        1.0 / 6.0 + sigma / 24.0,
        (s * (0.5 * sig2 - sigma + 1.0) - 1.0) / jnp.maximum(sig2 * sigma, _EPS),
    )

    B = jnp.where(small_th, B_th0, jnp.where(small_sig, B_sig0, B_gen))
    C = jnp.where(small_th, C_th0, jnp.where(small_sig, C_sig0, C_gen))

    Wm = A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", Wm, v)
    return jnp.concatenate([q, t, sigma[..., None]], axis=-1)


def sim3_log(S):
    """Sim(3) [...,8] -> tangent [...,7] via solving t = Wm v (3x3 solve)."""
    omega = so3_log(S[..., :4])
    sigma = S[..., 7]
    tau_rot = jnp.concatenate([omega, jnp.zeros_like(S[..., 4:7]), sigma[..., None]], axis=-1)
    # Recover Wm from sim3_exp internals by re-running with unit v basis:
    e = jnp.broadcast_to(jnp.eye(3, dtype=S.dtype), S.shape[:-1] + (3, 3))
    cols = jax.vmap(lambda ei: sim3_exp(
        jnp.concatenate([omega, ei, sigma[..., None]], axis=-1))[..., 4:7], in_axes=-2, out_axes=-1)(e)
    Wm = cols  # [...,3,3] with columns Wm @ e_i
    v = jnp.linalg.solve(Wm, S[..., 4:7, None])[..., 0]
    return jnp.concatenate([omega, v, sigma[..., None]], axis=-1)


def sim3_retract(S, tau):
    return sim3_compose(sim3_exp(tau), S)
