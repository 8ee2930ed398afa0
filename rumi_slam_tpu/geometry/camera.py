"""Pinhole camera model: projection, unprojection, analytic Jacobians.

JAX equivalent of the reference's CameraModels/Pinhole.cpp
(/root/reference/src/rumi-slam/lib_src/CameraModels/Pinhole.cpp:1-168).
Intrinsics are a flat ``[4]`` array ``(fx, fy, cx, cy)``; all functions
broadcast over leading batch axes.  Distortion is handled at the host edge
(keypoints are undistorted once after extraction, as the reference does in
Frame::UndistortKeyPoints) so the compiled pipeline only ever sees an ideal
pinhole.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import lie


def project(K, x_cam):
    """Camera-frame points [...,3] -> pixels [...,2].  No validity check."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    z = x_cam[..., 2]
    zi = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * x_cam[..., 0] * zi + cx
    v = fy * x_cam[..., 1] * zi + cy
    return jnp.stack([u, v], axis=-1)


def unproject(K, uv, depth=None):
    """Pixels [...,2] (+ optional depth [...]) -> camera-frame rays/points [...,3]."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    ray = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    if depth is not None:
        ray = ray * depth[..., None]
    return ray


def project_jacobian_point(K, x_cam):
    """d(uv)/d(x_cam): [...,2,3]."""
    fx, fy = K[0], K[1]
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    zi = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    zi2 = zi * zi
    zero = jnp.zeros_like(x)
    J = jnp.stack(
        [
            fx * zi, zero, -fx * x * zi2,
            zero, fy * zi, -fy * y * zi2,
        ],
        axis=-1,
    )
    return J.reshape(J.shape[:-1] + (2, 3))


def project_world(K, T_cw, X_w):
    """World points through pose: pixels, depth."""
    x_cam = lie.se3_apply(T_cw, X_w)
    return project(K, x_cam), x_cam[..., 2]


def reproj_residual_and_jacobians(K, T_cw, X_w, uv_obs):
    """Residual r = project(T X) - uv and its Jacobians.

    Returns (r [...,2], J_pose [...,2,6], J_point [...,2,3], depth [...]).

    Pose tangent convention: left-multiplicative update ``exp(tau) * T_cw``
    with tau = (omega, v), matching :func:`lie.se3_retract`.  For that update,
    with xc = T_cw @ X:  d(xc)/d(tau) = [ -hat(xc) | I ].
    """
    x_cam = lie.se3_apply(T_cw, X_w)
    r = project(K, x_cam) - uv_obs
    Jp = project_jacobian_point(K, x_cam)  # [...,2,3] d uv / d x_cam
    # d x_cam / d omega = -hat(x_cam);  d x_cam / d v = I
    J_omega = -jnp.einsum("...ij,...jk->...ik", Jp, lie.hat(x_cam))
    J_pose = jnp.concatenate([J_omega, Jp], axis=-1)  # [...,2,6]
    # d x_cam / d X_w = R
    R = lie.quat_to_matrix(T_cw[..., :4])
    J_point = jnp.einsum("...ij,...jk->...ik", Jp, R)
    return r, J_pose, J_point, x_cam[..., 2]


def reproj_residual_and_jacobians_stereo(K, bf, T_cw, X_w, uv_obs, ur_obs):
    """Stereo (or RGB-D virtual-right) residual: r = [u-û, v-v̂, u_r-û_r]
    with û_r = û - bf/ẑ (reference g2o EdgeStereoSE3ProjectXYZ semantics,
    Optimizer.cc:54/723 stereo edges; bf = fx * baseline).

    ``ur_obs`` rows < 0 denote mono-only observations — the caller masks the
    third residual row (its value is still well-defined here).

    Returns (r [...,3], J_pose [...,3,6], J_point [...,3,3], depth [...]).
    """
    x_cam = lie.se3_apply(T_cw, X_w)
    z = x_cam[..., 2]
    zi = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    uv_hat = project(K, x_cam)
    ur_hat = uv_hat[..., 0] - bf * zi
    r = jnp.concatenate(
        [uv_hat - uv_obs, (ur_hat - ur_obs)[..., None]], axis=-1
    )
    Jp2 = project_jacobian_point(K, x_cam)  # [...,2,3]
    # d û_r / d x_cam = d û / d x_cam + bf/z^2 * e_z
    row_ur = Jp2[..., 0, :] + (bf * zi * zi)[..., None] * jnp.asarray([0.0, 0.0, 1.0])
    Jp = jnp.concatenate([Jp2, row_ur[..., None, :]], axis=-2)  # [...,3,3]
    J_omega = -jnp.einsum("...ij,...jk->...ik", Jp, lie.hat(x_cam))
    J_pose = jnp.concatenate([J_omega, Jp], axis=-1)  # [...,3,6]
    R = lie.quat_to_matrix(T_cw[..., :4])
    J_point = jnp.einsum("...ij,...jk->...ik", Jp, R)
    return r, J_pose, J_point, z
