"""Kannala-Brandt 8-parameter fisheye camera model.

JAX equivalent of the reference's CameraModels/KannalaBrandt8.cpp
(/root/reference/src/rumi-slam/lib_src/CameraModels/KannalaBrandt8.cpp:1-433):
equidistant projection with a degree-9 odd polynomial in the incidence angle,

    theta   = atan2(sqrt(x^2+y^2), z)
    theta_d = theta + k0 theta^3 + k1 theta^5 + k2 theta^7 + k3 theta^9
    (u, v)  = (fx theta_d x/r + cx,  fy theta_d y/r + cy)

Parameters are a flat ``[8]`` array ``(fx, fy, cx, cy, k0, k1, k2, k3)``.
Unprojection inverts theta_d -> theta with a fixed-iteration Newton solve
(the reference uses an adaptive Newton loop at KannalaBrandt8.cpp:97-124;
a fixed trip count is XLA-friendly and converges to float32 accuracy in
<= 10 steps over the valid FoV).  All functions broadcast over leading
batch axes, mirroring :mod:`rumi_slam_tpu.geometry.camera`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import lie

_EPS = 1e-9
_NEWTON_ITERS = 10


def _theta_d(k, theta):
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def _dtheta_d(k, theta):
    t2 = theta * theta
    return 1.0 + t2 * (3.0 * k[0] + t2 * (5.0 * k[1] + t2 * (7.0 * k[2] + t2 * 9.0 * k[3])))


def project(P, x_cam):
    """Camera-frame points [...,3] -> fisheye pixels [...,2]."""
    fx, fy, cx, cy = P[0], P[1], P[2], P[3]
    k = P[4:8]
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(r, z)
    td = _theta_d(k, theta)
    # x/r, y/r with on-axis guard (r -> 0 means theta -> 0, td/r -> 1/z limit;
    # the guarded ratio times td -> 0, matching the exact limit u = cx)
    ri = 1.0 / jnp.maximum(r, _EPS)
    u = fx * td * x * ri + cx
    v = fy * td * y * ri + cy
    return jnp.stack([u, v], axis=-1)


def unproject(P, uv, depth=None):
    """Fisheye pixels [...,2] -> unit-z rays [...,3] (optionally scaled so
    that the ray's z equals ``depth``)."""
    fx, fy, cx, cy = P[0], P[1], P[2], P[3]
    k = P[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    td = jnp.sqrt(mx * mx + my * my)  # = theta_d
    td = jnp.clip(td, 0.0, jnp.pi)    # reference clamps to FoV (KB8.cpp:101)

    def newton(_, theta):
        f = _theta_d(k, theta) - td
        return theta - f / jnp.maximum(_dtheta_d(k, theta), _EPS)

    theta = jax.lax.fori_loop(0, _NEWTON_ITERS, newton, td)
    scale = jnp.where(td < _EPS, 1.0, jnp.tan(theta) / jnp.maximum(td, _EPS))
    ray = jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)
    if depth is not None:
        ray = ray * depth[..., None]
    return ray


def project_jacobian_point(P, x_cam):
    """Analytic d(uv)/d(x_cam): [...,2,3] (KannalaBrandt8.cpp projectJac)."""
    fx, fy = P[0], P[1]
    k = P[4:8]
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(r2)
    rs = jnp.maximum(r, _EPS)
    rho2 = r2 + z * z
    theta = jnp.arctan2(r, z)
    td = _theta_d(k, theta)
    dtd = _dtheta_d(k, theta)

    # d theta / d(x,y,z)
    dth_dx = x * z / (rs * rho2)
    dth_dy = y * z / (rs * rho2)
    dth_dz = -r / rho2
    # d (x/r) / d(x,y):  y^2/r^3, -xy/r^3   (and symmetric for y/r)
    r3i = 1.0 / (rs * rs * rs)
    dxr_dx = y * y * r3i
    dxr_dy = -x * y * r3i
    dyr_dy = x * x * r3i

    xr = x / rs
    yr = y / rs
    du_dx = fx * (dtd * dth_dx * xr + td * dxr_dx)
    du_dy = fx * (dtd * dth_dy * xr + td * dxr_dy)
    du_dz = fx * dtd * dth_dz * xr
    dv_dx = fy * (dtd * dth_dx * yr + td * dxr_dy)
    dv_dy = fy * (dtd * dth_dy * yr + td * dyr_dy)
    dv_dz = fy * dtd * dth_dz * yr
    J = jnp.stack([du_dx, du_dy, du_dz, dv_dx, dv_dy, dv_dz], axis=-1)
    return J.reshape(J.shape[:-1] + (2, 3))


def project_world(P, T_cw, X_w):
    """World points through pose: pixels, depth along optical axis."""
    x_cam = lie.se3_apply(T_cw, X_w)
    return project(P, x_cam), x_cam[..., 2]


def reproj_residual_and_jacobians(P, T_cw, X_w, uv_obs):
    """Fisheye analogue of camera.reproj_residual_and_jacobians.

    Same left-multiplicative pose-tangent convention (exp(tau) * T_cw).
    Returns (r [...,2], J_pose [...,2,6], J_point [...,2,3], depth [...]).
    """
    x_cam = lie.se3_apply(T_cw, X_w)
    r = project(P, x_cam) - uv_obs
    Jp = project_jacobian_point(P, x_cam)
    J_omega = -jnp.einsum("...ij,...jk->...ik", Jp, lie.hat(x_cam))
    J_pose = jnp.concatenate([J_omega, Jp], axis=-1)
    R = lie.quat_to_matrix(T_cw[..., :4])
    J_point = jnp.einsum("...ij,...jk->...ik", Jp, R)
    return r, J_pose, J_point, x_cam[..., 2]


def epipolar_error(P1, P2, uv1, uv2, T_21):
    """Ray-based epipolar residual for fisheye pairs.

    The reference checks fisheye epipolar consistency by unprojecting both
    pixels to rays and evaluating the essential constraint
    (KannalaBrandt8.cpp epipolarConstrain -> TriangulateMatches).  ``T_21``
    maps cam1 coordinates to cam2 (x2 = R x1 + t).  Returns |r2^T E r1|
    per pair, with E = hat(t) R.
    """
    r1 = unproject(P1, uv1)
    r2 = unproject(P2, uv2)
    R12 = lie.quat_to_matrix(T_21[..., :4])
    E = lie.hat(T_21[..., 4:7]) @ R12
    Er1 = jnp.einsum("ij,...j->...i", E, r1)
    return jnp.abs(jnp.einsum("...i,...i->...", r2, Er1))
