"""Two-view triangulation and epipolar helpers (batched, pure JAX).

JAX equivalent of the reference's GeometricTools
(/root/reference/src/rumi-slam/lib_src/GeometricTools.cc:1-68 — SVD DLT
triangulation, fundamental-from-poses) used by LocalMapping::CreateNewMapPoints
and TwoViewReconstruction.  Batched over trailing axes with ``vmap``-free
broadcasting; degenerate inputs return garbage guarded by the returned masks.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import lie


def triangulate_dlt(T1_cw, T2_cw, ray1, ray2):
    """DLT triangulation from two normalized rays.

    Args:
      T1_cw, T2_cw: [...,7] world->camera poses.
      ray1, ray2:   [...,3] normalized camera rays (z=1 plane coords ok).
    Returns:
      X_w [...,3] world points (homogeneous-normalized; invalid if w ~ 0).
    """
    P1 = lie.se3_to_matrix(T1_cw)[..., :3, :]  # [...,3,4]
    P2 = lie.se3_to_matrix(T2_cw)[..., :3, :]

    def rows(P, ray):
        x = ray[..., 0] / ray[..., 2]
        y = ray[..., 1] / ray[..., 2]
        r0 = x[..., None] * P[..., 2, :] - P[..., 0, :]
        r1 = y[..., None] * P[..., 2, :] - P[..., 1, :]
        return r0, r1

    a0, a1 = rows(P1, ray1)
    a2, a3 = rows(P2, ray2)
    A = jnp.stack([a0, a1, a2, a3], axis=-2)  # [...,4,4]
    # Smallest right singular vector (SVD of A, not eigh of A^T A — squaring
    # the condition number is too lossy in float32 for distant points).
    _, _, Vt = jnp.linalg.svd(A)
    Xh = Vt[..., 3, :]
    w = Xh[..., 3]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / w_safe[..., None]


def triangulation_checks(
    K, T1_cw, T2_cw, uv1, uv2, X_w, *, min_parallax_cos=0.99998, max_reproj_err=2.0
):
    """Cheirality + parallax + reprojection gating, mirroring the checks in
    the reference's LocalMapping::CreateNewMapPoints
    (/root/reference/src/rumi-slam/lib_src/LocalMapping.cc:354-648).

    Returns boolean mask [...] of acceptable points.
    """
    from . import camera

    x1 = lie.se3_apply(T1_cw, X_w)
    x2 = lie.se3_apply(T2_cw, X_w)
    pos_depth = (x1[..., 2] > 0.05) & (x2[..., 2] > 0.05)

    c1 = lie.se3_t(lie.se3_inverse(T1_cw))
    c2 = lie.se3_t(lie.se3_inverse(T2_cw))
    d1 = X_w - c1
    d2 = X_w - c2
    n1 = jnp.linalg.norm(d1, axis=-1)
    n2 = jnp.linalg.norm(d2, axis=-1)
    cos_par = jnp.sum(d1 * d2, axis=-1) / jnp.maximum(n1 * n2, 1e-12)
    parallax_ok = cos_par < min_parallax_cos

    e1 = jnp.linalg.norm(camera.project(K, x1) - uv1, axis=-1)
    e2 = jnp.linalg.norm(camera.project(K, x2) - uv2, axis=-1)
    reproj_ok = (e1 < max_reproj_err) & (e2 < max_reproj_err)

    return pos_depth & parallax_ok & reproj_ok


def essential_from_poses(T1_cw, T2_cw):
    """E_12 such that ray2^T E ray1 = 0 for corresponding rays."""
    T21 = lie.se3_compose(T2_cw, lie.se3_inverse(T1_cw))
    R = lie.quat_to_matrix(T21[..., :4])
    t = T21[..., 4:7]
    return lie.hat(t) @ R
