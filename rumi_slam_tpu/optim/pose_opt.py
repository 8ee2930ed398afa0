"""Motion-only bundle adjustment: one SE(3) pose vs fixed 3D points.

JAX equivalent of the reference's Optimizer::PoseOptimization
(/root/reference/src/rumi-slam/lib_src/Optimizer.cc:723-1000): a unary-edge LM
problem solved 4 rounds x fixed iterations with chi-square outlier
re-classification between rounds (chi2 5.991 for mono) — here as one jitted
``lax.scan`` over rounds with masked observations instead of edge
removal/level switching.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera, lie
from . import robust

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    pose: jnp.ndarray     # [7]
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray  # scalar int32
    cost: jnp.ndarray     # scalar


def _normal_equations(K, pose, X, uv, w, inv_sigma2):
    r, J, _, depth = camera.reproj_residual_and_jacobians(K, pose, X, uv)
    chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    w_rob = robust.huber_weight(chi2, CHI2_MONO) * inv_sigma2
    ww = w * w_rob * (depth > 0.05)
    H = jnp.einsum("nki,n,nkj->ij", J, ww, J)
    g = jnp.einsum("nki,n,nk->i", J, ww, r)
    cost = jnp.sum(w * robust.huber_cost(chi2, CHI2_MONO))
    return H, g, cost, chi2


@partial(jax.jit, static_argnames=("n_rounds", "n_iters"))
def pose_optimization(
    K,
    pose0,
    X_w,
    uv,
    valid,
    inv_sigma2=None,
    *,
    n_rounds: int = 4,
    n_iters: int = 10,
):
    """Optimize a single camera pose against fixed world points.

    Args:
      K: [4] intrinsics.
      pose0: [7] initial T_cw.
      X_w: [N,3] fixed world points.
      uv: [N,2] observations.
      valid: [N] bool — observation usable at all.
      inv_sigma2: [N] per-observation information (octave-dependent in the
        reference: 1/sigma^2 per pyramid level); None = 1.

    Returns PoseOptResult.  ``inliers`` reproduces the reference's final
    outlier classification (chi2 <= 5.991 at the final pose).
    """
    n = X_w.shape[0]
    if inv_sigma2 is None:
        inv_sigma2 = jnp.ones((n,), jnp.float32)
    w0 = valid.astype(jnp.float32)

    def lm_iters(pose, w):
        def body(carry, _):
            pose, lam, cost_prev = carry
            H, g, cost, _ = _normal_equations(K, pose, X_w, uv, w, inv_sigma2)
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
            tau = -jnp.linalg.solve(Hd, g)
            cand = lie.se3_retract(pose, tau)
            _, _, cost_new, _ = _normal_equations(K, cand, X_w, uv, w, inv_sigma2)
            accept = cost_new < cost
            pose = jnp.where(accept, cand, pose)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            return (pose, jnp.clip(lam, 1e-8, 1e6), jnp.where(accept, cost_new, cost)), None

        (pose, _, cost), _ = jax.lax.scan(
            body, (pose, jnp.float32(1e-3), jnp.float32(jnp.inf)), None, length=n_iters
        )
        return pose, cost

    def round_body(carry, _):
        pose, w = carry
        pose, cost = lm_iters(pose, w)
        # re-classify outliers at the new pose (reference does chi2 gating
        # between its 4 optimization rounds)
        r, _, _, depth = camera.reproj_residual_and_jacobians(K, pose, X_w, uv)
        chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
        w = w0 * ((chi2 <= CHI2_MONO) & (depth > 0.05)).astype(jnp.float32)
        return (pose, w), cost

    (pose, w), costs = jax.lax.scan(
        round_body, (pose0, w0), None, length=n_rounds
    )
    inliers = w > 0
    return PoseOptResult(
        pose=pose,
        inliers=inliers,
        n_inliers=jnp.sum(inliers.astype(jnp.int32)),
        cost=costs[-1],
    )


def _normal_equations_stereo(K, bf, pose, X, uv, ur, w, inv_sigma2):
    """3-row residual variant: the u_r row is zero-weighted where ur < 0
    (mono observation), reproducing the reference's mixed mono+stereo edge
    sets (Optimizer.cc:723-1000 stereo branch, chi2 7.815)."""
    has_ur = ur >= 0
    r, J, _, depth = camera.reproj_residual_and_jacobians_stereo(
        K, bf, pose, X, uv, jnp.maximum(ur, 0.0))
    row_w = jnp.concatenate(
        [jnp.ones_like(ur)[:, None].repeat(2, axis=1), has_ur[:, None].astype(jnp.float32)],
        axis=1,
    )
    chi2 = jnp.sum(r * r * row_w, axis=-1) * inv_sigma2
    th = jnp.where(has_ur, CHI2_STEREO, CHI2_MONO)
    w_rob = robust.huber_weight(chi2, th) * inv_sigma2
    ww = w * w_rob * (depth > 0.05)
    Jw = J * row_w[:, :, None]
    H = jnp.einsum("nki,n,nkj->ij", Jw, ww, J)
    g = jnp.einsum("nki,n,nk->i", Jw, ww, r)
    cost = jnp.sum(w * robust.huber_cost(chi2, th))
    return H, g, cost, chi2, depth


@partial(jax.jit, static_argnames=("n_rounds", "n_iters"))
def pose_optimization_stereo(
    K,
    bf,
    pose0,
    X_w,
    uv,
    ur,
    valid,
    inv_sigma2=None,
    *,
    n_rounds: int = 4,
    n_iters: int = 10,
):
    """Stereo/RGB-D motion-only BA: like :func:`pose_optimization`, with a
    third residual row u_r = u - bf/z on observations where ``ur >= 0``."""
    n = X_w.shape[0]
    if inv_sigma2 is None:
        inv_sigma2 = jnp.ones((n,), jnp.float32)
    w0 = valid.astype(jnp.float32)
    has_ur = ur >= 0
    th = jnp.where(has_ur, CHI2_STEREO, CHI2_MONO)

    def lm_iters(pose, w):
        def body(carry, _):
            pose, lam, cost_prev = carry
            H, g, cost, _, _ = _normal_equations_stereo(
                K, bf, pose, X_w, uv, ur, w, inv_sigma2)
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
            tau = -jnp.linalg.solve(Hd, g)
            cand = lie.se3_retract(pose, tau)
            _, _, cost_new, _, _ = _normal_equations_stereo(
                K, bf, cand, X_w, uv, ur, w, inv_sigma2)
            accept = cost_new < cost
            pose = jnp.where(accept, cand, pose)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            return (pose, jnp.clip(lam, 1e-8, 1e6),
                    jnp.where(accept, cost_new, cost)), None

        (pose, _, cost), _ = jax.lax.scan(
            body, (pose, jnp.float32(1e-3), jnp.float32(jnp.inf)), None,
            length=n_iters)
        return pose, cost

    def round_body(carry, _):
        pose, w = carry
        pose, cost = lm_iters(pose, w)
        _, _, _, chi2, depth = _normal_equations_stereo(
            K, bf, pose, X_w, uv, ur, w, inv_sigma2)
        w = w0 * ((chi2 <= th) & (depth > 0.05)).astype(jnp.float32)
        return (pose, w), cost

    (pose, w), costs = jax.lax.scan(
        round_body, (pose0, w0), None, length=n_rounds)
    inliers = w > 0
    return PoseOptResult(
        pose=pose,
        inliers=inliers,
        n_inliers=jnp.sum(inliers.astype(jnp.int32)),
        cost=costs[-1],
    )
