"""PnP: camera pose from 2D-3D matches via DLT-RANSAC + LM refinement.

JAX equivalent of the reference's MLPnPsolver
(/root/reference/src/rumi-slam/lib_src/MLPnPsolver.cpp, used only by
Tracking::Relocalization at Tracking.cc:3232-3255).  Re-designed as vmapped
fixed-iteration RANSAC over 6-point DLT hypotheses, with the winning pose
polished by motion-only BA (optim.pose_opt) — the same refine step the
reference runs after MLPnP.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera, lie
from . import pose_opt


class PnPResult(NamedTuple):
    pose: jnp.ndarray       # [7] T_cw
    inliers: jnp.ndarray    # [N] bool
    n_inliers: jnp.ndarray
    ok: jnp.ndarray


def _dlt_pose(X, rays):
    """P from 6+ points: rays ~ P [X;1].  X [M,3], rays [M,3] (z=1 coords).

    Returns T_cw [7] (orthogonalized).
    """
    x = rays[:, 0] / rays[:, 2]
    y = rays[:, 1] / rays[:, 2]
    Xh = jnp.concatenate([X, jnp.ones_like(X[:, :1])], axis=-1)  # [M,4]
    zeros = jnp.zeros_like(Xh)
    r1 = jnp.concatenate([Xh, zeros, -x[:, None] * Xh], axis=-1)
    r2 = jnp.concatenate([zeros, Xh, -y[:, None] * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=0)  # [2M,12]
    _, V = jnp.linalg.eigh(A.T @ A)
    P = V[:, 0].reshape(3, 4)
    M = P[:, :3]
    # scale/sign: proper rotation closest to M via SVD
    U, S, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]).at[2].set(jnp.sign(det)))
    R = U @ D @ Vt
    scale = jnp.sum(S * jnp.diag(D)) / 3.0
    t = P[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    return lie.se3(lie.quat_from_matrix(R), t)


@partial(jax.jit, static_argnames=("n_hyp",))
def pnp_ransac(
    key,
    K,
    X_w,
    uv,
    valid,
    *,
    quality=None,
    n_hyp: int = 1024,
    reproj_thresh: float = 5.0,
    min_inliers: int = 15,
):
    """Robust pose from world points + pixel observations.

    The winning DLT hypothesis may have the wrong cheirality sign; both signs
    of t-scale are scored via positive-depth counting inside the DLT already.

    ``quality``: optional [N] sampling weight (larger = more trustworthy,
    e.g. ``max_hamming - match_distance``).  Relocalization inputs routinely
    run at 15-30% inlier fraction — a uniformly drawn 6-point DLT sample is
    then almost never clean (0.2^6), but correct matches concentrate at low
    descriptor distance, so guided sampling recovers tractable odds (the
    PROSAC idea; the reference's MLPnPsolver instead leans on per-candidate
    adaptive iteration counts, MLPnPsolver.cpp RANSAC loop).  ``n_hyp``
    defaults high (1024): per-hypothesis success runs far below the naive
    inlier-rate^6 because 6-point DLT poses from noisy-depth maps are sloppy
    even when every sample row is a true match; the whole batch is one vmap,
    so hypotheses are nearly free on the device.
    """
    n = X_w.shape[0]
    rays = camera.unproject(K, uv)

    w = valid.astype(jnp.float32)
    if quality is not None:
        w = w * jnp.maximum(quality, 1e-3)
    probs = jnp.log(jnp.maximum(w, 1e-12))
    idx = jax.random.categorical(key, probs[None, :].repeat(n_hyp * 6, 0)).reshape(
        n_hyp, 6
    )

    poses = jax.vmap(lambda ii: _dlt_pose(X_w[ii], rays[ii]))(idx)  # [H,7]

    def score(T):
        pc = lie.se3_apply(T, X_w)
        err = jnp.linalg.norm(camera.project(K, pc) - uv, axis=-1)
        return jnp.sum((err < reproj_thresh) & (pc[:, 2] > 0.01) & valid)

    scores = jax.vmap(score)(poses)
    best = jnp.argmax(scores)
    pose0 = poses[best]

    # polish ONLY on the winner's consensus set: at high outlier fractions
    # the IRLS refinement cannot be seeded with every match — the Huber
    # basin is narrower than the contamination
    pc0 = lie.se3_apply(pose0, X_w)
    err0 = jnp.linalg.norm(camera.project(K, pc0) - uv, axis=-1)
    consensus = valid & (err0 < reproj_thresh) & (pc0[:, 2] > 0.01)
    res = pose_opt.pose_optimization(K, pose0, X_w, uv, consensus)
    ok = res.n_inliers >= min_inliers
    return PnPResult(pose=res.pose, inliers=res.inliers, n_inliers=res.n_inliers, ok=ok)
