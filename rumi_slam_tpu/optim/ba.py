"""Bundle adjustment: Levenberg-Marquardt with Schur-complement camera/point
elimination, fully batched in JAX.

JAX replacement for the reference's g2o problems — Optimizer::
BundleAdjustment (/root/reference/src/rumi-slam/lib_src/Optimizer.cc:54),
LocalBundleAdjustment (:1003, welding overload :3768) and the BlockSolver_6_3
Schur machinery (Thirdparty/g2o/g2o/core/block_solver.h).  One engine serves
local, global, and welding BA; the caller chooses which cameras/points are
free (the reference's "fixed cameras" boundary ring) via masks.

Problem layout (SoA, static shapes):
  poses   [C, 7]   SE(3) T_cw per camera
  points  [P, 3]   world points
  cam_idx [O]      observation -> camera row
  pt_idx  [O]      observation -> point row (invalid obs: conf == 0)
  uv      [O, 2]   measured pixels
  conf    [O]      information weight (0 disables; octave inv_sigma2 here)

Math per LM iteration (all einsum/segment_sum — batched and fusable):
  Hcc  = sum_o w Jc^T Jc          (block-diag [C,6,6])
  Hpp  = sum_o w Jp^T Jp          ([P,3,3], closed-form 3x3 inverse)
  W    = scatter of w Jc^T Jp     ([P,C,6,3] dense cross blocks)
  S    = Hcc - W Hpp^-1 W^T       (reduced camera system, dense [6C,6C])
  dxc  = solve(S, -bc + W Hpp^-1 bp);  dxp = Hpp^-1 (-bp - W^T dxc)

The dense [P,C,6,3] cross-block tensor bounds the memory envelope to
P*C*72 bytes — callers window the problem (local BA) or shard it
(parallel/sharded_ba.py performs the same reduction with psum over NVLink).
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


class BAResult(NamedTuple):
    poses: jnp.ndarray    # [C,7]
    points: jnp.ndarray   # [P,3]
    cost: jnp.ndarray     # final robust cost
    inlier_obs: jnp.ndarray  # [O] bool — chi2 gate at final estimate


def _inv3x3(M):
    """Batched closed-form 3x3 inverse with singularity guard -> 0 matrix."""
    a = M[..., 0, 0]; b = M[..., 0, 1]; c = M[..., 0, 2]
    d = M[..., 1, 0]; e = M[..., 1, 1]; f = M[..., 1, 2]
    g = M[..., 2, 0]; h = M[..., 2, 1]; i = M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    ok = jnp.abs(det) > 1e-10
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    adj = jnp.stack(
        [
            A, -(b * i - c * h), (b * f - c * e),
            B, (a * i - c * g), -(a * f - c * d),
            C, -(a * h - b * g), (a * e - b * d),
        ],
        axis=-1,
    ).reshape(M.shape)
    return adj * inv_det[..., None, None]


def _problem_terms(K, poses, points, cam_idx, pt_idx, uv, conf, bf=None,
                   ur=None):
    """Residuals/Jacobians/IRLS weights per observation.

    With ``bf``/``ur`` given, observations where ur >= 0 get the 3-row
    stereo residual (u, v, u_r) and the stereo chi2 gate — the reference's
    mixed mono+stereo edge sets in every BA problem (Optimizer.cc:54/:1003
    stereo branches); rows with ur < 0 zero-weight the third row.
    """
    pose_o = poses[cam_idx]
    X_o = points[pt_idx]
    if ur is None:
        r, Jc, Jp, depth = camera.reproj_residual_and_jacobians(
            K, pose_o, X_o, uv)
        chi2 = jnp.sum(r * r, axis=-1) * conf
        th = CHI2_MONO
    else:
        has_ur = ur >= 0
        r, Jc, Jp, depth = camera.reproj_residual_and_jacobians_stereo(
            K, bf, pose_o, X_o, uv, jnp.maximum(ur, 0.0))
        row_w = jnp.concatenate(
            [jnp.ones_like(ur)[:, None].repeat(2, axis=1),
             has_ur[:, None].astype(jnp.float32)], axis=1)
        r = r * row_w
        Jc = Jc * row_w[:, :, None]
        Jp = Jp * row_w[:, :, None]
        chi2 = jnp.sum(r * r, axis=-1) * conf
        th = jnp.where(has_ur, CHI2_STEREO, CHI2_MONO)
    w = conf * robust.huber_weight(chi2, th) * (depth > 0.05)
    cost = jnp.sum(jnp.where(conf > 0, robust.huber_cost(chi2, th), 0.0))
    return r, Jc, Jp, w, cost, chi2


def _solve_step(K, poses, points, cam_idx, pt_idx, uv, conf, cam_free, pt_free,
                lam, bf=None, ur=None):
    C, P = poses.shape[0], points.shape[0]
    r, Jc, Jp, w, _, _ = _problem_terms(K, poses, points, cam_idx, pt_idx, uv,
                                        conf, bf, ur)

    Hcc = jax.ops.segment_sum(
        jnp.einsum("oki,o,okj->oij", Jc, w, Jc), cam_idx, num_segments=C
    )
    bc = jax.ops.segment_sum(jnp.einsum("oki,o,ok->oi", Jc, w, r), cam_idx, num_segments=C)
    Hpp = jax.ops.segment_sum(
        jnp.einsum("oki,o,okj->oij", Jp, w, Jp), pt_idx, num_segments=P
    )
    bp = jax.ops.segment_sum(jnp.einsum("oki,o,ok->oi", Jp, w, r), pt_idx, num_segments=P)

    # LM damping on both diagonals
    Hcc_d = Hcc + lam * jnp.eye(6) * jnp.maximum(
        jnp.trace(Hcc, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
    )
    Hpp_d = Hpp + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(Hpp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    )

    Hpp_inv = _inv3x3(Hpp_d) * pt_free[:, None, None]

    # cross blocks: W[p, c] = sum_{obs (c,p)} w Jc^T Jp   [P, C, 6, 3]
    Wblk = jnp.zeros((P, C, 6, 3), poses.dtype).at[pt_idx, cam_idx].add(
        jnp.einsum("oki,o,okj->oij", Jc, w, Jp)
    )

    Y = jnp.einsum("pcij,pjk->pcik", Wblk, Hpp_inv)          # W Hpp^-1
    S_corr = jnp.einsum("pcik,pdmk->cidm", Y, Wblk)          # [C,6,C,6]
    S = -S_corr
    diag = jnp.arange(C)
    S = S.at[diag, :, diag, :].add(Hcc_d)
    b_red = bc - jnp.einsum("pcik,pk->ci", Y, bp)            # [C,6]

    # fixed cameras: identity rows/cols, zero rhs
    free = cam_free.astype(poses.dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S.at[diag, :, diag, :].add(
        jnp.eye(6) * (1.0 - free)[:, None, None]
    )
    b_red = b_red * free[:, None]

    Sd = S.reshape(C * 6, C * 6) + 1e-8 * jnp.eye(C * 6)
    dxc = -jnp.linalg.solve(Sd, b_red.reshape(C * 6)).reshape(C, 6)
    dxc = dxc * cam_free[:, None]

    # back-substitution for points
    t_p = jnp.einsum("pcik,ci->pk", Wblk, dxc)               # W^T dxc
    dxp = -jnp.einsum("pij,pj->pi", Hpp_inv, bp + t_p)
    dxp = dxp * pt_free[:, None]

    new_poses = lie.se3_retract(poses, dxc)
    new_points = points + dxp
    return new_poses, new_points


@partial(jax.jit, static_argnames=("n_iters",))
def bundle_adjust(
    K,
    poses,
    points,
    cam_idx,
    pt_idx,
    uv,
    conf,
    cam_free,
    pt_free,
    *,
    n_iters: int = 10,
    bf=None,
    ur=None,
) -> BAResult:
    """Run LM bundle adjustment; see module docstring for the layout.

    Optional stereo: pass ``bf`` (fx*baseline) and per-observation ``ur``
    (virtual right u; < 0 = mono row) to add the u_r residual row.
    """
    cam_free = cam_free.astype(bool)
    pt_free = pt_free.astype(bool)
    cam_idx = jnp.clip(cam_idx, 0, poses.shape[0] - 1)
    pt_idx = jnp.clip(pt_idx, 0, points.shape[0] - 1)

    def body(carry, _):
        poses, points, lam = carry
        _, _, _, _, cost0, _ = _problem_terms(
            K, poses, points, cam_idx, pt_idx, uv, conf, bf, ur)
        cand_poses, cand_points = _solve_step(
            K, poses, points, cam_idx, pt_idx, uv, conf, cam_free, pt_free,
            lam, bf, ur
        )
        _, _, _, _, cost1, _ = _problem_terms(
            K, cand_poses, cand_points, cam_idx, pt_idx, uv, conf, bf, ur
        )
        accept = cost1 < cost0
        poses = jnp.where(accept, cand_poses, poses)
        points = jnp.where(accept, cand_points, points)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        return (poses, points, lam), cost1

    (poses, points, _), _ = jax.lax.scan(
        body, (poses, points, jnp.float32(1e-4)), None, length=n_iters
    )
    _, _, _, _, cost, chi2 = _problem_terms(
        K, poses, points, cam_idx, pt_idx, uv, conf, bf, ur)
    th = CHI2_MONO if ur is None else jnp.where(ur >= 0, CHI2_STEREO, CHI2_MONO)
    return BAResult(
        poses=poses,
        points=points,
        cost=cost,
        inlier_obs=(chi2 <= th) & (conf > 0),
    )


def marginalize(H, b, start: int, end: int):
    """Schur-complement marginalization of block [start, end) out of a dense
    (H, b) Gauss-Newton system — the reference's Optimizer::Marginalize
    (/root/reference/src/rumi-slam/include/cloud_edge_slam_lib/Optimizer.h:94-96,
    used by its inertial sliding-window optimizers).

    Returns (H', b') of the SAME shape with the marginalized rows/cols zeroed,
    matching the reference's convention.  ``start``/``end`` are static Python
    ints (the caller knows its block layout at trace time).
    """
    n = H.shape[0]
    keep = jnp.ones((n,), bool).at[start:end].set(False)
    Haa = H[start:end, start:end]
    # pseudo-inverse via eigendecomposition: the marginalized block is often
    # rank-deficient (gauge freedom), exactly why the reference uses SVD here
    w, V = jnp.linalg.eigh(0.5 * (Haa + Haa.T))
    inv_w = jnp.where(w > 1e-8 * jnp.max(jnp.abs(w)), 1.0 / w, 0.0)
    Haa_inv = (V * inv_w[None, :]) @ V.T
    Hba = jnp.delete(H, slice(start, end), axis=0, assume_unique_indices=True)[
        :, start:end
    ]
    Hbb = jnp.delete(
        jnp.delete(H, slice(start, end), axis=0, assume_unique_indices=True),
        slice(start, end), axis=1, assume_unique_indices=True,
    )
    ba_ = b[start:end]
    bb = jnp.delete(b, slice(start, end), assume_unique_indices=True)
    Hs = Hbb - Hba @ Haa_inv @ Hba.T
    bs = bb - Hba @ Haa_inv @ ba_
    # scatter back into full-size arrays with zeros at the marginalized block
    idx = jnp.nonzero(keep, size=n - (end - start))[0]
    H_out = jnp.zeros_like(H).at[jnp.ix_(idx, idx)].set(Hs)
    b_out = jnp.zeros_like(b).at[idx].set(bs)
    return H_out, b_out
