"""Visual-inertial optimization problem builders.

JAX equivalents of the reference's inertial g2o problems
(/root/reference/src/rumi-slam/lib_src/Optimizer.cc):

* ``inertial_only_optimization``  — InertialOptimization (:3340/:3512/:3664):
  gravity direction + scale + per-KF velocities + one shared bias from
  preintegrated deltas, visual poses held fixed (the IMU-initialization step).
* ``pose_inertial_optimization``  — PoseInertialOptimizationLastKeyFrame /
  LastFrame (:4675/:5031): motion-only optimization of the current frame's
  pose/velocity/bias against reprojection edges plus one inertial edge to the
  (fixed) previous state, with bias random-walk priors.
* ``visual_inertial_ba``          — FullInertialBA (:352) / LocalInertialBA
  (:2745): a temporal KF window with reprojection + inertial + bias-walk
  edges, optimized jointly over poses/velocities/biases and map points.

Design: instead of a sparse g2o graph, each problem is a fixed-shape residual
stack whose Gauss-Newton system is built by ``jax.jacfwd`` (windows are small
— the reference's LocalInertialBA also caps the window at 10 temporal KFs) and
solved densely; map points are updated by batched 3x3 Schur-style point steps
borrowed from optim.ba.  Inertial residuals are whitened by the preintegrated
covariance (Cholesky of the 9x9 information), bias-walk residuals by
``cov_walk`` — the weighting the reference gets from g2o edge information
matrices (EdgeInertial / EdgeGyroRW / EdgeAccRW, G2oTypes.cc).

States are body poses T_wb (hamilton quat + position) + velocity, as in the
inertial literature; the camera extrinsic T_cb maps body to camera for the
reprojection terms (reference ImuCamPose, G2oTypes.cc).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera, lie
from ..optim import robust
from . import preintegration as P

CHI2_MONO = 5.991


def _whiten(cov, eps=1e-6):
    """Cholesky factor W of the information matrix: W^T r is the whitened
    residual (r^T inv(cov) r == |W^T r|^2).

    ``eps`` floors the covariance eigenvalues, capping the information at
    1/eps — necessary in float32 when mixing near-noiseless preintegration
    rows (cov ~ 1e-8) with unit-weight pixel rows in one Gauss-Newton system
    (the reference runs g2o in float64 and does not need this)."""
    n = cov.shape[-1]
    info = jnp.linalg.inv(cov + eps * jnp.eye(n))
    # symmetrize before cholesky for numerical safety
    info = 0.5 * (info + jnp.swapaxes(info, -1, -2))
    return jnp.linalg.cholesky(info)


def _stack_field(pres, name):
    return jnp.stack([getattr(p, name) for p in pres])


def stack_preintegrated(pres: list[P.Preintegrated]) -> P.Preintegrated:
    """Stack a python list of Preintegrated into one batched pytree [E, ...]."""
    bias = P.ImuBias(
        jnp.stack([p.bias.bg for p in pres]), jnp.stack([p.bias.ba for p in pres])
    )
    return P.Preintegrated(
        *(_stack_field(pres, f) for f in P.Preintegrated._fields[:-1]), bias
    )


def _inertial_residual_whitened(pre_i, q_i, p_i, v_i, q_j, p_j, v_j, bias, gravity):
    r = P.inertial_residual(pre_i, q_i, p_i, v_i, q_j, p_j, v_j, bias,
                            gravity=gravity)
    W = _whiten(pre_i.cov)
    return W.T @ r


class InertialInit(NamedTuple):
    """Result of inertial-only optimization (reference InertialOptimization)."""

    scale: jnp.ndarray      # [] visual-to-metric scale
    q_wg: jnp.ndarray       # [4] gravity rotation: g_world = R(q_wg) @ (0,0,-9.81)
    velocities: jnp.ndarray  # [N,3] body velocities in world
    bias: P.ImuBias
    cost: jnp.ndarray


@partial(jax.jit, static_argnames=("n_iters", "fix_scale"))
def inertial_only_optimization(
    q_wb,          # [N,4] visual body orientations (fixed)
    p_wb,          # [N,3] visual body positions, up-to-scale (fixed)
    pres: P.Preintegrated,  # batched [N-1] preintegrated deltas i -> i+1
    *,
    n_iters: int = 20,
    fix_scale: bool = False,
    prior_bias_info: float = 1e2,
) -> InertialInit:
    """Solve gravity direction, scale, velocities, and one shared bias with
    the visual poses fixed — the reference's InertialOptimization
    (Optimizer.cc:3340: VertexGDir + VertexScale + velocity/bias vertices,
    all pose vertices fixed)."""
    N = q_wb.shape[0]
    g0 = P.GRAVITY

    def unpack(theta):
        phi_g = jnp.concatenate([theta[0:2], jnp.zeros(1)])  # yaw unobservable
        log_s = theta[2]
        v = theta[3 : 3 + 3 * N].reshape(N, 3)
        bias = P.ImuBias(theta[3 + 3 * N : 6 + 3 * N], theta[6 + 3 * N : 9 + 3 * N])
        s = jnp.where(fix_scale, 1.0, jnp.exp(log_s))
        return phi_g, s, v, bias

    def residuals(theta):
        phi_g, s, v, bias = unpack(theta)
        g = lie.quat_rotate(lie.so3_exp(phi_g), g0)
        p = s * p_wb

        def edge(i):
            pre_i = jax.tree.map(lambda x: x[i], pres)
            return _inertial_residual_whitened(
                pre_i, q_wb[i], p[i], v[i], q_wb[i + 1], p[i + 1], v[i + 1],
                bias, g,
            )

        r_in = jax.vmap(edge)(jnp.arange(N - 1)).reshape(-1)
        # weak bias prior (reference adds EdgePriorGyro/Acc in init)
        r_b = jnp.sqrt(prior_bias_info) * jnp.concatenate([bias.bg, bias.ba])
        return jnp.concatenate([r_in, r_b])

    theta0 = jnp.zeros(9 + 3 * N)

    def gn_body(carry, _):
        theta, lam = carry
        r = residuals(theta)
        J = jax.jacfwd(residuals)(theta)
        H = J.T @ J
        H = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-6))
        d = -jnp.linalg.solve(H, J.T @ r)
        cand = theta + d
        c0 = jnp.sum(r * r)
        c1 = jnp.sum(residuals(cand) ** 2)
        accept = c1 < c0
        theta = jnp.where(accept, cand, theta)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        return (theta, lam), None

    (theta, _), _ = jax.lax.scan(gn_body, (theta0, jnp.float32(1e-4)), None,
                                 length=n_iters)
    phi_g, s, v, bias = unpack(theta)
    return InertialInit(
        scale=s,
        q_wg=lie.so3_exp(phi_g),
        velocities=v,
        bias=bias,
        cost=jnp.sum(residuals(theta) ** 2),
    )


class PoseVIResult(NamedTuple):
    q_wb: jnp.ndarray
    p_wb: jnp.ndarray
    v: jnp.ndarray
    bias: P.ImuBias
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("n_iters",))
def pose_inertial_optimization(
    K,
    T_cb,            # [7] camera-from-body extrinsic
    # previous (fixed) state:
    q_wb_prev, p_wb_prev, v_prev,
    pre: P.Preintegrated,   # preintegrated prev -> cur
    # current state initial guess:
    q_wb, p_wb, v,
    bias: P.ImuBias,
    # visual edges: world points seen by the current frame
    X_w, uv, valid,
    *,
    n_iters: int = 10,
    gravity=None,
) -> PoseVIResult:
    """Motion-only visual-inertial optimization of the CURRENT frame given a
    fixed previous state — reference PoseInertialOptimizationLastKeyFrame /
    LastFrame (Optimizer.cc:4675/:5031): reprojection edges + EdgeInertial +
    gyro/acc random-walk edges weighted by the preintegration covariances."""
    g = P.GRAVITY if gravity is None else gravity
    W_walk = _whiten(pre.cov_walk)

    def unpack(theta):
        dq = lie.so3_exp(theta[0:3])
        q = lie.quat_normalize(lie.quat_mul(q_wb, dq))
        p = p_wb + theta[3:6]
        vv = v + theta[6:9]
        b = P.ImuBias(bias.bg + theta[9:12], bias.ba + theta[12:15])
        return q, p, vv, b

    def residuals(theta):
        q, p, vv, b = unpack(theta)
        r_in = _inertial_residual_whitened(
            pre, q_wb_prev, p_wb_prev, v_prev, q, p, vv, b, g
        )
        # bias random walk from the linearization bias
        db = jnp.concatenate([b.bg - pre.bias.bg, b.ba - pre.bias.ba])
        r_walk = W_walk.T @ db
        # reprojection (camera pose from body pose)
        T_bw = lie.se3_inverse(lie.se3(q, p))
        T_cw = lie.se3_compose(T_cb, T_bw)
        pc = lie.se3_apply(T_cw, X_w)
        uv_hat = camera.project(K, pc)
        r_uv = uv_hat - uv
        chi2 = jnp.sum(r_uv * r_uv, axis=-1)
        w = jnp.sqrt(
            valid.astype(jnp.float32)
            * robust.huber_weight(chi2, CHI2_MONO)
            * (pc[:, 2] > 0.05)
        )
        return jnp.concatenate([r_in, r_walk, (w[:, None] * r_uv).reshape(-1)])

    theta0 = jnp.zeros(15)

    def gn_body(carry, _):
        theta, lam = carry
        r = residuals(theta)
        J = jax.jacfwd(residuals)(theta)
        H = J.T @ J + lam * jnp.eye(15)
        d = -jnp.linalg.solve(H, J.T @ r)
        cand = theta + d
        accept = jnp.sum(residuals(cand) ** 2) < jnp.sum(r * r)
        theta = jnp.where(accept, cand, theta)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        return (theta, lam), None

    (theta, _), _ = jax.lax.scan(gn_body, (theta0, jnp.float32(1e-3)), None,
                                 length=n_iters)
    q, p, vv, b = unpack(theta)

    T_cw = lie.se3_compose(T_cb, lie.se3_inverse(lie.se3(q, p)))
    pc = lie.se3_apply(T_cw, X_w)
    err = jnp.sum((camera.project(K, pc) - uv) ** 2, axis=-1)
    n_in = jnp.sum(valid & (err <= CHI2_MONO) & (pc[:, 2] > 0.05))
    return PoseVIResult(q_wb=q, p_wb=p, v=vv, bias=b, n_inliers=n_in)


class VIBAResult(NamedTuple):
    q_wb: jnp.ndarray   # [N,4]
    p_wb: jnp.ndarray   # [N,3]
    v: jnp.ndarray      # [N,3]
    bg: jnp.ndarray     # [N,3]
    ba: jnp.ndarray     # [N,3]
    points: jnp.ndarray  # [Pt,3]
    cost: jnp.ndarray


@partial(jax.jit, static_argnames=("n_iters",))
def visual_inertial_ba(
    K,
    T_cb,
    q_wb, p_wb, v,        # [N,4], [N,3], [N,3]
    bg, ba,               # [N,3], [N,3] per-KF biases
    pres: P.Preintegrated,  # batched [N-1], linearized at bias of KF i
    points,               # [Pt,3]
    cam_idx, pt_idx, uv, conf,  # observations (same layout as optim.ba)
    kf_free,              # [N] bool
    pt_free,              # [Pt] bool
    *,
    n_iters: int = 8,
    gravity=None,
) -> VIBAResult:
    """Windowed visual-inertial BA — reference FullInertialBA (:352) /
    LocalInertialBA (:2745): per-KF pose/velocity/bias states joined by
    inertial + bias-random-walk edges, reprojection edges to map points.

    Solved by block-coordinate LM: a dense GN step on the stacked motion
    states (15 dof per KF, windows are small) alternating with batched 3x3
    point updates — the same camera/point elimination ordering as the Schur
    solver in optim.ba, with the motion block solved exactly.
    """
    g = P.GRAVITY if gravity is None else gravity
    N = q_wb.shape[0]
    Pt = points.shape[0]
    kf_freef = kf_free.astype(jnp.float32)
    W_walk = jax.vmap(_whiten)(pres.cov_walk)  # [N-1,6,6]

    def unpack(theta, q0, p0, v0, bg0, ba0):
        th = theta.reshape(N, 15) * kf_freef[:, None]
        q = lie.quat_normalize(
            jax.vmap(lie.quat_mul)(q0, jax.vmap(lie.so3_exp)(th[:, 0:3]))
        )
        p = p0 + th[:, 3:6]
        vv = v0 + th[:, 6:9]
        return q, p, vv, bg0 + th[:, 9:12], ba0 + th[:, 12:15]

    def motion_residuals(theta, q0, p0, v0, bg0, ba0, pts):
        q, p, vv, bgs, bas = unpack(theta, q0, p0, v0, bg0, ba0)

        def edge(i):
            pre_i = jax.tree.map(lambda x: x[i], pres)
            r_in = _inertial_residual_whitened(
                pre_i, q[i], p[i], vv[i], q[i + 1], p[i + 1], vv[i + 1],
                P.ImuBias(bgs[i], bas[i]), g,
            )
            db = jnp.concatenate([bgs[i + 1] - bgs[i], bas[i + 1] - bas[i]])
            return jnp.concatenate([r_in, W_walk[i].T @ db])

        r_edges = jax.vmap(edge)(jnp.arange(N - 1)).reshape(-1)

        T_bw = jax.vmap(lie.se3_inverse)(jax.vmap(lie.se3)(q, p))
        T_cw = jax.vmap(lambda t: lie.se3_compose(T_cb, t))(T_bw)
        pc = jax.vmap(lie.se3_apply)(T_cw[cam_idx], points_obs(pts))
        uv_hat = camera.project(K, pc)
        r_uv = uv_hat - uv
        chi2 = jnp.sum(r_uv * r_uv, axis=-1) * conf
        w = jnp.sqrt(conf * robust.huber_weight(chi2, CHI2_MONO) * (pc[:, 2] > 0.05))
        return jnp.concatenate([r_edges, (w[:, None] * r_uv).reshape(-1)])

    def points_obs(pts):
        return pts[pt_idx]

    def point_step(q, p, pts):
        """Batched GN update of points with poses fixed (3x3 solves)."""
        T_bw = jax.vmap(lie.se3_inverse)(jax.vmap(lie.se3)(q, p))
        T_cw = jax.vmap(lambda t: lie.se3_compose(T_cb, t))(T_bw)
        pose_o = T_cw[cam_idx]
        r, _, Jp, depth = camera.reproj_residual_and_jacobians(
            K, pose_o, pts[pt_idx], uv
        )
        chi2 = jnp.sum(r * r, axis=-1) * conf
        w = conf * robust.huber_weight(chi2, CHI2_MONO) * (depth > 0.05)
        Hpp = jax.ops.segment_sum(
            jnp.einsum("oki,o,okj->oij", Jp, w, Jp), pt_idx, num_segments=Pt
        )
        bp = jax.ops.segment_sum(
            jnp.einsum("oki,o,ok->oi", Jp, w, r), pt_idx, num_segments=Pt
        )
        from ..optim.ba import _inv3x3

        Hpp = Hpp + 1e-6 * jnp.eye(3)
        dxp = -jnp.einsum("pij,pj->pi", _inv3x3(Hpp), bp)
        return pts + dxp * pt_free[:, None].astype(pts.dtype)

    def body(carry, _):
        q0, p0, v0, bg0, ba0, pts, lam = carry
        theta0 = jnp.zeros(N * 15)
        r = motion_residuals(theta0, q0, p0, v0, bg0, ba0, pts)
        J = jax.jacfwd(lambda th: motion_residuals(th, q0, p0, v0, bg0, ba0, pts))(
            theta0
        )
        H = J.T @ J
        H = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-6))
        # pin fixed KFs (rows zeroed by the kf_free mask in unpack; keep H SPD)
        fixed = jnp.repeat(1.0 - kf_freef, 15)
        H = H + jnp.diag(fixed)
        d = -jnp.linalg.solve(H, J.T @ r)
        c0 = jnp.sum(r * r)
        c1 = jnp.sum(motion_residuals(d, q0, p0, v0, bg0, ba0, pts) ** 2)
        accept = c1 < c0
        d = jnp.where(accept, d, jnp.zeros_like(d))
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        q1, p1, v1, bg1, ba1 = unpack(d, q0, p0, v0, bg0, ba0)
        pts1 = point_step(q1, p1, pts)
        return (q1, p1, v1, bg1, ba1, pts1, lam), c1

    cam_idx = jnp.clip(cam_idx, 0, N - 1)
    pt_idx = jnp.clip(pt_idx, 0, Pt - 1)
    (q, p, vv, bgs, bas, pts, _), costs = jax.lax.scan(
        body, (q_wb, p_wb, v, bg, ba, points, jnp.float32(1e-3)), None,
        length=n_iters,
    )
    return VIBAResult(q_wb=q, p_wb=p, v=vv, bg=bgs, ba=bas, points=pts,
                      cost=costs[-1])
