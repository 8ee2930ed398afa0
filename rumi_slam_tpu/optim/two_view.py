"""Monocular two-view initialization: essential-matrix RANSAC + cheirality.

JAX equivalent of the reference's TwoViewReconstruction
(/root/reference/src/rumi-slam/lib_src/TwoViewReconstruction.cc — 200x8-point
RANSAC for H and F in two host threads, model selection, motion decomposition
and cheirality-checked triangulation; entry via Pinhole::ReconstructWithTwoViews
at Tracking.cc:2126).  Re-designed as fixed-iteration vmapped hypothesis
scoring: all RANSAC hypotheses for BOTH models are solved and scored in one
batched program — no adaptive early exit, no threads.  Since intrinsics are
known the fundamental path becomes a calibrated essential path; the
homography path (4-point DLT + Faugeras SVD decomposition into 8 motion
candidates) rescues pure-planar scenes where the 8-point essential DLT is
rank-degenerate.  Model selection mirrors the reference's
score-ratio rule (RH = SH/(SH+SF) > 0.40 → homography,
TwoViewReconstruction.cc ReconstructH/ReconstructF).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie, triangulation


class TwoViewResult(NamedTuple):
    T_21: jnp.ndarray       # [7] pose of view 2 in view-1 frame (world = view 1)
    points: jnp.ndarray     # [N,3] triangulated in view-1 frame
    inliers: jnp.ndarray    # [N] bool
    n_inliers: jnp.ndarray  # scalar int32
    ok: jnp.ndarray         # scalar bool — enough support to accept


def _eight_point(r1, r2, w=None):
    """E from >=8 normalized-ray pairs [M,3] via DLT (smallest eigvec).
    Optional per-row weights ``w`` [M] turn this into the weighted LS
    refinement used after RANSAC."""
    x1, y1 = r1[:, 0] / r1[:, 2], r1[:, 1] / r1[:, 2]
    x2, y2 = r2[:, 0] / r2[:, 2], r2[:, 1] / r2[:, 2]
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)],
        axis=-1,
    )  # [M,9], rows: ray2^T E ray1 = 0
    if w is not None:
        A = A * w[:, None]
    ATA = A.T @ A
    _, V = jnp.linalg.eigh(ATA)
    return V[:, 0].reshape(3, 3)


def _to_essential(E):
    """Project onto the essential manifold (two equal singular values)."""
    U, _, Vt = jnp.linalg.svd(E)
    return U @ jnp.diag(jnp.array([1.0, 1.0, 0.0])) @ Vt


def _sampson_err(E, r1, r2):
    """Squared Sampson distance in normalized coords, [N]."""
    x1 = r1 / r1[:, 2:3]
    x2 = r2 / r2[:, 2:3]
    Ex1 = x1 @ E.T
    Etx2 = x2 @ E
    num = jnp.sum(x2 * Ex1, axis=-1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def _decompose_E(E):
    """E -> 4 candidate T_21 = (R, t), ||t|| = 1."""
    U, _, Vt = jnp.linalg.svd(E)
    # make proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    cands = []
    for R in (R1, R2):
        for s in (1.0, -1.0):
            cands.append(lie.se3(lie.quat_from_matrix(R), s * t))
    return jnp.stack(cands)  # [4,7]


def _four_point_h(r1, r2, w=None):
    """Homography from >=4 normalized-plane pairs via DLT (x2 ~ H x1).

    ``r1, r2`` are [M,3] rays; optional weights ``w`` [M] make this the
    weighted-LS refinement used on the consensus set.  Rows follow the
    standard 2-equations-per-point DLT with h = vec(H) the smallest
    eigenvector of AᵀA.
    """
    x1, y1 = r1[:, 0] / r1[:, 2], r1[:, 1] / r1[:, 2]
    x2, y2 = r2[:, 0] / r2[:, 2], r2[:, 1] / r2[:, 2]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    rows_a = jnp.stack(
        [x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    rows_b = jnp.stack(
        [z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], axis=-1)
    A = jnp.concatenate([rows_a, rows_b], axis=0)  # [2M,9]
    if w is not None:
        A = A * jnp.concatenate([w, w])[:, None]
    ATA = A.T @ A
    _, V = jnp.linalg.eigh(ATA)
    return V[:, 0].reshape(3, 3)


def _sym_transfer_err(Hm, r1, r2):
    """Symmetric transfer error (normalized coords, squared), [N]."""
    x1 = r1 / r1[:, 2:3]
    x2 = r2 / r2[:, 2:3]
    Hx1 = x1 @ Hm.T
    Hx1 = Hx1 / jnp.where(jnp.abs(Hx1[:, 2:3]) < 1e-12, 1e-12, Hx1[:, 2:3])
    Hinv = jnp.linalg.inv(Hm + 1e-12 * jnp.eye(3))
    Hix2 = x2 @ Hinv.T
    Hix2 = Hix2 / jnp.where(jnp.abs(Hix2[:, 2:3]) < 1e-12, 1e-12, Hix2[:, 2:3])
    e12 = jnp.sum((Hx1[:, :2] - x2[:, :2]) ** 2, axis=-1)
    e21 = jnp.sum((Hix2[:, :2] - x1[:, :2]) ** 2, axis=-1)
    return 0.5 * (e12 + e21)


def _decompose_H(Hm):
    """Calibrated homography -> 8 candidate T_21 poses (Faugeras SVD method,
    as in TwoViewReconstruction::ReconstructH).  Translation is left at the
    decomposition's scale; downstream normalizes the gauge."""
    U, d, Vt = jnp.linalg.svd(Hm)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom)
    aux3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom)
    d2s = jnp.maximum(d2, 1e-12)

    cands = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1, x3 = e1 * aux1, e3 * aux3
            # case d' = +d2
            st = (d1 - d3) * x1 * x3 / d2s
            ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
            Rp = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
            Rp = Rp.at[0, 0].set(ct).at[0, 2].set(-st)
            Rp = Rp.at[2, 0].set(st).at[2, 2].set(ct)
            tp = (d1 - d3) * jnp.array([x1, 0.0, -x3])
            R = s * (U @ Rp @ Vt)
            t = U @ tp
            cands.append((R, t))
            # case d' = -d2
            sp = (d1 + d3) * x1 * x3 / d2s
            cp = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
            Rn = jnp.zeros((3, 3))
            Rn = Rn.at[0, 0].set(cp).at[0, 2].set(sp)
            Rn = Rn.at[1, 1].set(-1.0)
            Rn = Rn.at[2, 0].set(sp).at[2, 2].set(-cp)
            tn = (d1 + d3) * jnp.array([x1, 0.0, x3])
            R = s * (U @ Rn @ Vt)
            t = U @ tn
            cands.append((R, t))

    out = []
    for R, t in cands:
        tn = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
        out.append(lie.se3(lie.quat_from_matrix(R), tn))
    return jnp.stack(out)  # [8,7]


@partial(jax.jit, static_argnames=("n_hyp",))
def two_view_init(
    key,
    ray1,
    ray2,
    valid,
    *,
    n_hyp: int = 256,
    focal: float = 525.0,
    px_thresh: float = 2.0,
    min_inliers: int = 50,
    min_parallax_deg: float = 0.4,
):
    """Estimate relative pose + structure from matched rays.

    Args:
      key: PRNG key for hypothesis sampling.
      ray1, ray2: [N,3] normalized camera rays of the matches.
      valid: [N] bool.
      focal, px_thresh: the Sampson inlier gate is (px_thresh/focal)^2 —
        stated in PIXELS so it transfers across cameras (the reference
        hardcodes per-sigma chi2 gates at TUM scale).
    """
    sampson_thresh = (px_thresh / focal) ** 2
    n = ray1.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.categorical(
        key, jnp.log(jnp.maximum(probs, 1e-12))[None, :].repeat(n_hyp * 8, 0)
    ).reshape(n_hyp, 8)

    Es = jax.vmap(lambda ii: _eight_point(ray1[ii], ray2[ii]))(idx)
    errs = jax.vmap(lambda E: _sampson_err(E, ray1, ray2))(Es)  # [H,N]
    inl = (errs < sampson_thresh) & valid[None, :]
    scores = jnp.sum(inl, axis=-1)
    best = jnp.argmax(scores)
    E = _to_essential(Es[best])

    # ---- homography model (4-point subsets of the same draws) ----------
    # chi2 gate: symmetric transfer error is 2-dof vs Sampson's 1-dof
    # (reference: 5.99 vs 3.84 at sigma=1px, TwoViewReconstruction.cc
    # CheckHomography/CheckFundamental).
    h_thresh = sampson_thresh * (5.991 / 3.841)
    Hs = jax.vmap(lambda ii: _four_point_h(ray1[ii[:4]], ray2[ii[:4]]))(idx)
    errs_h = jax.vmap(lambda Hm: _sym_transfer_err(Hm, ray1, ray2))(Hs)
    inl_h = (errs_h < h_thresh) & valid[None, :]
    scores_h = jnp.sum(inl_h, axis=-1)
    best_h = jnp.argmax(scores_h)
    Hmat = Hs[best_h]

    # Weighted-LS refinement on the consensus set (2 IRLS rounds): an
    # 8-point minimal fit is far too noisy to decompose directly — with
    # near-forward motion the recovered translation direction can be tens
    # of degrees off even when every match is an epipolar inlier.  The
    # reference gets the same effect from its 200-iteration adaptive
    # RANSAC + per-model refinement (TwoViewReconstruction.cc).
    def refine(E, _):
        w = ((_sampson_err(E, ray1, ray2) < sampson_thresh) & valid).astype(
            jnp.float32)
        return _to_essential(_eight_point(ray1, ray2, w)), None

    E, _ = jax.lax.scan(refine, E, None, length=2)

    def refine_h(Hm, _):
        w = ((_sym_transfer_err(Hm, ray1, ray2) < h_thresh) & valid).astype(
            jnp.float32)
        return _four_point_h(ray1, ray2, w), None

    Hmat, _ = jax.lax.scan(refine_h, Hmat, None, length=2)

    # ---- model selection (reference: RH = SH/(SH+SF) > 0.40) ------------
    # Truncated-quadratic ROBUST scores, not inlier counts (reference
    # CheckHomography/CheckFundamental accumulate (th - chi2) per obs):
    # counts saturate at low parallax — a homography then "explains" a fully
    # 3D scene through its looser 2-dof gate and wins every forward-motion
    # init; residual-magnitude scores keep E competitive.
    e_h = _sym_transfer_err(Hmat, ray1, ray2) / h_thresh       # gate at 1
    e_e = _sampson_err(E, ray1, ray2) / sampson_thresh
    SH = jnp.sum(jnp.where(valid & (e_h < 1.0), 1.0 - e_h, 0.0))
    SE = jnp.sum(jnp.where(valid & (e_e < 1.0), 1.0 - e_e, 0.0))
    prefer_h = SH > 0.40 * (SH + SE)

    cands = jnp.concatenate(
        [_decompose_E(E), _decompose_H(Hmat)], axis=0)  # [12,7]
    cand_is_h = jnp.concatenate(
        [jnp.zeros(4, bool), jnp.ones(8, bool)])
    T1 = jnp.broadcast_to(lie.se3_identity(), (n, 7))

    inl_of_model = jnp.stack([e_e < 1.0, e_h < 1.0])  # [2,N]

    def score_cand(T21, is_h):
        T2 = jnp.broadcast_to(T21, (n, 7))
        X = triangulation.triangulate_dlt(T1, T2, ray1, ray2)
        z1 = X[:, 2]
        z2 = lie.se3_apply(T21, X)[:, 2]
        good = valid & (z1 > 1e-3) & (z2 > 1e-3) & inl_of_model[
            is_h.astype(jnp.int32)]
        return jnp.sum(good), X, good

    counts, Xs, goods = jax.vmap(score_cand)(cands, cand_is_h)

    # per-model winner + within-model ambiguity (ReconstructF requires a
    # clear winner among its 4 motions; ReconstructH uses
    # secondBestGood < 0.75 * bestGood over its 8)
    def pick(active, ratio):
        c = jnp.where(active, counts, -1)
        bi = jnp.argmax(c)
        cs = jnp.sort(c)
        distinct = cs[-1].astype(jnp.float32) > ratio * jnp.maximum(
            cs[-2].astype(jnp.float32), 0.0)
        return bi, distinct

    bi_e, distinct_e = pick(~cand_is_h, 1.7)
    bi_h, distinct_h = pick(cand_is_h, 1.0 / 0.75)

    # Cross-model fallback (robustness beyond the reference's hard either/
    # or): when the preferred model's decomposition is ambiguous but the
    # other model has a clearly dominant motion, take the other model.  The
    # classic failure this rescues is forward motion over 3D structure at
    # small parallax: RH ~ 0.5 prefers H, whose 8 Faugeras candidates tie,
    # while E's cheirality is unambiguous.
    use_h = jnp.where(prefer_h, distinct_h | ~distinct_e,
                      distinct_h & ~distinct_e)
    distinct = jnp.where(use_h, distinct_h, distinct_e)
    bi = jnp.where(use_h, bi_h, bi_e)
    T_21 = cands[bi]
    X = Xs[bi]
    good = goods[bi]

    # Nonlinear refinement: the algebraic 8-point solution is biased under
    # near-forward motion (the translation direction can sit tens of degrees
    # off with every match an epipolar inlier).  Gold-standard fix: minimize
    # REPROJECTION error of the triangulated structure — a tiny two-view
    # bundle adjustment in normalized coordinates (K = I, one free camera).
    # The reference's equivalent is ReconstructF/ReconstructH's
    # triangulation-checked model scoring + the full BA it runs right after
    # initialization (Tracking.cc:2143).
    from . import ba as _ba

    poses2 = jnp.stack([lie.se3_identity(), T_21])
    x1n = ray1[:, :2] / ray1[:, 2:3]
    x2n = ray2[:, :2] / ray2[:, 2:3]
    conf = good.astype(jnp.float32) * (focal * focal)  # 1px sigma, normalized
    bres = _ba.bundle_adjust(
        jnp.asarray([1.0, 1.0, 0.0, 0.0]),
        poses2,
        X,
        jnp.concatenate([jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.int32)]),
        jnp.concatenate([jnp.arange(n), jnp.arange(n)]),
        jnp.concatenate([x1n, x2n]),
        jnp.concatenate([conf, conf]),
        jnp.asarray([False, True]),
        good,
        n_iters=8,
    )
    T_21 = bres.poses[1]
    X = bres.points
    # keep unit-ish translation gauge for the downstream scale normalization
    tnorm = jnp.linalg.norm(T_21[4:7])
    gscale = 1.0 / jnp.maximum(tnorm, 1e-9)
    T_21 = lie.se3(T_21[:4], T_21[4:7] * gscale)
    X = X * gscale
    good = good & bres.inlier_obs[:n] & bres.inlier_obs[n:]
    z2 = lie.se3_apply(jnp.broadcast_to(T_21, (n, 7)), X)[:, 2]
    good = good & (X[:, 2] > 1e-3) & (z2 > 1e-3)

    # parallax gate — AGGREGATE, not per-point: under (near-)forward motion
    # points by the focus of expansion always have ~zero parallax; the
    # reference likewise only requires enough well-triangulated points
    # overall (TwoViewReconstruction::CheckRT counts parallax>minParallax
    # for its statistic but keeps all cheirality-checked points).
    c2 = lie.se3_t(lie.se3_inverse(T_21))
    d1 = X
    d2 = X - c2
    cosp = jnp.sum(d1 * d2, -1) / jnp.maximum(
        jnp.linalg.norm(d1, axis=-1) * jnp.linalg.norm(d2, axis=-1), 1e-12
    )
    min_parallax_cos = jnp.cos(jnp.deg2rad(min_parallax_deg))
    has_parallax = good & (cosp < min_parallax_cos)
    n_parallax = jnp.sum(has_parallax.astype(jnp.int32))

    n_inl = jnp.sum(good.astype(jnp.int32))
    # ``distinct`` (per-model winner dominance) was computed at selection
    # time above — the chosen model's gate applies here
    ok = (n_inl >= min_inliers) & distinct & (n_parallax >= min_inliers // 8)

    # normalize scene scale: median depth of inliers -> 1 (the reference
    # normalizes by median depth in CreateInitialMapMonocular, Tracking.cc:2143)
    z = jnp.where(good, X[:, 2], jnp.nan)
    med = jnp.nanmedian(z)
    scale = jnp.where(jnp.isfinite(med) & (med > 1e-6), 1.0 / med, 1.0)
    X = X * scale
    T_21 = lie.se3(T_21[:4], T_21[4:] * scale)

    return TwoViewResult(T_21=T_21, points=X, inliers=good, n_inliers=n_inl, ok=ok)
