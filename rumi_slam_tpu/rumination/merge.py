"""Submap merging: timestamp association + dual Sim3 hypotheses + welding BA.

JAX re-design of the reference's CloudMerging thread
(/root/reference/src/rumi-slam/lib_src/CloudMerging.cc): Run (:96-412)
timestamp-matches KFs edge-front<->cloud (tolerance 1e-4 s, :147-164), solves
a global Sim3 per submap pair — Umeyama on matched KF centers vs Horn/RANSAC
(ComputeSubmapSim3 :434-825, picking by inlier ratio :785-791), refines with
a single-Sim3 reprojection LM (Optimizer::OptimizeCloudSim3 :2169-2471),
then welds (CloudMergeMap :1364-1785: cross observations, Sim3-corrected
poses, migration, welding local BA) — first cloud->front, then back->front.

Because the map is ONE SoA MapState with ``map_id`` labels, the reference's
~400-line migration loops become: transform-src-submap (a masked Sim3 apply),
relabel, a fuse lookup-table for duplicate points, and one welding BA call.

Pose correction under a world Sim3 uses the standard trick (ORB-SLAM3
MergeLocal): for src pose T_cw and world map S (src->dst), the Sim3 product
Q = T_cw ∘ S^-1 has scale s; the corrected SE3 pose is (R_q, t_q / s_q).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MergeConfig
from ..geometry import alignment, camera, lie
from ..mapstate import map_state as M
from ..optim import ba, robust


class KFMatches(NamedTuple):
    dst_kf: jnp.ndarray  # [Mk] int32, -1 pad
    src_kf: jnp.ndarray  # [Mk]
    valid: jnp.ndarray   # [Mk] bool


class PointPairs(NamedTuple):
    """3D-3D correspondences induced by pixel-radius keypoint association
    inside matched KF pairs (reference CloudMerging.cc:502-551)."""

    dst_kf: jnp.ndarray   # [N] observing dst keyframe
    dst_uv: jnp.ndarray   # [N,2] observed pixel in dst KF
    dst_pt: jnp.ndarray   # [N] dst point row
    src_pt: jnp.ndarray   # [N] src point row
    valid: jnp.ndarray    # [N]


@partial(jax.jit, static_argnames=("max_pairs",))
def match_kfs_by_time(kf_time, kf_valid, kf_map_id, dst_id, src_id,
                      *, max_pairs: int, tol=1e-4):
    """Pair dst-map KFs with src-map KFs at (near-)identical timestamps."""
    K = kf_time.shape[0]
    dst_sel = kf_valid & (kf_map_id == dst_id)
    src_sel = kf_valid & (kf_map_id == src_id)
    dt = jnp.abs(kf_time[:, None] - kf_time[None, :])  # [K,K]
    dt = jnp.where(dst_sel[:, None] & src_sel[None, :], dt, jnp.inf)
    best_src = jnp.argmin(dt, axis=1)
    best_dt = jnp.min(dt, axis=1)
    good = best_dt <= tol
    # top max_pairs by recency (largest timestamps near the seam first)
    order_key = jnp.where(good, kf_time, -jnp.inf)
    _, top = jax.lax.top_k(order_key, max_pairs)
    valid = good[top]
    return KFMatches(
        dst_kf=jnp.where(valid, top, -1),
        src_kf=jnp.where(valid, best_src[top], -1),
        valid=valid,
    )


@jax.jit
def associate_points(ms: M.MapState, matches: KFMatches, *, radius=3.0):
    """Per matched KF pair, associate keypoints within ``radius`` px whose
    features both carry map points -> 3D-3D pairs."""
    F = ms.max_feat

    def one_pair(kd, ks, ok):
        kd_c = jnp.clip(kd, 0)
        ks_c = jnp.clip(ks, 0)
        uv_d = ms.kf_uv[kd_c]
        uv_s = ms.kf_uv[ks_c]
        pt_d = ms.kf_point[kd_c]
        pt_s = ms.kf_point[ks_c]
        has_d = (pt_d >= 0) & ms.kf_feat_valid[kd_c]
        has_s = (pt_s >= 0) & ms.kf_feat_valid[ks_c]
        d2 = jnp.sum((uv_d[:, None, :] - uv_s[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(has_d[:, None] & has_s[None, :], d2, jnp.inf)
        best = jnp.argmin(d2, axis=1)
        bd = jnp.min(d2, axis=1)
        good = (bd <= radius * radius) & ok
        return (
            jnp.full((F,), kd_c, jnp.int32),
            uv_d,
            jnp.where(good, pt_d, -1),
            jnp.where(good, pt_s[best], -1),
            good,
        )

    dk, duv, dpt, spt, val = jax.vmap(one_pair)(
        matches.dst_kf, matches.src_kf, matches.valid
    )
    return PointPairs(
        dst_kf=dk.reshape(-1),
        dst_uv=duv.reshape(-1, 2),
        dst_pt=dpt.reshape(-1),
        src_pt=spt.reshape(-1),
        valid=val.reshape(-1),
    )


@partial(jax.jit, static_argnames=("n_hyp", "n_iters"))
def compute_submap_sim3(key, K, ms: M.MapState, matches: KFMatches,
                        pairs: PointPairs, *, n_hyp: int = 1024,
                        n_iters: int = 8, thresh_px: float = 6.0):
    """Solve S (src world -> dst world) from KF matches + point pairs.

    Two closed-form hypotheses as in the reference (CloudMerging.cc:581-791):
      (a) Umeyama on matched KF camera centers;
      (b) Horn on RANSAC triples of 3D-3D point pairs (vmapped);
    winner by reprojection-inlier count, then a global-Sim3 reprojection LM
    (the OptimizeCloudSim3 equivalent).  Returns (S [8], inlier_ratio).

    ``n_hyp``: with 64 triples the back merge of a post-loss submap whose
    pairs were almost all inliers reported ratios as low as 0.12 over 30
    keys, and sometimes failed the 0.1 gate; 1024 triples kept every key
    above 0.8.  Horn on a triple is cheap; scoring is batched.
    """
    valid = pairs.valid & (pairs.dst_pt >= 0) & (pairs.src_pt >= 0)
    X_dst = ms.pt_xyz[jnp.clip(pairs.dst_pt, 0)]
    X_src = ms.pt_xyz[jnp.clip(pairs.src_pt, 0)]
    T_dst = ms.kf_pose[jnp.clip(pairs.dst_kf, 0)]

    def inlier_mask(S):
        X_hat = lie.sim3_apply(S, X_src)
        uv_hat, depth = camera.project_world(K, T_dst, X_hat)
        err = jnp.linalg.norm(uv_hat - pairs.dst_uv, axis=-1)
        return valid & (err < thresh_px) & (depth > 0.05)

    n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)

    # (a) Umeyama on camera centers of matched KF pairs
    c_dst = lie.se3_t(jax.vmap(lie.se3_inverse)(ms.kf_pose[jnp.clip(matches.dst_kf, 0)]))
    c_src = lie.se3_t(jax.vmap(lie.se3_inverse)(ms.kf_pose[jnp.clip(matches.src_kf, 0)]))
    w_kf = matches.valid.astype(jnp.float32)
    S_um = alignment.umeyama_alignment(c_src, c_dst, w_kf)

    # (b) Horn RANSAC on 3D-3D point pairs
    probs = jnp.log(jnp.maximum(valid.astype(jnp.float32), 1e-12))
    idx = jax.random.categorical(
        key, probs[None, :].repeat(n_hyp * 3, 0)
    ).reshape(n_hyp, 3)

    def horn_triple(ii):
        return alignment.horn_alignment(X_src[ii], X_dst[ii])

    S_h = jax.vmap(horn_triple)(idx)
    # scored in batches: all hypotheses at once would hold [n_hyp, N] terms
    scores_h = jax.lax.map(lambda S: jnp.sum(inlier_mask(S)), S_h,
                           batch_size=64)
    best_h = jnp.argmax(scores_h)
    S_horn = S_h[best_h]

    n_um = jnp.sum(inlier_mask(S_um))
    n_ho = scores_h[best_h]
    S0 = jnp.where(n_um >= n_ho, S_um, S_horn)

    # global-Sim3 LM refinement with Huber (OptimizeCloudSim3 equivalent)
    w_rob0 = inlier_mask(S0).astype(jnp.float32)

    def residuals(tau, S_base):
        S = lie.sim3_retract(S_base, tau)
        X_hat = lie.sim3_apply(S, X_src)
        uv_hat, _ = camera.project_world(K, T_dst, X_hat)
        return (uv_hat - pairs.dst_uv)

    def lm_body(carry, _):
        S, lam = carry
        r = residuals(jnp.zeros(7), S)
        chi2 = jnp.sum(r * r, axis=-1)
        w = w_rob0 * robust.huber_weight(chi2, 25.0)
        J = jax.jacfwd(lambda tau: residuals(tau, S))(jnp.zeros(7))  # [N,2,7]
        H = jnp.einsum("nki,n,nkj->ij", J, w, J) + lam * jnp.eye(7)
        g = jnp.einsum("nki,n,nk->i", J, w, r)
        tau = -jnp.linalg.solve(H + 1e-8 * jnp.eye(7), g)
        S_new = lie.sim3_retract(S, tau)
        c0 = jnp.sum(w * chi2)
        r1 = residuals(jnp.zeros(7), S_new)
        c1 = jnp.sum(w * jnp.sum(r1 * r1, axis=-1))
        accept = c1 < c0
        S = jnp.where(accept, S_new, S)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e6)
        return (S, lam), None

    (S_ref, _), _ = jax.lax.scan(lm_body, (S0, jnp.float32(1e-3)), None,
                                 length=n_iters)

    ratio = jnp.sum(inlier_mask(S_ref)) / n_valid.astype(jnp.float32)
    return S_ref, ratio, inlier_mask(S_ref)


@jax.jit
def transform_submap(ms: M.MapState, map_id, S):
    """Apply world Sim3 S to every KF pose and point of one submap."""
    sel_kf = ms.kf_valid & (ms.kf_map_id == map_id)
    sel_pt = ms.pt_valid & (ms.pt_map_id == map_id)

    new_xyz = jnp.where(sel_pt[:, None], lie.sim3_apply(S, ms.pt_xyz), ms.pt_xyz)

    S_inv = lie.sim3_inverse(S)
    Q = lie.sim3_compose(lie.sim3_from_se3(ms.kf_pose), S_inv[None, :])
    s_q = lie.sim3_scale(Q)
    corrected = lie.se3(Q[:, :4], Q[:, 4:7] / s_q[:, None])
    new_pose = jnp.where(sel_kf[:, None], corrected, ms.kf_pose)
    return ms._replace(kf_pose=new_pose, pt_xyz=new_xyz)


@jax.jit
def fuse_points(ms: M.MapState, pairs: PointPairs, inliers):
    """Duplicate-point fusion: src points in inlier pairs are replaced by
    their dst partners everywhere (reference cross-observation step,
    CloudMerging.cc:1441-1465 + SearchAndFuse)."""
    P = ms.max_pt
    fuse_to = jnp.full((P,), -1, jnp.int32)
    ok = pairs.valid & inliers & (pairs.src_pt >= 0) & (pairs.dst_pt >= 0)
    fuse_to = fuse_to.at[jnp.clip(pairs.src_pt, 0)].max(
        jnp.where(ok, pairs.dst_pt, -1)
    )
    kp = ms.kf_point
    tgt = fuse_to[jnp.clip(kp, 0)]
    kp = jnp.where((kp >= 0) & (tgt >= 0), tgt, kp)
    pt_valid = ms.pt_valid & (fuse_to < 0)
    return ms._replace(kf_point=kp, pt_valid=pt_valid)


def _welding_window(matches: KFMatches, w: int, ms: M.MapState = None,
                    covis: int = 0):
    """Static-size welding window: alternate dst/src matched KFs, then (when
    ``covis`` > 0 and ``ms`` given) the strongest covisible neighbors of the
    matched set — the reference expands its welding window the same way with
    5 best covisibles per matched KF (CloudMerging.cc:1408-1422), so the BA
    seam includes the keyframes whose points the merge just rewired."""
    ids = jnp.stack([matches.dst_kf, matches.src_kf], axis=1).reshape(-1)
    valid = jnp.stack([matches.valid, matches.valid], axis=1).reshape(-1)
    key = jnp.where(valid, jnp.arange(ids.shape[0]), 1 << 30)
    _, order = jax.lax.top_k(-key, w)
    ids, valid = ids[order], valid[order]
    if covis > 0 and ms is not None:
        Wgt = M.covisibility(ms)
        in_window = jnp.zeros((ms.max_kf,), bool).at[
            jnp.clip(ids, 0)].max(valid)
        # accumulate covisibility weight toward the matched window
        wsum = jnp.sum(
            Wgt * in_window[:, None], axis=0
        ) * ms.kf_valid * ~in_window
        vals, nb = jax.lax.top_k(wsum, covis)
        ids = jnp.concatenate([ids, nb])
        valid = jnp.concatenate([valid, vals >= M.MIN_COVIS_WEIGHT])
    return ids, valid


@partial(jax.jit, static_argnames=("window", "n_iters", "covis"))
def welding_ba(ms: M.MapState, K, matches: KFMatches, *, window: int = 16,
               n_iters: int = 5, covis: int = 0):
    """Welding bundle adjustment over the seam (reference welding LBA,
    Optimizer.cc:3768 called from CloudMergeMap:1677): adjust the matched
    dst+src KFs plus ``covis`` covisible expanders, hold the two oldest as
    anchors, free all their points."""
    ids, valid_w = _welding_window(matches, window, ms, covis)
    ids = jnp.clip(ids, 0)
    F = ms.max_feat
    W = window + covis

    poses_w = ms.kf_pose[ids]
    cam_idx = jnp.repeat(jnp.arange(W), F)
    pt = ms.kf_point[ids].reshape(-1)
    uv = ms.kf_uv[ids].reshape(-1, 2)
    conf = (
        (pt >= 0) & ms.kf_feat_valid[ids].reshape(-1) & jnp.repeat(valid_w, F)
    ).astype(jnp.float32)
    # cloud observations weigh less: blur-homogenized bundle detections are
    # noisier than live ones (same fence as global_bundle_adjustment)
    conf = conf * jnp.repeat(
        jnp.where(ms.kf_is_cloud[ids], 0.3, 1.0), F)

    big = jnp.int32(1 << 30)
    order = jnp.where(valid_w, ids, big)
    a1 = jnp.min(order)
    a2 = jnp.min(jnp.where(order == a1, big, order))
    cam_free = valid_w & (ids != a1) & (ids != a2)

    res = ba.bundle_adjust(
        K, poses_w, ms.pt_xyz, cam_idx, jnp.clip(pt, 0), uv, conf,
        cam_free, ms.pt_valid, n_iters=n_iters,
    )
    new_pose = ms.kf_pose.at[ids].set(
        jnp.where((valid_w & cam_free)[:, None], res.poses, ms.kf_pose[ids])
    )
    return ms._replace(kf_pose=new_pose, pt_xyz=res.points)


def merge_submaps(ms: M.MapState, K, src_id, dst_id, cfg: MergeConfig, key):
    """Full merge of submap ``src_id`` into ``dst_id``.

    Returns (ms, ok, info).  On failure the map is returned untouched
    (reference rejects merges with inlier ratio <= 0.1,
    CloudMerging.cc:815-824).
    """
    matches = match_kfs_by_time(
        ms.kf_time, ms.kf_valid, ms.kf_map_id, dst_id, src_id,
        max_pairs=cfg.max_match_kf, tol=cfg.time_tolerance_s,
    )
    n_matched = int(jnp.sum(matches.valid))
    # 2 matched KFs suffice: the Sim3 hypotheses come from Horn triples over
    # the per-feature 3D-3D pairs (hundreds per KF pair), not from the KF
    # centers alone; the Umeyama-on-centers hypothesis simply loses the
    # inlier vote when degenerate.
    if n_matched < 2:
        return ms, False, {"n_kf_matches": n_matched, "reason": "no_kf_matches"}

    pairs = associate_points(ms, matches, radius=cfg.pixel_radius)
    n_pairs = int(jnp.sum(pairs.valid))
    if n_pairs < 10:
        return ms, False, {"n_kf_matches": n_matched, "n_pt_pairs": n_pairs,
                           "reason": "no_point_pairs"}

    S, ratio, inliers = compute_submap_sim3(
        key, K, ms, matches, pairs, n_iters=cfg.sim3_iters
    )
    if float(ratio) <= cfg.min_inlier_ratio:
        return ms, False, {"n_kf_matches": n_matched, "n_pt_pairs": n_pairs,
                           "inlier_ratio": float(ratio), "reason": "low_inliers"}

    ms = transform_submap(ms, src_id, S)
    ms = fuse_points(ms, pairs, inliers)
    ms = M.relabel_map(ms, src_id, dst_id)
    ms = welding_ba(ms, K, matches, covis=cfg.welding_covis)
    return ms, True, {
        "n_kf_matches": n_matched,
        "n_pt_pairs": n_pairs,
        "inlier_ratio": float(ratio),
        "scale": float(lie.sim3_scale(S)),
    }
