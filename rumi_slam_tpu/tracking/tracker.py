"""Jitted per-frame tracking computations.

Array-program equivalents of the hot paths in the reference's Tracking thread
(/root/reference/src/rumi-slam/lib_src/Tracking.cc): TrackWithMotionModel
(:2441), TrackReferenceKeyFrame (:2324), TrackLocalMap (:2520,
SearchLocalPoints :2996) — all collapsed onto one primitive:
project-candidate-points -> masked int8 Hamming match -> motion-only BA.

The reference runs two sequential match+optimize passes (motion model, then
local map).  Here a single pass against the WHOLE active submap's points is
affordable because candidate gating is a mask on a batched distance matrix,
not a per-point grid walk; a second, wider pass runs only when the first one
is weak (host decides from `n_inliers`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera, lie
from ..mapstate import map_state as M
from ..ops import matcher
from ..optim import pose_opt


class TrackResult(NamedTuple):
    pose: jnp.ndarray         # [7] refined T_cw
    assoc: jnp.ndarray        # [F] int32 feature -> point id (-1 none)
    n_inliers: jnp.ndarray    # scalar int32
    n_candidates: jnp.ndarray # scalar int32 — visible map points


@partial(jax.jit, static_argnames=("img_w", "img_h"))
def track_frame(
    ms: M.MapState,
    K,
    feats,
    pose_pred,
    radius,
    *,
    img_w: int,
    img_h: int,
    max_hamming=matcher.TH_HIGH,
    nn_ratio=0.9,
):
    """Match frame features against the active submap's points around a pose
    prediction, then run motion-only BA.

    ``radius``: projection search window in pixels (scalar; the reference
    widens it per octave — here a single wide gate, the ratio test does the
    rest).
    Matching is ``matcher.window_match``: the fused kernel on the GPU, the
    plain reference on the CPU.
    """
    uv_proj, depth = camera.project_world(K, pose_pred, ms.pt_xyz)
    vis = (
        ms.pt_valid
        & (ms.pt_map_id == ms.active_map)
        & (depth > 0.05)
        & (uv_proj[:, 0] >= 0)
        & (uv_proj[:, 0] < img_w)
        & (uv_proj[:, 1] >= 0)
        & (uv_proj[:, 1] < img_h)
    )

    idx, mdist = matcher.window_match(
        feats.desc, ms.pt_desc, feats.uv, uv_proj, radius, feats.valid, vis,
        max_dist=max_hamming, ratio=nn_ratio,
    )

    # per-octave search radius (reference SearchByProjection:39 scales the
    # window by the candidate's pyramid level) and rotation consistency
    # (ComputeThreeMaxima, ORBmatcher.cc:1790): both run as ADAPTIVE
    # POST-filters on the matched set — zero extra matmuls, and each filter
    # only engages when the matches carry enough redundancy/signal for
    # pruning to be safe
    # (the reference can afford unconditional gates because its real-image
    # keypoint angles/scales are far less noisy than a synthetic bench's).
    matched = idx >= 0
    n_matched = jnp.sum(matched.astype(jnp.int32))
    pt_oct = ms.pt_octave[jnp.clip(idx, 0)]
    r_pt = jnp.minimum(
        radius, 0.5 * radius * jnp.power(1.2, pt_oct.astype(jnp.float32))
    )
    duv = jnp.linalg.norm(feats.uv - uv_proj[jnp.clip(idx, 0)], axis=-1)
    oct_keep = duv <= r_pt
    # engage only when matches are plentiful (pruning cannot starve the BA)
    matched &= oct_keep | (n_matched < 100)

    dang = feats.angle - ms.pt_angle[jnp.clip(idx, 0)]
    bins = jnp.mod(jnp.round(dang * (30.0 / (2.0 * jnp.pi))).astype(jnp.int32),
                   30)
    hist = jnp.zeros((30,), jnp.int32).at[bins].add(matched.astype(jnp.int32))
    top3_counts = jax.lax.top_k(hist, 3)[0]
    dominant = hist >= jnp.maximum(top3_counts[-1], 1)
    # engage only when rotation is a real signal: the 3 dominant bins must
    # hold a majority of the matches (concentrated histogram)
    concentrated = jnp.sum(top3_counts) * 2 >= jnp.sum(hist)
    matched &= dominant[bins] | ~concentrated

    idx = jnp.where(matched, idx, -1)
    X = ms.pt_xyz[jnp.clip(idx, 0)]
    # 3x6 LM schedule: the 4x10 of the reference (Optimizer.cc:723) is built
    # for cold starts; with a motion-model prediction 18 iterations converge
    # identically at half the sequential-latency cost.
    res = pose_opt.pose_optimization(K, pose_pred, X, feats.uv, matched,
                                     n_rounds=3, n_iters=6)
    assoc = jnp.where(matched & res.inliers, idx, -1)

    # visibility bookkeeping for culling (reference MapPoint IncreaseVisible/
    # IncreaseFound ratios, used by MapPointCulling)
    P = ms.max_pt
    found = jnp.zeros((P,), jnp.float32).at[jnp.clip(assoc, 0)].add(
        (assoc >= 0).astype(jnp.float32)
    )
    ms = ms._replace(
        pt_visible=ms.pt_visible + vis.astype(jnp.float32),
        pt_found=ms.pt_found + found,
    )

    return ms, TrackResult(
        pose=res.pose,
        assoc=assoc,
        n_inliers=jnp.sum((assoc >= 0).astype(jnp.int32)),
        n_candidates=jnp.sum(vis.astype(jnp.int32)),
    )


@jax.jit
def track_reference_kf(ms: M.MapState, K, feats, kf_id, pose_init, *,
                       max_hamming=matcher.TH_LOW, nn_ratio=0.8):
    """BoW-free reference-KF tracking: match frame descriptors against ONE
    keyframe's features (no spatial window), use its feature->point
    associations, pose-optimize (reference TrackReferenceKeyFrame,
    Tracking.cc:2324 — BoW bucketing is unnecessary at batched-Hamming speed).
    """
    kf_desc = ms.kf_desc[kf_id]
    kf_assoc = ms.kf_point[kf_id]
    has_pt = kf_assoc >= 0

    dist = matcher.hamming_matrix(feats.desc, kf_desc)
    idx, _ = matcher.match(
        dist, feats.valid, ms.kf_feat_valid[kf_id] & has_pt,
        max_dist=max_hamming, ratio=nn_ratio,
    )
    pt = jnp.where(idx >= 0, kf_assoc[jnp.clip(idx, 0)], -1)

    matched = pt >= 0
    X = ms.pt_xyz[jnp.clip(pt, 0)]
    res = pose_opt.pose_optimization(K, pose_init, X, feats.uv, matched)
    assoc = jnp.where(matched & res.inliers, pt, -1)
    return TrackResult(
        pose=res.pose,
        assoc=assoc,
        n_inliers=jnp.sum((assoc >= 0).astype(jnp.int32)),
        n_candidates=jnp.sum(has_pt.astype(jnp.int32)),
    )


@jax.jit
def relocalize_pnp(key, ms: M.MapState, K, feats, kf_id):
    """Relocalization against one candidate KF WITHOUT a pose prior:
    descriptor match to the KF's point-bearing features, then DLT-RANSAC PnP
    + motion-only BA — the reference's Relocalization body (Tracking.cc:3212:
    SearchByBoW + MLPnPsolver RANSAC + PoseOptimization)."""
    from ..optim import pnp

    kf_desc = ms.kf_desc[kf_id]
    kf_assoc = ms.kf_point[kf_id]
    has_pt = kf_assoc >= 0

    dist = matcher.hamming_matrix(feats.desc, kf_desc)
    # looser gate than in-track matching (80 / 0.9): relocalization views sit
    # across a loss gap, descriptor distances run hotter, and the PnP RANSAC
    # below is the actual outlier filter
    idx, mdist = matcher.match(
        dist, feats.valid, ms.kf_feat_valid[kf_id] & has_pt,
        max_dist=80.0, ratio=0.9,
    )
    pt = jnp.where(idx >= 0, kf_assoc[jnp.clip(idx, 0)], -1)
    matched = pt >= 0
    X = ms.pt_xyz[jnp.clip(pt, 0)]
    res = pnp.pnp_ransac(key, K, X, feats.uv, matched,
                         quality=80.0 - mdist)
    assoc = jnp.where(matched & res.inliers, pt, -1)
    return TrackResult(
        pose=res.pose,
        assoc=assoc,
        n_inliers=res.n_inliers,
        n_candidates=jnp.sum(matched.astype(jnp.int32)),
    )


@jax.jit
def relocalize_map(key, ms: M.MapState, K, feats, *,
                   max_hamming=80.0, nn_ratio=0.9, map_id=None):
    """Prior-free relocalization against the WHOLE active submap.

    The reference relocalizes per retrieval candidate (SearchByBoW against
    one KF's features, Tracking.cc:3212) because a brute-force scan over the
    map is hopeless on CPU.  On the GPU the full frame-vs-map Hamming matrix
    is one int8 tensor-core matmul, and matching against the map's
    distinctive descriptors sidesteps single-KF observation sparsity: any subset of map points the
    frame sees yields 3D-2D pairs for PnP-RANSAC, whichever keyframes
    observed them."""
    from ..optim import pnp

    # match against EVERY stored observation descriptor (kf_desc flattened),
    # not the single per-point representative: a point's appearance varies
    # across the viewpoints that saw it, and the reference's min-median
    # ComputeDistinctiveDescriptors is itself only a compromise for CPU
    # memory — one batched int8 product covers the full [F, K*Fk] matrix
    mid = ms.active_map if map_id is None else map_id
    obs_desc = ms.kf_desc.reshape(-1, 8)
    obs_pt = jnp.where(ms.kf_valid[:, None], ms.kf_point, -1).reshape(-1)
    obs_ok = (
        (obs_pt >= 0)
        & ms.pt_valid[jnp.clip(obs_pt, 0)]
        & (ms.pt_map_id[jnp.clip(obs_pt, 0)] == mid)
    )
    # tiled match: [F, K*Fk] at full capacity is ~1 GB — scan KF-chunks with
    # a running top-2 instead (peak device memory = one [F, K*Fk/16] block)
    idx, mdist = matcher.match_chunked(
        feats.desc, feats.valid, obs_desc, obs_ok,
        n_chunks=min(16, ms.max_kf), max_dist=max_hamming, ratio=nn_ratio,
    )
    idx = jnp.where(idx >= 0, obs_pt[jnp.clip(idx, 0)], -1)
    matched = idx >= 0
    X = ms.pt_xyz[jnp.clip(idx, 0)]
    res = pnp.pnp_ransac(key, K, X, feats.uv, matched,
                         quality=max_hamming - mdist)
    # polish the RANSAC pose on its consensus set
    res2 = pose_opt.pose_optimization(
        K, res.pose, X, feats.uv, matched & res.inliers
    )
    assoc = jnp.where(matched & res.inliers & res2.inliers, idx, -1)
    # reference keyframe = the one sharing most recovered points
    P = ms.max_pt
    hit = jnp.zeros((P,), bool).at[jnp.clip(assoc, 0)].max(assoc >= 0)
    shared = jnp.sum(
        hit[jnp.clip(ms.kf_point, 0)] & (ms.kf_point >= 0), axis=1
    ) * ms.kf_valid
    ref_kf = jnp.argmax(shared)
    return TrackResult(
        pose=res2.pose,
        assoc=assoc,
        n_inliers=jnp.sum((assoc >= 0).astype(jnp.int32)),
        n_candidates=jnp.sum(matched.astype(jnp.int32)),
    ), ref_kf


def covis_group_rank(ms: M.MapState, score, eligible, top_k: int):
    """Covisibility-group score accumulation (reference KeyFrameDatabase::
    DetectNBestCandidates, KeyFrameDatabase.cc:604: each candidate's score
    is summed over its covisibility group before ranking, and the group is
    represented by its best individual member).

    One extra [K,K] matmul against the existing covisibility matrix — the
    discrimination this buys shows exactly when several neighbors each
    half-see a place (perceptual aliasing): the true region's group
    accumulates, an alias's lone KF does not.

    Returns (kf_ids [top_k] — best member of each top group, acc_scores).
    """
    score = jnp.where(eligible, score, 0).astype(jnp.float32)
    Wgt = M.covisibility(ms)
    nb = (Wgt >= M.MIN_COVIS_WEIGHT) & eligible[None, :] & eligible[:, None]
    acc = score + nb.astype(jnp.float32) @ score          # group-summed
    acc = jnp.where(eligible, acc, 0.0)
    vals, gids = jax.lax.top_k(acc, top_k)
    # represent each winning group by its highest-scoring member
    self_or_nb = nb[gids].at[jnp.arange(top_k), gids].set(True)
    member_score = jnp.where(self_or_nb, score[None, :], -1.0)
    members = jnp.argmax(member_score, axis=1).astype(jnp.int32)
    return members, vals


@jax.jit
def relocalization_candidates(ms: M.MapState, feats, *, top_k=3):
    """Descriptor-retrieval relocalization candidates: score every KF by its
    number of strong Hamming matches to the frame (replaces the reference's
    DBoW2 inverted index, KeyFrameDatabase::DetectRelocalizationCandidates),
    then accumulate scores over covisibility groups before ranking
    (DetectNBestCandidates, KeyFrameDatabase.cc:604).

    Returns (kf_ids [top_k], group-accumulated scores [top_k]).
    """
    # distance of each frame feature to each KF feature: [F, K*F] is too big
    # at full capacity; instead score against per-point distinctive
    # descriptors grouped by KF via the incidence structure.
    dist = matcher.hamming_matrix(feats.desc, ms.pt_desc)  # [F, P]
    strong = (dist < 50.0) & feats.valid[:, None] & ms.pt_valid[None, :]
    per_point = jnp.any(strong, axis=0)  # [P] point has a strong match
    B = M.incidence(ms)  # [K, P]
    score = jnp.sum(B & per_point[None, :], axis=1)  # [K]
    return covis_group_rank(ms, score, ms.kf_valid, top_k)
