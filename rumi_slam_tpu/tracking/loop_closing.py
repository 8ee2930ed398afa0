"""Loop closing: place recognition + Sim3 verification + pose-graph correction.

JAX equivalent of the reference's LoopClosing thread
(/root/reference/src/rumi-slam/lib_src/LoopClosing.cc): candidate detection
(NewDetectCommonRegions / KeyFrameDatabase::DetectNBestCandidates, BoW),
Sim3Solver RANSAC + projection verification, and CorrectLoop (:916) with
OptimizeEssentialGraph (:1108).  The rumination merge largely supersedes
spontaneous map merging in RUMI (SURVEY.md §2.1 LoopClosing row), but the
subsystem remains part of the capability set, so it is provided here:

* detection replaces the DBoW2 inverted index with batched Hamming retrieval
  (the same incidence-scoring primitive as relocalization), masked to exclude
  covisible neighbors and temporally-recent KFs;
* verification is descriptor-matched 3D-3D Horn RANSAC + reprojection
  inlier gating (the merge module's Sim3 machinery with descriptor pairs
  instead of pixel-radius pairs);
* correction runs the Sim(3) essential-graph optimizer (optim.pose_graph)
  and moves points with their reference keyframes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import alignment, camera, lie
from ..mapstate import map_state as M
from ..ops import matcher
from ..optim import pose_graph


class LoopCandidate(NamedTuple):
    kf_id: jnp.ndarray
    score: jnp.ndarray


@partial(jax.jit, static_argnames=("top_k", "min_time_gap_slots"))
def detect_loop_candidates(ms: M.MapState, kf_id, *, top_k: int = 3,
                           min_time_gap_slots: int = 20):
    """Retrieval-based loop candidates for one keyframe.

    Excludes the query's covisibility neighborhood (reference excludes
    connected KFs in DetectNBestCandidates) and temporally-near slots.
    """
    feats_desc = ms.kf_desc[kf_id]
    feats_valid = ms.kf_feat_valid[kf_id]

    dist = matcher.hamming_matrix(feats_desc, ms.pt_desc)  # [F,P]
    strong = (dist < 50.0) & feats_valid[:, None] & ms.pt_valid[None, :]
    per_point = jnp.any(strong, axis=0)
    B = M.incidence(ms)
    score = jnp.sum(B & per_point[None, :], axis=1)

    covis = M.covisibility(ms)[kf_id] >= M.MIN_COVIS_WEIGHT
    slot_gap = jnp.abs(jnp.arange(ms.max_kf) - kf_id) < min_time_gap_slots
    same_map = ms.kf_map_id == ms.kf_map_id[kf_id]
    eligible = ms.kf_valid & same_map & ~covis & ~slot_gap
    # covisibility-group accumulation before ranking (reference
    # DetectNBestCandidates, KeyFrameDatabase.cc:604)
    from . import tracker as _tr

    ids, vals = _tr.covis_group_rank(ms, score, eligible, top_k)
    return LoopCandidate(kf_id=ids, score=vals)


@partial(jax.jit, static_argnames=("n_hyp",))
def verify_loop(key, K, ms: M.MapState, kf_query, kf_cand, *,
                n_hyp: int = 256, thresh_px: float = 6.0,
                max_hamming=matcher.TH_LOW, nn_ratio=0.85):
    """Descriptor-matched Sim3 verification between two KFs.

    Returns (S [8] sim3 mapping cand-side world onto query-side world — for
    an intra-map loop both sides share the world, so S captures accumulated
    DRIFT — n_inliers, pairs-as-arrays for welding).
    """
    # match query KF features (with points) against candidate KF features
    # (with points) by descriptor
    d_q = ms.kf_desc[kf_query]
    d_c = ms.kf_desc[kf_cand]
    pt_q = ms.kf_point[kf_query]
    pt_c = ms.kf_point[kf_cand]
    has_q = (pt_q >= 0) & ms.kf_feat_valid[kf_query]
    has_c = (pt_c >= 0) & ms.kf_feat_valid[kf_cand]

    dist = matcher.hamming_matrix(d_q, d_c)
    idx, _ = matcher.match(dist, has_q, has_c, max_dist=max_hamming,
                           ratio=nn_ratio)
    matched = idx >= 0
    Xq = ms.pt_xyz[jnp.clip(pt_q, 0)]                      # [F,3]
    Xc = ms.pt_xyz[jnp.clip(pt_c[jnp.clip(idx, 0)], 0)]    # [F,3]

    # Horn RANSAC on 3D-3D pairs (drift Sim3)
    probs = jnp.log(jnp.maximum(matched.astype(jnp.float32), 1e-12))
    hyp_idx = jax.random.categorical(
        key, probs[None, :].repeat(n_hyp * 3, 0)).reshape(n_hyp, 3)
    S_h = jax.vmap(lambda ii: alignment.horn_alignment(Xc[ii], Xq[ii]))(hyp_idx)

    T_q = ms.kf_pose[kf_query]
    uv_q = ms.kf_uv[kf_query]

    def inliers(S):
        X_hat = lie.sim3_apply(S, Xc)
        uv_hat, depth = camera.project_world(K, T_q, X_hat)
        err = jnp.linalg.norm(uv_hat - uv_q, axis=-1)
        return matched & (err < thresh_px) & (depth > 0.05)

    def inliers_at(S, t):
        X_hat = lie.sim3_apply(S, Xc)
        uv_hat, depth = camera.project_world(K, T_q, X_hat)
        err = jnp.linalg.norm(uv_hat - uv_q, axis=-1)
        return matched & (err < t) & (depth > 0.05)

    scores = jax.vmap(lambda S: jnp.sum(inliers(S)))(S_h)
    best = jnp.argmax(scores)
    S = S_h[best]
    # refinement (the reference follows Sim3Solver RANSAC with
    # OptimizeSim3, LoopClosing.cc — a minimal 3-point hypothesis rarely
    # nails the Sim3 under monocular scale drift): re-fit weighted Horn on
    # the consensus set at a relaxed gate, then once at the final gate
    for relax in (2.0, 1.0):
        w = inliers_at(S, relax * thresh_px).astype(jnp.float32)
        S_ref = alignment.horn_alignment(Xc, Xq, w)
        S = jnp.where(jnp.sum(w) >= 3, S_ref, S)
    inl = inliers(S)
    return S, jnp.sum(inl), inl


def close_loop(ms: M.MapState, K, kf_query: int, kf_cand: int, S_drift,
               *, min_covis_edge: int = 100):
    """Correct the map after a verified loop (reference CorrectLoop):
    build essential-graph edges from current poses, override the loop edge
    with the drift-corrected measurement, optimize, move the points.

    Host-level function (edge-list construction is data-dependent).
    """
    kf_sim3 = lie.sim3_from_se3(ms.kf_pose)
    covis = M.covisibility(ms)
    edges = pose_graph.build_edges_from_covisibility(
        kf_sim3, covis, np.asarray(ms.kf_valid),
        min_weight=min_covis_edge,
    )
    # drift-corrected measurement on the loop edge: the verified Sim3 says
    # the candidate-side geometry maps onto the query side by S_drift, so the
    # corrected query pose is  S_q_corr = S_q * S_drift^-1  and the loop edge
    # (q, c) measures  S_q_corr * S_c^-1.
    S_q_corr = lie.sim3_compose(kf_sim3[kf_query], lie.sim3_inverse(S_drift))
    loop_meas = lie.sim3_compose(S_q_corr, lie.sim3_inverse(kf_sim3[kf_cand]))
    e_i = jnp.concatenate([edges.i, jnp.asarray([kf_query], jnp.int32)])
    e_j = jnp.concatenate([edges.j, jnp.asarray([kf_cand], jnp.int32)])
    e_S = jnp.concatenate([edges.S_ij, loop_meas[None]], axis=0)
    e_w = jnp.concatenate([edges.weight, jnp.asarray([5.0], jnp.float32)])
    edges = pose_graph.PoseGraphEdges(i=e_i, j=e_j, S_ij=e_S, weight=e_w)

    fixed = jnp.zeros(ms.max_kf, bool).at[kf_cand].set(True)
    fixed = fixed | ~ms.kf_valid
    S_new = pose_graph.optimize_pose_graph(kf_sim3, edges, fixed, n_iters=8)

    new_pt = pose_graph.correct_points(
        ms.pt_xyz, ms.pt_ref_kf, ms.pt_valid, kf_sim3, S_new
    )
    # back to SE3: divide translation by scale
    s = lie.sim3_scale(S_new)
    new_pose = lie.se3(S_new[:, :4], S_new[:, 4:7] / s[:, None])
    new_pose = jnp.where(ms.kf_valid[:, None], new_pose, ms.kf_pose)
    return ms._replace(kf_pose=new_pose, pt_xyz=new_pt)
