"""MapState: the whole SLAM map as structure-of-arrays tensors.

JAX re-design of the reference's pointer-graph data model — Frame
(/root/reference/src/rumi-slam/lib_src/Frame.cc), KeyFrame (KeyFrame.cc),
MapPoint (MapPoint.cc), Map (Map.cc) and Atlas (Atlas.cc) — as ONE immutable
pytree of fixed-capacity arrays with validity masks:

* ``kf_point [K, F]`` (feature -> point id, -1 none) replaces MapPoint
  observation maps, KeyFrame::mvpMapPoints AND the covisibility graph, which
  becomes a single boolean-incidence matmul (:func:`covisibility`).
* submaps (the reference's Atlas multi-map container) are a ``map_id`` label
  per KF/point — CreateMapInAtlas is a counter bump, map merge is a masked
  relabel instead of CloudMerging's migration loops.
* all updates are functional (`.at[].set`) so threads become snapshots:
  the tracker reads version N while mapping/merge produce N+1 (no
  mMutexMapUpdate).

Capacities are static; slot allocation is a scalar counter.  All functions
here are jit-safe (no data-dependent shapes).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

MIN_COVIS_WEIGHT = 15  # reference KeyFrame::UpdateConnections threshold


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: jnp.ndarray       # [K,7] T_cw
    kf_uv: jnp.ndarray         # [K,F,2] undistorted level-0 pixels
    kf_octave: jnp.ndarray     # [K,F] int32
    kf_angle: jnp.ndarray      # [K,F] float32
    kf_desc: jnp.ndarray       # [K,F,8] uint32
    kf_ur: jnp.ndarray         # [K,F] float32 virtual right u-coordinate
                               #   (stereo/RGB-D; <0 = mono observation —
                               #   reference Frame::mvuRight)
    kf_feat_valid: jnp.ndarray # [K,F] bool
    kf_point: jnp.ndarray      # [K,F] int32 — point id or -1
    kf_time: jnp.ndarray       # [K] float32 seconds
    kf_map_id: jnp.ndarray     # [K] int32 submap label
    kf_valid: jnp.ndarray      # [K] bool
    kf_is_cloud: jnp.ndarray   # [K] bool — KF reconstructed from the
                               #   rumination backend (reference SetCloudFlag)
    # --- points ---
    pt_xyz: jnp.ndarray        # [P,3]
    pt_desc: jnp.ndarray       # [P,8] uint32 distinctive descriptor
    pt_valid: jnp.ndarray      # [P] bool
    pt_map_id: jnp.ndarray     # [P] int32
    pt_ref_kf: jnp.ndarray     # [P] int32
    pt_visible: jnp.ndarray    # [P] float32 — frames where in frustum
    pt_found: jnp.ndarray      # [P] float32 — frames where matched
    pt_octave: jnp.ndarray     # [P] int32 — pyramid level of the latest
                               #   observation (per-octave search radius,
                               #   reference SearchByProjection:39)
    pt_angle: jnp.ndarray      # [P] float32 — keypoint angle of the latest
                               #   observation (rotation-consistency check,
                               #   reference ComputeThreeMaxima)
    # --- counters ---
    n_kf: jnp.ndarray          # scalar int32 next free KF slot
    n_pt: jnp.ndarray          # scalar int32 next free point slot
    active_map: jnp.ndarray    # scalar int32 current submap id
    n_maps: jnp.ndarray        # scalar int32 maps created so far

    @property
    def max_kf(self):
        return self.kf_pose.shape[0]

    @property
    def max_feat(self):
        return self.kf_uv.shape[1]

    @property
    def max_pt(self):
        return self.pt_xyz.shape[0]


def empty(max_kf: int = 256, max_feat: int = 512, max_pt: int = 16384) -> MapState:
    K, F, P = max_kf, max_feat, max_pt
    return MapState(
        kf_pose=jnp.zeros((K, 7), jnp.float32).at[:, 0].set(1.0),
        kf_uv=jnp.zeros((K, F, 2), jnp.float32),
        kf_octave=jnp.zeros((K, F), jnp.int32),
        kf_angle=jnp.zeros((K, F), jnp.float32),
        kf_desc=jnp.zeros((K, F, 8), jnp.uint32),
        kf_ur=jnp.full((K, F), -1.0, jnp.float32),
        kf_feat_valid=jnp.zeros((K, F), bool),
        kf_point=jnp.full((K, F), -1, jnp.int32),
        kf_time=jnp.zeros((K,), jnp.float32),
        kf_map_id=jnp.full((K,), -1, jnp.int32),
        kf_valid=jnp.zeros((K,), bool),
        kf_is_cloud=jnp.zeros((K,), bool),
        pt_xyz=jnp.zeros((P, 3), jnp.float32),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_valid=jnp.zeros((P,), bool),
        pt_map_id=jnp.full((P,), -1, jnp.int32),
        pt_ref_kf=jnp.full((P,), -1, jnp.int32),
        pt_visible=jnp.zeros((P,), jnp.float32),
        pt_found=jnp.zeros((P,), jnp.float32),
        pt_octave=jnp.zeros((P,), jnp.int32),
        pt_angle=jnp.zeros((P,), jnp.float32),
        n_kf=jnp.int32(0),
        n_pt=jnp.int32(0),
        active_map=jnp.int32(0),
        n_maps=jnp.int32(1),
    )


def insert_keyframe(
    ms: MapState, pose, feats, time, point_assoc, *, map_id=None,
    is_cloud=False, ur=None
):
    """Append a keyframe at slot ``ms.n_kf`` (no-op if map is full).

    Args:
      feats: ops.orb.Features with capacity == max_feat.
      point_assoc: [F] int32 feature->point associations (-1 none).
      map_id: submap label (default: active map).
    Returns (ms, kf_id).
    """
    k = ms.n_kf
    ok = k < ms.max_kf
    kc = jnp.clip(k, 0, ms.max_kf - 1)
    mid = ms.active_map if map_id is None else map_id

    def wr(arr, val):
        return jnp.where(ok, arr.at[kc].set(val), arr)

    ms = ms._replace(
        kf_pose=wr(ms.kf_pose, pose),
        kf_uv=wr(ms.kf_uv, feats.uv),
        kf_octave=wr(ms.kf_octave, feats.octave),
        kf_angle=wr(ms.kf_angle, feats.angle),
        kf_desc=wr(ms.kf_desc, feats.desc),
        kf_ur=wr(ms.kf_ur,
                 jnp.full((ms.max_feat,), -1.0, jnp.float32)
                 if ur is None else ur.astype(jnp.float32)),
        kf_feat_valid=wr(ms.kf_feat_valid, feats.valid),
        kf_point=wr(ms.kf_point, jnp.where(feats.valid, point_assoc, -1)),
        kf_time=wr(ms.kf_time, jnp.float32(time)),
        kf_map_id=wr(ms.kf_map_id, jnp.int32(mid)),
        kf_valid=wr(ms.kf_valid, True),
        kf_is_cloud=wr(ms.kf_is_cloud, jnp.asarray(is_cloud)),
        n_kf=jnp.where(ok, k + 1, k),
    )
    return ms, kc


def add_keyframes_bulk(
    ms: MapState, poses, uv, octave, angle, desc, feat_valid, point_assoc,
    times, valid, *, map_id, is_cloud=True
):
    """Append a batch of keyframes (compacting invalid rows), used to import
    a rumination CloudMap (reference ROSMapToORBMap,
    src/cloud_edge_main.cpp:877-1007).  Returns (ms, kf_ids [Mk] with -1)."""
    Mk = poses.shape[0]
    K = ms.max_kf
    offs = jnp.cumsum(valid.astype(jnp.int32)) - 1
    slot = ms.n_kf + offs
    usable = valid & (slot < K)
    slot_c = jnp.clip(slot, 0, K - 1)
    wmask = jnp.zeros((K,), bool).at[slot_c].max(usable)

    def scatter(arr, val):
        upd = jnp.zeros_like(arr).at[slot_c].add(
            jnp.where(usable.reshape((Mk,) + (1,) * (val.ndim - 1)), val, 0)
        )
        return jnp.where(wmask.reshape((K,) + (1,) * (arr.ndim - 1)), upd, arr)

    # kf_point needs -1 (not 0) as its neutral fill
    pa = jnp.where(usable[:, None], jnp.where(feat_valid, point_assoc, -1) + 1, 0)
    kf_point_new = jnp.zeros_like(ms.kf_point).at[slot_c].add(pa) - 1
    kf_point = jnp.where(wmask[:, None], kf_point_new, ms.kf_point)

    feat_valid_new = jnp.zeros(ms.kf_feat_valid.shape, bool).at[slot_c].max(
        jnp.where(usable[:, None], feat_valid, False)
    )
    ms = ms._replace(
        kf_pose=scatter(ms.kf_pose, poses),
        kf_uv=scatter(ms.kf_uv, uv),
        kf_octave=scatter(ms.kf_octave, octave),
        kf_angle=scatter(ms.kf_angle, angle),
        kf_desc=scatter(ms.kf_desc, desc),
        # bulk-imported (cloud) KFs are monocular: ur stays -1 in new slots
        kf_ur=jnp.where(wmask[:, None], -1.0, ms.kf_ur),
        kf_feat_valid=jnp.where(wmask[:, None], feat_valid_new,
                                ms.kf_feat_valid),
        kf_point=kf_point,
        kf_time=scatter(ms.kf_time, times),
        kf_map_id=jnp.where(wmask, jnp.int32(map_id), ms.kf_map_id),
        kf_valid=ms.kf_valid | wmask,
        kf_is_cloud=jnp.where(wmask, jnp.asarray(is_cloud), ms.kf_is_cloud),
        n_kf=jnp.minimum(ms.n_kf + jnp.sum(valid.astype(jnp.int32)), K),
    )
    return ms, jnp.where(usable, slot_c, -1)


def add_points(ms: MapState, xyz, desc, valid, ref_kf, *, map_id=None,
               octave=None, angle=None):
    """Append up to M points (rows with valid=False are skipped by compaction
    on the caller side — here they occupy slots but stay invalid=False... no:
    slots are allocated ONLY for valid rows, using a prefix-sum compaction).

    Args:
      xyz [M,3], desc [M,8], valid [M].
    Returns (ms, ids [M] int32 — allocated slot per row, -1 where invalid).
    """
    M = xyz.shape[0]
    P = ms.max_pt
    mid = ms.active_map if map_id is None else map_id

    offs = jnp.cumsum(valid.astype(jnp.int32)) - 1  # position among valid rows
    slot = ms.n_pt + offs
    usable = valid & (slot < P)
    slot_c = jnp.clip(slot, 0, P - 1)

    wmask = jnp.zeros((P,), bool).at[slot_c].max(usable)

    def scatter(arr, val):
        # .add (not .set): an invalid row shares its slot with the preceding
        # valid row; adding its zero contribution keeps the write exact.
        upd = jnp.zeros_like(arr).at[slot_c].add(
            jnp.where(usable.reshape((M,) + (1,) * (val.ndim - 1)), val, 0)
        )
        return jnp.where(
            wmask.reshape((P,) + (1,) * (arr.ndim - 1)), upd, arr
        )

    ms = ms._replace(
        pt_xyz=scatter(ms.pt_xyz, xyz.astype(jnp.float32)),
        pt_desc=scatter(ms.pt_desc, desc),
        pt_valid=ms.pt_valid | wmask,
        pt_map_id=jnp.where(wmask, jnp.int32(mid), ms.pt_map_id),
        pt_ref_kf=jnp.where(wmask, jnp.int32(ref_kf), ms.pt_ref_kf),
        pt_visible=jnp.where(wmask, 1.0, ms.pt_visible),
        pt_found=jnp.where(wmask, 1.0, ms.pt_found),
        pt_octave=(ms.pt_octave if octave is None
                   else scatter(ms.pt_octave, octave.astype(jnp.int32))),
        pt_angle=(ms.pt_angle if angle is None
                  else scatter(ms.pt_angle, angle.astype(jnp.float32))),
        n_pt=jnp.minimum(ms.n_pt + jnp.sum(valid.astype(jnp.int32)), P),
    )
    ids = jnp.where(usable, slot_c, -1)
    return ms, ids


def set_associations(ms: MapState, kf_id, assoc):
    """Overwrite feature->point associations of one KF ([F] int32, -1 none)."""
    assoc = jnp.where(ms.kf_feat_valid[kf_id], assoc, -1)
    return ms._replace(kf_point=ms.kf_point.at[kf_id].set(assoc))


@jax.jit
def refresh_point_descriptors(ms: MapState, kf_id):
    """Update observed points' representative descriptors from one KF's
    features.  Streaming stand-in for the reference's min-median-Hamming
    ComputeDistinctiveDescriptors (MapPoint.cc): the most recent observation
    wins, which tracks appearance change (scale/viewpoint) for matching."""
    pt = ms.kf_point[kf_id]
    ok = (pt >= 0) & ms.kf_feat_valid[kf_id]
    tgt = jnp.clip(pt, 0)
    upd = ms.pt_desc.at[tgt].set(
        jnp.where(ok[:, None], ms.kf_desc[kf_id], ms.pt_desc[tgt])
    )
    oct_upd = ms.pt_octave.at[tgt].set(
        jnp.where(ok, ms.kf_octave[kf_id], ms.pt_octave[tgt])
    )
    ang_upd = ms.pt_angle.at[tgt].set(
        jnp.where(ok, ms.kf_angle[kf_id], ms.pt_angle[tgt])
    )
    return ms._replace(pt_desc=upd, pt_octave=oct_upd, pt_angle=ang_upd)


def incidence(ms: MapState, map_id=None):
    """Boolean KF x point observation incidence B [K, P]."""
    K, F, P = ms.max_kf, ms.max_feat, ms.max_pt
    rows = jax.lax.broadcasted_iota(jnp.int32, (K, F), 0)
    pt = jnp.clip(ms.kf_point, 0, P - 1)
    obs = (ms.kf_point >= 0) & ms.kf_valid[:, None]
    if map_id is not None:
        obs &= ms.kf_map_id[:, None] == map_id
    B = jnp.zeros((K, P), bool).at[rows, pt].max(obs)
    return B & ms.pt_valid[None, :]


def covisibility(ms: MapState, map_id=None):
    """Covisibility weights [K, K] = number of shared points (reference
    KeyFrame::UpdateConnections; edge iff weight >= 15)."""
    B = incidence(ms, map_id).astype(jnp.bfloat16)
    Wgt = jax.lax.dot_general(
        B, B, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    Wgt = Wgt * (1.0 - jnp.eye(ms.max_kf))
    return Wgt.astype(jnp.int32)


def point_obs_count(ms: MapState):
    """[P] number of observing keyframes per point."""
    return jnp.sum(incidence(ms), axis=0).astype(jnp.int32)


def local_window(ms: MapState, kf_id, *, window: int):
    """Top-``window`` covisible KFs of ``kf_id`` (incl. itself first) — the
    reference's local-BA window (Optimizer.cc:1004-1017).

    Returns (kf_ids [window] int32, valid [window] bool).
    """
    Wgt = covisibility(ms)
    w = Wgt[kf_id] * ms.kf_valid * (ms.kf_map_id == ms.kf_map_id[kf_id])
    w = w.at[kf_id].set(jnp.int32(1 << 30))
    vals, ids = jax.lax.top_k(w, window)
    return ids, vals >= MIN_COVIS_WEIGHT


def relabel_map(ms: MapState, old_id, new_id):
    """Merge submap ``old_id`` into ``new_id`` (the Atlas-level part of the
    reference's CloudMergeMap KF/MP migration, CloudMerging.cc:1560-1612)."""
    return ms._replace(
        kf_map_id=jnp.where(ms.kf_map_id == old_id, new_id, ms.kf_map_id),
        pt_map_id=jnp.where(ms.pt_map_id == old_id, new_id, ms.pt_map_id),
    )


def compact(ms: MapState):
    """Reclaim dead slots: renumber valid KFs/points down to a contiguous
    prefix, remapping every cross-reference (kf_point values, pt_ref_kf).

    The reference frees memory by deleting heap objects
    (KeyFrame::SetBadFlag + erase, KeyFrame.cc); with fixed-capacity SoA
    arrays the equivalent is periodic compaction, so ``max_kf``/``max_pt``
    bound the LIVE map instead of the run length.  Host-level (numpy) — runs
    rarely, at capacity pressure, never inside jit.

    Returns (ms, kf_old2new [K] int32 with -1, pt_old2new [P] int32).
    """
    import numpy as np

    K, F, P = ms.max_kf, ms.max_feat, ms.max_pt
    kf_v = np.asarray(ms.kf_valid)
    pt_v = np.asarray(ms.pt_valid)
    kf_rows = np.flatnonzero(kf_v)
    pt_rows = np.flatnonzero(pt_v)
    nk, npt = len(kf_rows), len(pt_rows)
    kf_map = np.full(K, -1, np.int32)
    kf_map[kf_rows] = np.arange(nk, dtype=np.int32)
    pt_map = np.full(P, -1, np.int32)
    pt_map[pt_rows] = np.arange(npt, dtype=np.int32)

    out = empty(K, F, P)

    def pack_kf(new, old):
        a = np.asarray(new).copy()
        a[:nk] = np.asarray(old)[kf_rows]
        return jnp.asarray(a)

    def pack_pt(new, old):
        a = np.asarray(new).copy()
        a[:npt] = np.asarray(old)[pt_rows]
        return jnp.asarray(a)

    kp = np.asarray(ms.kf_point)[kf_rows]          # [nk, F] old point ids
    kp = np.where(kp >= 0, pt_map[np.clip(kp, 0, None)], -1)
    kf_point = np.full((K, F), -1, np.int32)
    kf_point[:nk] = kp
    ref = np.asarray(ms.pt_ref_kf)[pt_rows]
    ref = np.where(ref >= 0, kf_map[np.clip(ref, 0, None)], -1)
    pt_ref = np.full(P, -1, np.int32)
    pt_ref[:npt] = ref

    ms2 = out._replace(
        kf_pose=pack_kf(out.kf_pose, ms.kf_pose),
        kf_uv=pack_kf(out.kf_uv, ms.kf_uv),
        kf_octave=pack_kf(out.kf_octave, ms.kf_octave),
        kf_angle=pack_kf(out.kf_angle, ms.kf_angle),
        kf_desc=pack_kf(out.kf_desc, ms.kf_desc),
        kf_ur=pack_kf(out.kf_ur, ms.kf_ur),
        kf_feat_valid=pack_kf(out.kf_feat_valid, ms.kf_feat_valid),
        kf_point=jnp.asarray(kf_point),
        kf_time=pack_kf(out.kf_time, ms.kf_time),
        kf_map_id=pack_kf(out.kf_map_id, ms.kf_map_id),
        kf_valid=pack_kf(out.kf_valid, ms.kf_valid),
        kf_is_cloud=pack_kf(out.kf_is_cloud, ms.kf_is_cloud),
        pt_xyz=pack_pt(out.pt_xyz, ms.pt_xyz),
        pt_desc=pack_pt(out.pt_desc, ms.pt_desc),
        pt_valid=pack_pt(out.pt_valid, ms.pt_valid),
        pt_map_id=pack_pt(out.pt_map_id, ms.pt_map_id),
        pt_ref_kf=jnp.asarray(pt_ref),
        pt_visible=pack_pt(out.pt_visible, ms.pt_visible),
        pt_found=pack_pt(out.pt_found, ms.pt_found),
        pt_octave=pack_pt(out.pt_octave, ms.pt_octave),
        pt_angle=pack_pt(out.pt_angle, ms.pt_angle),
        n_kf=jnp.int32(nk),
        n_pt=jnp.int32(npt),
        active_map=ms.active_map,
        n_maps=ms.n_maps,
    )
    return ms2, kf_map, pt_map


def map_kf_count(ms: MapState, map_id):
    return jnp.sum((ms.kf_map_id == map_id) & ms.kf_valid)


def map_duration(ms: MapState, map_id):
    """Timestamp span of a submap (reference Map::KeyFramesDuration)."""
    sel = (ms.kf_map_id == map_id) & ms.kf_valid
    t = ms.kf_time
    tmax = jnp.max(jnp.where(sel, t, -jnp.inf))
    tmin = jnp.min(jnp.where(sel, t, jnp.inf))
    return jnp.where(jnp.any(sel), tmax - tmin, 0.0)


def map_trajectory_curvature(ms: MapState, map_id):
    """Path-length / chord-length of the KF camera centers — the merge gate
    metric (reference Map::ComputeKFCurvature, Map.cc:303-310).

    Uses KF slot order as temporal order (slots are appended in time order).
    """
    from ..geometry import lie

    sel = (ms.kf_map_id == map_id) & ms.kf_valid
    centers = lie.se3_t(jax.vmap(lie.se3_inverse)(ms.kf_pose))  # [K,3]
    # consecutive valid pairs: step to the next valid KF
    self_ = sel[:-1] & sel[1:]
    seg = jnp.linalg.norm(centers[1:] - centers[:-1], axis=-1) * self_
    path = jnp.sum(seg)
    idx = jnp.arange(ms.max_kf)
    first = jnp.argmax(jnp.where(sel, 1, 0))
    last = ms.max_kf - 1 - jnp.argmax(jnp.where(sel, 1, 0)[::-1])
    chord = jnp.linalg.norm(centers[last] - centers[first])
    return jnp.where(chord > 1e-6, path / jnp.maximum(chord, 1e-6), 1.0)
