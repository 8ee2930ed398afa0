"""RuminationCoordinator: glues sampler, backend, and merge into a SlamSystem.

Plays the role of the reference's edge-node orchestration around the cloud
action client (/root/reference/src/rumi-slam/src/cloud_edge_main.cpp:460-542 —
poll upload bundle, send actionlib goal, receive CloudMap, InsertCloudMap ->
CloudMerging queue) plus the CloudMerging::Run driver (CloudMerging.cc:96-412:
merge cloud->front then back->front, retire the back map, make the merged map
current).

The coordinator owns a frame ring buffer (timestamp -> image) standing in for
the reference's per-map image retention (KeyFrame::SetImgGray /
Atlas::ClearOldMapImages) and a LostFrameSampler.  ``synchronous=True`` runs
the backend inline (the reference's wait_cloud_result mode); asynchronous
deployment moves ``_run_rumination`` onto the rumination shard.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..geometry import lie
from ..mapstate import map_state as M
from ..system import SlamSystem, TrackState
from . import cloud_map as CM
from . import merge as merge_mod
from .backend import RuminationBackend
from .sampler import BundleAssembler, LostFrameSampler, RecordedFrame


def insert_cloud_map(ms: M.MapState, cm: CM.CloudMap, map_id):
    """Import a CloudMap into the MapState as submap ``map_id``."""
    cm = CM.reduce_feature_capacity(cm, ms.max_feat)
    desc = cm.kf_desc
    if desc is None:
        desc = jnp.zeros(cm.kf_uv.shape[:2] + (8,), jnp.uint32)
    angle = cm.kf_angle
    if angle is None:
        angle = jnp.zeros(cm.kf_uv.shape[:2], jnp.float32)

    # points first: remap table old row -> new row
    pt_desc = jnp.zeros((cm.pt_xyz.shape[0], 8), jnp.uint32)
    ms, pt_ids = M.add_points(
        ms, cm.pt_xyz, pt_desc, cm.pt_valid, ms.n_kf, map_id=map_id
    )
    remap = jnp.where(cm.kf_point >= 0, pt_ids[jnp.clip(cm.kf_point, 0)], -1)

    ms, kf_ids = M.add_keyframes_bulk(
        ms, cm.kf_pose, cm.kf_uv, cm.kf_octave, angle, desc,
        cm.kf_feat_valid, remap, cm.kf_time, cm.kf_valid,
        map_id=map_id, is_cloud=True,
    )
    return ms, kf_ids


def correct_pose(T_cw, S):
    """Re-express a camera pose after its world was transformed by Sim3 S."""
    Q = lie.sim3_compose(lie.sim3_from_se3(T_cw), lie.sim3_inverse(S))
    return lie.se3(Q[:4], Q[4:7] / lie.sim3_scale(Q))


class RuminationCoordinator:
    def __init__(self, slam: SlamSystem, config: Optional[Config] = None,
                 *, backend: Optional[RuminationBackend] = None,
                 ring_capacity: int = 600, async_shard=None):
        self.slam = slam
        self.cfg = config or slam.cfg
        self.sampler = LostFrameSampler(self.cfg.sampler)
        self.assembler = BundleAssembler(self.cfg.sampler)
        self.backend = backend or RuminationBackend(self.cfg)
        self.ring: list[RecordedFrame] = []
        self.ring_capacity = ring_capacity
        self.front_map_id: Optional[int] = None
        self.merged_maps: set[int] = set()
        self.key = jax.random.PRNGKey(42)
        self.history: list[dict] = []
        # async mode: an AsyncRuminationShard (rumination/remote.py) — the
        # reference's non-blocking actionlib goal; None = inline/synchronous
        # (the reference's wait_cloud_result mode)
        self.shard = async_shard
        self._pending: Optional[dict] = None
        self._anchor_times: list[float] = []
        self._anchor_split: Optional[float] = None
        slam.image_recorder = self.on_frame

    # ------------------------------------------------------------------
    def on_frame(self, img, t: float, state: TrackState):
        self.ring.append(RecordedFrame(t, np.asarray(img)))
        if len(self.ring) > self.ring_capacity:
            self.ring.pop(0)
        if state in (TrackState.RECENTLY_LOST, TrackState.LOST,
                     TrackState.NOT_INITIALIZED):
            if self.slam.stats["n_new_maps"] > 0 or state != TrackState.NOT_INITIALIZED:
                self.sampler.record(jnp.asarray(img), t)

    # ------------------------------------------------------------------
    def _frames_for_times(self, times: np.ndarray) -> list[RecordedFrame]:
        out = []
        ring_t = np.asarray([f.time for f in self.ring])
        for t in times:
            if len(ring_t) == 0:
                break
            j = int(np.argmin(np.abs(ring_t - t)))
            if abs(ring_t[j] - t) < 1e-4:
                out.append(self.ring[j])
        return out

    def maybe_ruminate(self) -> Optional[dict]:
        """Call once per frame (or less) from the driver loop.  When two
        un-merged submaps exist and the new one passes the maturity gates,
        runs the full rumination: bundle -> backend -> insert -> double merge.
        With an async shard the backend build overlaps tracking (the
        reference's actionlib flow); results are merged when :meth:`poll`
        delivers them.  Returns an info dict when a merge was attempted."""
        # async: harvest a finished build first (reference ActionFinishCb)
        if self.shard is not None:
            done = self.shard.poll()
            if done is not None and self._pending is not None:
                _, cm = done
                info, self._pending = self._pending, None
                info["backend_weld"] = getattr(
                    getattr(self.shard, "backend", None), "last_weld_info",
                    None)
                if cm is None:
                    info["result"] = "backend_failed"
                    err = getattr(self.shard, "last_error", None)
                    if err is not None:
                        info["backend_error"] = repr(err)
                    else:
                        info["backend_reason"] = getattr(
                            getattr(self.shard, "backend", None),
                            "last_failure", None)
                    self.merged_maps.add(info["back"])
                    self.history.append(info)
                    return info
                return self._finish_rumination(info, cm)

        slam = self.slam
        ms = slam.ms
        n_maps = slam.n_maps_host      # host mirrors: no per-frame device
        active = slam.active_map_host  # round-trips in the gate checks
        if n_maps < 2 or active in self.merged_maps:
            return None
        if self._pending is not None and self._pending["back"] == active:
            return None  # build in flight for this map
        front = active - 1
        while front in self.merged_maps and front > 0:
            front -= 1
        if front == active or front < 0:
            return None
        # maturity gates on the new (edge-back) map
        sc = self.cfg.sampler
        n_back = int(M.map_kf_count(ms, active))
        dur = float(M.map_duration(ms, active))
        if n_back < sc.n_new_track_first or dur < sc.min_time_s:
            return None
        if int(M.map_kf_count(ms, front)) < 2:
            self.merged_maps.add(front)
            return None
        return self._run_rumination(front, active)

    # ------------------------------------------------------------------
    def _frames_in_window(self, lo: float, hi: float, cap: int):
        """All ring frames with lo <= t <= hi, uniformly thinned to cap.

        The reference ships KF-subsampled images because its DROID backend
        tracks across arbitrary baselines (CloudImageSampler.cc:104-145);
        a sparse-feature backend needs temporal density, so the context
        windows around the gap go at full frame rate within a bounded span."""
        out = [f for f in self.ring if lo <= f.time <= hi]
        if len(out) > cap:
            idx = np.unique(np.linspace(0, len(out) - 1, cap).astype(int))
            out = [out[i] for i in idx]
        return out

    def _assemble_bundle(self, info: dict, front: int, back: int):
        ms = self.slam.ms
        kf_t = np.asarray(ms.kf_time)
        kf_m = np.asarray(ms.kf_map_id)
        kf_v = np.asarray(ms.kf_valid)
        t_front = np.sort(kf_t[(kf_m == front) & kf_v])
        t_back = np.sort(kf_t[(kf_m == back) & kf_v])
        sc = self.cfg.sampler
        # PRIMARY: KF-subsampled context windows — the reference ships KF
        # images, not full frame rate (CloudImageSampler.cc:104-145); the
        # backend chains across KF baselines the same way the live tracker
        # does, and the upload shrinks ~5x
        front_frames = self._frames_for_times(
            t_front[t_front >= t_front[-1] - sc.context_window_s]
            [-sc.n_track_last:])
        back_frames = self._frames_for_times(
            t_back[t_back <= t_back[0] + sc.context_window_s]
            [: sc.n_new_track_first])
        # fallback: full-rate windows when the KF cadence left too little
        # context for the backend to anchor on
        if len(front_frames) < 4 or len(back_frames) < 4:
            front_frames = self._frames_in_window(
                t_front[-1] - sc.context_window_s, t_front[-1],
                sc.max_track_last)
            back_frames = self._frames_in_window(
                t_back[0], t_back[0] + sc.context_window_s,
                sc.max_track_last)
        if not front_frames or not back_frames:
            front_frames = self._frames_for_times(t_front)
            back_frames = self._frames_for_times(t_back)
        if not front_frames or not back_frames:
            # ring buffer no longer holds frames near either map's KF
            # timestamps (long gap + late maturation overran the capacity)
            info["result"] = "no_ring_frames"
            return None
        # anchors: live-KF timestamps inside the context windows — the
        # backend forces keyframes there so the CloudMap's timestamps
        # intersect the live maps' (the merge's association key)
        self._anchor_times = [
            float(t) for t in np.concatenate([t_front, t_back])
            if (front_frames[0].time - 1e-6 <= t
                <= back_frames[-1].time + 1e-6)
        ]
        # a time strictly between the two live maps' keyframes: the
        # backend's span gate (build must cover both sides of it)
        self._anchor_split = 0.5 * (float(t_front[-1]) + float(t_back[0]))
        # the PD-subsampled lost list is the PRIMARY payload (reference
        # CloudImageSampler.cc:147-151 filters mvLostImages — the
        # KFDSample-selected list — into mvCurrentCloudProcessImages); the
        # raw no-sampling list is only the fallback when sampling left too
        # few frames for the backend to chain (reference's >=5 sampled gate,
        # CloudImageSampler.cc:89-91)
        sampled = self.sampler.sampled
        raw = self.sampler.all_frames
        lost = sampled if len(sampled) >= 5 else raw
        bundle = self.assembler.combine(front_frames, lost, back_frames)
        info["n_lost_raw"] = len(raw)
        info["n_lost_sampled"] = len(sampled)
        if bundle is not None:
            info["bundle_size"] = len(bundle)
            # upload bandwidth accounting (reference measures the upload bag
            # MB, cloud_edge_main.cpp:487-497): record BOTH what was shipped
            # and what the un-sampled bundle would have cost, so the PD
            # bandwidth win is a measured number
            info["upload_mb"] = sum(f.image.nbytes for f in bundle) / 1e6
            raw_bundle = (
                bundle if lost is raw
                else self.assembler.combine(front_frames, raw, back_frames)
            )
            info["upload_mb_raw"] = (
                sum(f.image.nbytes for f in raw_bundle) / 1e6
                if raw_bundle is not None else info["upload_mb"]
            )
        return bundle

    def _run_rumination(self, front: int, back: int) -> Optional[dict]:
        info: dict = {"front": front, "back": back}
        bundle = self._assemble_bundle(info, front, back)
        if bundle is None:
            if info.get("result") == "no_ring_frames":
                # unrecoverable for this map pair: the images are gone
                self.merged_maps.add(back)
            else:
                info["result"] = "bundle_too_small"
            self.history.append(info)
            return info

        # the reference clears its sampler state when the bundle is
        # PUBLISHED, not when the merge concludes (CloudImageSampler.cc:
        # 190-199) — so a later loss gap after a failed merge starts from a
        # clean lost list instead of inheriting this gap's frames
        self.sampler.reset()

        if self.shard is not None:
            if self.shard.submit(back, bundle,
                                 anchor_times=self._anchor_times,
                                 anchor_split=self._anchor_split):
                self._pending = info
            return None  # result harvested by a later poll

        # --- synchronous: backend builds the cloud submap inline
        cm = self.backend.build(bundle,
                                anchor_times=self._anchor_times,
                                anchor_split=self._anchor_split)
        info["backend_weld"] = getattr(self.backend, "last_weld_info", None)
        if cm is None:
            info["result"] = "backend_failed"
            info["backend_reason"] = getattr(self.backend, "last_failure",
                                             None)
            # one attempt per matured map — the reference marks BOTH maps
            # merged when the bundle is published, before any result
            # (CloudImageSampler.cc:190-191); without this the coordinator
            # re-runs the full backend build every frame forever
            self.merged_maps.add(info["back"])
            self.history.append(info)
            return info
        return self._finish_rumination(info, cm)

    def _merge_with_retry(self, ms, K, src, dst, key):
        """merge_submaps with ONE retry under widened association
        tolerances on a recoverable failure (the reference's merge_anyway
        spirit, launch/main.launch:34 — a single rejected Sim3 solve,
        CloudMerging.cc:815-824, need not doom the rumination)."""
        import dataclasses

        mc = self.cfg.merge
        k1, k2 = jax.random.split(key)
        ms, ok, i = merge_mod.merge_submaps(ms, K, src, dst, mc, k1)
        if ok or not mc.retry_widened:
            return ms, ok, i
        if i.get("reason") not in ("no_point_pairs", "low_inliers"):
            return ms, ok, i      # no_kf_matches cannot improve with radius
        wide = dataclasses.replace(
            mc, pixel_radius=mc.retry_pixel_radius,
            min_inlier_ratio=mc.retry_min_inlier_ratio)
        ms, ok, i2 = merge_mod.merge_submaps(ms, K, src, dst, wide, k2)
        i2["retried"] = True
        i2["first_attempt"] = i
        return ms, ok, i2

    def _finish_rumination(self, info: dict, cm) -> dict:
        slam = self.slam
        # single-writer contract: finish any overlapped mapping round before
        # the merge rewrites poses/points (tracking/mapping_worker.py)
        if hasattr(slam, "sync_mapping"):
            slam.sync_mapping()
        ms = slam.ms
        front, back = info["front"], info["back"]

        # --- import + double merge (cloud->front, back->front)
        cloud_id = slam.n_maps_host
        ms = ms._replace(n_maps=ms.n_maps + 1)
        slam.n_maps_host += 1
        ms, cloud_kf_ids = insert_cloud_map(ms, cm, cloud_id)
        # capacity accounting: add_keyframes_bulk silently drops rows past
        # max_kf — surface it, and fail fast when nothing landed (the merge
        # would otherwise report a misleading no_kf_matches)
        n_cloud = int(jnp.sum(cm.kf_valid))
        n_inserted = int(jnp.sum(cloud_kf_ids >= 0))
        info["n_cloud_kf"] = n_cloud
        if n_inserted < n_cloud:
            info["cloud_kf_dropped"] = n_cloud - n_inserted
        if n_inserted < 2:
            slam.ms = ms._replace(
                kf_valid=ms.kf_valid & (ms.kf_map_id != cloud_id),
                pt_valid=ms.pt_valid & (ms.pt_map_id != cloud_id),
            )
            info["result"] = "kf_capacity_full"
            self.merged_maps.add(back)
            self.history.append(info)
            return info

        self.key, k1, k2 = jax.random.split(self.key, 3)
        ms, ok1, i1 = self._merge_with_retry(
            ms, slam.K, cloud_id, front, k1)
        info["cloud_merge"] = i1
        if not ok1:
            # drop the cloud map, keep tracking in the back map
            ms = ms._replace(
                kf_valid=ms.kf_valid & (ms.kf_map_id != cloud_id),
                pt_valid=ms.pt_valid & (ms.pt_map_id != cloud_id),
            )
            slam.ms = ms
            info["result"] = "cloud_merge_failed"
            self.merged_maps.add(back)  # don't retry forever
            self.history.append(info)
            return info

        ms, ok2, i2 = self._merge_with_retry(ms, slam.K, back, front, k2)
        info["back_merge"] = i2
        if ok2:
            # tracking continues in the merged (front) map; correct the
            # tracker's cached pose by the back-map transform
            ms = ms._replace(active_map=jnp.int32(front))
            slam.active_map_host = front
            if self.cfg.merge.run_gba:
                from ..parallel.distributed import ba_mesh
                from ..tracking.local_mapping import global_bundle_adjustment

                # >1 visible device routes through the distributed PCG
                # Schur engine (psum over the "ba" mesh axis); single chip
                # falls through to the dense-Schur solve
                mesh = ba_mesh()
                ms = global_bundle_adjustment(
                    ms, slam.K, front, n_iters=self.cfg.merge.gba_iters,
                    mesh=mesh,
                )
                info["gba"] = "pcg" if mesh is not None else "dense"
            slam.ms = ms
            # the back map world moved: recompute last_pose from its KF
            if slam.last_kf_id >= 0:
                slam.last_pose = ms.kf_pose[slam.last_kf_id]
                slam.velocity = lie.se3_identity()
            self.merged_maps.add(back)
            self.merged_maps.add(cloud_id)
            info["result"] = "merged"
        else:
            slam.ms = ms
            self.merged_maps.add(back)
            info["result"] = "back_merge_failed"
        self.history.append(info)
        return info
