"""Rumination backend: the non-realtime back-submap builder.

Replaces the reference's external DROID-SLAM "cloud" server (README.md:92-96;
/root/reference is only the edge — the cloud process is out-of-repo, its
output contract defined by scripts/utils/test_export_dvoid_output_to_rosmsg_
new.py).  Here the backend is our OWN batched SLAM over the uploaded bundle
(SURVEY.md §7: "the back-submap builder itself is our own batched SLAM ...
it only needs to produce the CloudMap contract").

Runs offline (no realtime pacing), with generous per-frame budgets, on the
~30-130 bundle frames.  In the distributed deployment this executes on the
rumination shard's devices (parallel/), fully overlapped with realtime
tracking.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Config
from ..system import SlamSystem, TrackState
from . import cloud_map
from .sampler import RecordedFrame


class RuminationBackend:
    """Builds a back submap from an upload bundle of frames."""

    def __init__(self, config: Config):
        import dataclasses

        # forensics from the most recent cross-gap weld (anchor counts,
        # scale estimate + spread) — surfaced into the merge info rows
        self.last_weld_info: Optional[dict] = None
        # why the most recent build returned None (None after a success)
        self.last_failure: Optional[str] = None

        # offline budgets: the bundle is short (~30-130 frames) and paid for
        # once, so keyframe every frame and give up on dead frames fast (the
        # reference's cloud DROID-SLAM likewise keyframes densely and runs
        # without realtime constraints)
        self.cfg = dataclasses.replace(
            config,
            tracking=dataclasses.replace(
                config.tracking,
                kf_min_interval=1,
                # NEVER reset: offline, the builder must reconnect across the
                # loss gap: try relocalization briefly, then open a SECOND
                # submap for the back side — build() welds the two submaps
                # with a descriptor-matched Sim3 afterwards (the global-
                # geometry move the reference's DROID backend makes: it links
                # frames by estimated covisibility, not temporal adjacency)
                reloc_window_s=0.35,
                new_map_min_kf=3,
                new_map_min_duration_s=0.05,
                match_radius=60.0,
                match_radius_wide=120.0,
                # bundle images are KF-subsampled (big inter-frame baselines):
                # initialization cannot demand realtime-level overlap
                init_min_matches=max(40, config.tracking.init_min_matches // 2),
                init_min_inliers=max(30, config.tracking.init_min_inliers // 2),
            ),
            # offline budget: double the feature count — the back-submap must
            # relocalize across the loss gap from sparse, wide-baseline views
            # (the reference's DROID backend is likewise far heavier per frame
            # than the edge tracker)
            # lower FAST thresholds: bundle frames are blur-homogenized
            # (_normalize), which damps corner response across the board
            orb=dataclasses.replace(
                config.orb, n_features=max(512, config.orb.n_features),
                ini_th_fast=12.0, min_th_fast=5.0,
            ),
        )

    #: appearance-homogenization blur sigma for bundle frames (see
    #: _normalize); 0 disables
    BUNDLE_BLUR_SIGMA = 2.5

    @staticmethod
    def _is_blank(img) -> bool:
        return float(np.asarray(img, np.float32).std()) < 1.0

    @classmethod
    def _normalize(cls, img: np.ndarray) -> np.ndarray:
        """Homogenize a bundle frame's appearance (offline pre-processing
        the realtime tracker cannot afford per-frame).

        Loss-gap imagery is blurred + contrast-collapsed while the context
        windows are sharp; ORB descriptors across that appearance boundary
        do not match, which would split the reconstruction exactly at the
        seam the backend exists to bridge.  So every frame is brought to
        the bundle's lowest common appearance: blur the sharp frames to
        the gap's smoothness, then restore dynamic range.  Blur-matched
        descriptors between consecutive frames then match through the
        whole bundle — the sparse-feature analogue of how the reference's
        dense DROID backend tracks through degraded spans."""
        import jax.numpy as jnp

        from ..ops import image as I

        img = np.asarray(img, np.float32)
        if cls._is_blank(img):
            return img      # truly blank (covered lens): nothing to recover
        s = float(img.std())
        if cls.BUNDLE_BLUR_SIGMA > 0:
            img = np.asarray(I.gaussian_blur(
                jnp.asarray(img), sigma=cls.BUNDLE_BLUR_SIGMA,
                radius=int(3 * cls.BUNDLE_BLUR_SIGMA)))
            s = max(float(img.std()), 1e-3)
        return np.clip((img - img.mean()) * (48.0 / s) + 110.0, 0.0, 255.0)

    def build(self, bundle: list[RecordedFrame],
              anchor_times=(), anchor_split: Optional[float] = None,
              ) -> Optional[cloud_map.CloudMap]:
        """Run offline SLAM over the bundle; return one spanning submap as a
        CloudMap, or None if reconstruction failed.

        ``anchor_times``: timestamps the edge holds keyframes at — the
        backend forces keyframes there so the CloudMap shares exact
        timestamps with the live maps, which is what the merge's timestamp
        data-association keys on (reference CloudMerging.cc:147-164; its
        DROID backend gets this for free because the upload IS the KF list).
        ``anchor_split``: a time strictly between the front-map and
        back-map anchors; when given, the returned map must hold keyframes
        on BOTH sides of it (the double merge needs timestamp matches into
        both live maps — a one-sided reconstruction would pass the old
        frame-count gates and then poison the merge).

        If the loss gap split the reconstruction into two submaps, weld them
        with a descriptor-matched Sim3 between their best-matching keyframe
        pair (Horn RANSAC on 3D-3D pairs, tracking/loop_closing.verify_loop)
        — the bundle-global association the reference delegates to DROID's
        covisibility factor graph."""
        import jax.numpy as jnp

        anchor_times = np.asarray(sorted(anchor_times))
        self.last_failure = None
        slam = SlamSystem(self.cfg)
        ok_frames = 0
        for f in bundle:
            if self._is_blank(f.image):
                # a covered-lens frame carries nothing to track: offline
                # there is no deadline, so the builder steps over it and
                # bridges the gap on its motion model instead of losing
                # the track (prior-free relocalization from the first
                # frame after the gap is unreliable, see ROADMAP)
                continue
            if (len(anchor_times)
                    and np.min(np.abs(anchor_times - f.time)) < 1e-4):
                # force the staleness trigger of NeedNewKeyFrame so an
                # anchor frame (if tracked OK) becomes a keyframe
                slam.frames_since_kf = max(slam.frames_since_kf, 15)
            st = slam.track_monocular(
                jnp.asarray(self._normalize(f.image)), f.time)
            if st == TrackState.OK:
                ok_frames += 1
        if slam.stats["n_kf"] < 4 or ok_frames < 4:
            self.last_failure = (f"too_few_tracked: {slam.stats['n_kf']} KF, "
                                 f"{ok_frames} OK of {len(bundle)} frames")
            return None
        ms = slam.ms
        from ..mapstate import map_state as M

        counts = [
            int(M.map_kf_count(ms, m)) for m in range(int(ms.n_maps))
        ]
        order = np.argsort(counts)[::-1]
        best = int(order[0])
        if counts[best] < 4:
            self.last_failure = f"largest_submap_too_small: {counts}"
            return None
        self.last_weld_info = None
        if len(order) > 1 and counts[int(order[1])] >= 2:
            second = int(order[1])
            welded = self._weld_submaps(slam, best, second)
            if welded is None:
                # reverse direction: PnP the big map's keyframes against
                # the small map's points.  Asymmetry is real — descriptor
                # refresh makes the most recent observation win
                # (map_state.refresh_point_descriptors), so a submap that
                # tracked INTO the degraded gap holds blur-matched point
                # descriptors its sharp counterparts lack; whichever side
                # owns the boundary appearance should serve as PnP target.
                welded = self._weld_submaps(slam, second, best)
                if welded is not None:
                    best = second
            if welded is not None:
                # post-weld refinement: the Sim3 weld leaves a seam (scale
                # from a handful of PnP anchors); a full BA over the welded
                # bundle map is affordable offline and straightens it
                # before the CloudMap ships (the reference's DROID backend
                # ships a jointly-optimized map for the same reason)
                from ..tracking.local_mapping import global_bundle_adjustment

                welded = global_bundle_adjustment(
                    welded, slam.K, best, n_iters=8)
                ms = welded
        if anchor_split is not None and len(anchor_times):
            # the double merge keys on timestamp matches into BOTH live
            # maps: the shipped map must hold keyframes at anchor times on
            # each side of the split, else it cannot weld the gap
            kf_t = np.asarray(ms.kf_time)[
                np.asarray(ms.kf_valid)
                & (np.asarray(ms.kf_map_id) == best)]
            fa = anchor_times[anchor_times < anchor_split]
            bb = anchor_times[anchor_times > anchor_split]
            def _hits(side):
                return (len(side) > 0 and len(kf_t) > 0
                        and float(np.min(np.abs(
                            kf_t[:, None] - side[None, :]))) < 1e-3)
            if not (_hits(fa) and _hits(bb)):
                # one-sided reconstruction: useless to merge
                self.last_failure = (
                    f"one_sided: submap KF counts {counts}, front anchors "
                    f"hit {_hits(fa)}, back anchors hit {_hits(bb)}")
                return None
        return cloud_map.from_map_state(ms, best)

    def _weld_submaps(self, slam: SlamSystem, dst_map: int, src_map: int,
                      *, min_inliers: int = 10):
        """Sim3-weld ``src_map`` into ``dst_map`` inside the backend's own
        MapState; returns the welded MapState or None.

        Method: PnP each src keyframe's raw features against the dst
        submap's observation bank (tracker.relocalize_map — guided-sampling
        DLT RANSAC), giving each src KF a pose IN DST WORLD.  Two or more
        such poses fix the inter-map scale by baseline ratio, and any anchor
        fixes the rigid part: S = T_dst(b)^-1 ∘ scale(s) ∘ T_src(b).  This
        avoids Horn on 3D-3D pairs, which is fragile against the newborn
        back submap's depth noise."""
        import jax
        import jax.numpy as jnp

        from ..geometry import lie
        from ..mapstate import map_state as M
        from ..ops import orb
        from ..tracking import tracker

        ms = slam.ms
        kf_map = np.asarray(ms.kf_map_id)
        kf_v = np.asarray(ms.kf_valid)
        src_rows = np.flatnonzero(kf_v & (kf_map == src_map))
        if len(src_rows) < 2:
            return None

        # anchor attempts: bias toward the keyframes temporally NEAREST the
        # dst submap (appearance/view overlap concentrates at the boundary
        # between the two reconstructions), plus a spread sample so a
        # revisit deeper in the submap can still anchor
        if len(src_rows) > 8:
            kf_time = np.asarray(ms.kf_time)
            dst_t = kf_time[kf_v & (kf_map == dst_map)]
            lo, hi = float(dst_t.min()), float(dst_t.max())
            st = kf_time[src_rows]
            dist = np.where(st < lo, lo - st,
                            np.where(st > hi, st - hi, 0.0))
            near = src_rows[np.argsort(dist)[:5]]
            pick = np.unique(np.linspace(0, len(src_rows) - 1, 4).astype(int))
            src_try = np.unique(np.concatenate([near, src_rows[pick]]))
        else:
            src_try = src_rows
        anchors = []  # (n_inl, row, T_dst [7])
        tries = []
        for rank, b in enumerate(src_try):
            feats = orb.Features(
                uv=ms.kf_uv[b], response=jnp.zeros_like(ms.kf_angle[b]),
                angle=ms.kf_angle[b], octave=ms.kf_octave[b],
                desc=ms.kf_desc[b], valid=ms.kf_feat_valid[b],
            )
            tr, _ = tracker.relocalize_map(
                jax.random.PRNGKey(1000 + rank), ms, slam.K, feats,
                map_id=dst_map,
            )
            tries.append((float(np.asarray(ms.kf_time)[b]),
                          int(tr.n_inliers)))
            if int(tr.n_inliers) >= min_inliers:
                anchors.append((int(tr.n_inliers), int(b), tr.pose))
        self.last_weld_tries = {"dst": int(dst_map), "src": int(src_map),
                                "pnp": tries}
        if len(anchors) < 2:
            return None
        anchors.sort(reverse=True)

        def center(T):
            return np.asarray(lie.se3_t(lie.se3_inverse(T)))

        # scale: least-squares fit of bd ≈ s * bs over anchor pairs
        # (s = Σ bd·bs / Σ bs²) — long baselines dominate naturally, so a
        # 2-anchor estimate from nearly-coincident PnP poses cannot hijack
        # the scale the way a bare ratio median could (VERDICT r4 weak #6)
        bds, bss = [], []
        for i in range(len(anchors)):
            for j in range(i + 1, len(anchors)):
                bd = np.linalg.norm(center(anchors[i][2]) - center(anchors[j][2]))
                bs = np.linalg.norm(
                    center(ms.kf_pose[anchors[i][1]])
                    - center(ms.kf_pose[anchors[j][1]])
                )
                if bs > 1e-6 and bd > 1e-6:
                    bds.append(bd)
                    bss.append(bs)
        if not bds:
            return None
        bds, bss = np.asarray(bds), np.asarray(bss)
        s = float(np.dot(bds, bss) / np.dot(bss, bss))
        self.last_weld_info = {
            "n_anchors": len(anchors),
            "anchor_inliers": [a[0] for a in anchors],
            "scale": s,
            "scale_ratio_spread": (
                float(np.max(bds / bss) / np.min(bds / bss))
                if len(bds) > 1 else 1.0),
        }

        # S = T_dst(b)^-1 ∘ diag(s) ∘ T_src(b) from the strongest anchor
        _, b, T_dst = anchors[0]
        S_scale = jnp.asarray([1.0, 0, 0, 0, 0, 0, 0, np.log(s)], jnp.float32)
        S = lie.sim3_compose(
            lie.sim3_from_se3(lie.se3_inverse(T_dst)),
            lie.sim3_compose(S_scale, lie.sim3_from_se3(ms.kf_pose[b])),
        )

        from .coordinator import correct_pose

        sel_kf = jnp.asarray(kf_v & (kf_map == src_map))
        sel_pt = ms.pt_valid & (ms.pt_map_id == src_map)
        new_poses = jax.vmap(lambda T: correct_pose(T, S))(ms.kf_pose)
        new_pts = lie.sim3_apply(S, ms.pt_xyz)
        ms = ms._replace(
            kf_pose=jnp.where(sel_kf[:, None], new_poses, ms.kf_pose),
            pt_xyz=jnp.where(sel_pt[:, None], new_pts, ms.pt_xyz),
        )
        return M.relabel_map(ms, src_map, dst_map)
