"""Lost-frame recording + PD-controlled sampling + upload-bundle assembly.

JAX equivalent of the reference's CloudImageSampler + KFDSample + PD
(/root/reference/src/rumi-slam/lib_src/CloudImageSampler.cc:44-202,
KFDSample.cc, include pd.hpp:21-39).  While tracking is lost (or
uninitialized) every raw frame is recorded and a PD-controlled optical-flow
threshold picks a keyframe-density subsample; once the new (edge-back) submap
matures, the upload bundle = tail of edge-front KF images + lost frames +
head of edge-back KF images, sorted by timestamp, is handed to the rumination
backend (the reference ships it to a DROID-SLAM server over ROS actionlib).

Host-side object: the control flow is per-frame sequential and latency-bound;
the only array work (LK flow) is jitted (ops/optical_flow.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import SamplerConfig
from ..ops import optical_flow
from ..ops.fast import fast_score, nms3x3
from ..ops.select import select_keypoints


class PDController:
    """Discrete PD law tracking a flow setpoint (reference pd.hpp:21-39)."""

    def __init__(self, kp: float, kd: float, setpoint: float):
        self.kp, self.kd, self.setpoint = kp, kd, setpoint
        self.prev_err = 0.0

    def step(self, measured: float) -> float:
        err = self.setpoint - measured
        out = self.kp * err + self.kd * (err - self.prev_err)
        self.prev_err = err
        return out

    def reset(self):
        self.prev_err = 0.0


@dataclass
class RecordedFrame:
    time: float
    image: np.ndarray


class LostFrameSampler:
    """Records frames during loss; PD-subsamples by LK flow magnitude."""

    def __init__(self, cfg: SamplerConfig):
        self.cfg = cfg
        self.pd = PDController(cfg.pd_kp, cfg.pd_kd, cfg.pd_setpoint)
        self.all_frames: list[RecordedFrame] = []      # no-sampling list
        self.sampled: list[RecordedFrame] = []         # PD-subsampled list
        self._last_img: Optional[jnp.ndarray] = None
        self._last_pts = None
        self._thresh = cfg.pd_setpoint

    def reset(self):
        self.pd.reset()
        self.all_frames.clear()
        self.sampled.clear()
        self._last_img = None
        self._last_pts = None

    def _reseed_points(self, img):
        score = nms3x3(fast_score(img, 12.0))
        yx, _, valid = select_keypoints(score, 128, cell=24, k_cell=4)
        if int(jnp.sum(valid)) < 20:
            # degraded regime (the frames the sampler exists for: motion
            # blur, contrast collapse — reference KFDSample tracks THROUGH
            # them, KFDSample.cc:131): corners are gone but large-scale
            # gradients survive; seed LK from gradient energy instead
            gy, gx = jnp.gradient(img)
            score = nms3x3(gx * gx + gy * gy)
            yx, _, valid = select_keypoints(score, 128, cell=24, k_cell=4)
        pts = jnp.stack([yx[:, 1], yx[:, 0]], -1).astype(jnp.float32)
        return pts, valid

    def record(self, img, t: float):
        """Feed one lost/uninitialized frame."""
        self.all_frames.append(RecordedFrame(t, np.asarray(img)))
        if self._last_img is None:
            self._select(img, t)
            return
        flow = float(
            optical_flow.mean_flow_magnitude(
                self._last_img, img, self._last_pts[0], self._last_pts[1]
            )
        )
        # adaptive threshold = flow setpoint + PD correction
        self._thresh = max(1.0, self.cfg.pd_setpoint + self.pd.step(flow))
        if flow >= self._thresh:
            self._select(img, t)

    def _select(self, img, t: float):
        self.sampled.append(RecordedFrame(t, np.asarray(img)))
        self._last_img = img
        self._last_pts = self._reseed_points(img)


class BundleAssembler:
    """Builds the upload bundle once the edge-back map matures
    (reference CloudImageSampler.cc:81-201)."""

    def __init__(self, cfg: SamplerConfig):
        self.cfg = cfg

    def gates_pass(self, n_back_kf: int, back_duration: float,
                   back_curvature: float) -> bool:
        return (
            n_back_kf >= self.cfg.n_new_track_first
            and back_duration >= self.cfg.min_time_s
            # reference nNewTrackFirstMinTrajCurvature (default 0 = disabled,
            # CloudImageSampler.h:80; the paper used 1.2 — straight
            # trajectories merge badly)
            and back_curvature > self.cfg.min_traj_curvature
        )

    def assemble(
        self,
        front_kf_frames: list[RecordedFrame],
        lost_frames: list[RecordedFrame],
        back_kf_frames: list[RecordedFrame],
    ) -> Optional[list[RecordedFrame]]:
        """front tail (≤ n_track_last) + lost + back head, time-sorted.
        Returns None if the bundle is too small (reference asserts >=30
        frames and >=1 lost image, CloudImageSampler.cc:180-183)."""
        front = front_kf_frames[-min(self.cfg.n_track_last, self.cfg.max_track_last):]
        back = back_kf_frames[: self.cfg.n_new_track_first]
        return self.combine(front, lost_frames, back)

    def combine(
        self,
        front: list[RecordedFrame],
        lost_frames: list[RecordedFrame],
        back: list[RecordedFrame],
    ) -> Optional[list[RecordedFrame]]:
        """Gap-filter lost frames, merge + time-sort + dedup, size-gate.
        Callers that already sized their context windows (the coordinator's
        full-rate windows) use this directly; :meth:`assemble` adds the
        reference's KF-tail trimming on top."""
        if not lost_frames:
            return None
        lo = front[-1].time if front else -np.inf
        hi = back[0].time if back else np.inf
        lost = [f for f in lost_frames if lo < f.time < hi]
        bundle = sorted(front + lost + back, key=lambda f: f.time)
        # dedup identical timestamps
        out: list[RecordedFrame] = []
        for f in bundle:
            if not out or f.time > out[-1].time + 1e-9:
                out.append(f)
        if len(out) < self.cfg.min_bundle or not lost:
            return None
        return out
