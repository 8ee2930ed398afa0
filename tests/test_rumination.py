"""Tests for the rumination subsystem: sampler, Sim3 merge machinery.

The merge tests construct two submaps of the SAME synthetic scene expressed
in different world frames (one Sim3-distorted), with overlapping-timestamp
keyframes — exactly the geometry of the reference's cloud-merge problem —
and verify the pipeline recovers the Sim3 and welds the maps.
"""

import jax
import jax.numpy as jnp
import numpy as np

from rumi_slam_tpu.config import Config, MergeConfig, SamplerConfig
from rumi_slam_tpu.geometry import camera, lie
from rumi_slam_tpu.mapstate import map_state as M
from rumi_slam_tpu.ops.orb import Features
from rumi_slam_tpu.rumination import merge as merge_mod
from rumi_slam_tpu.rumination.sampler import BundleAssembler, PDController, RecordedFrame

RNG = np.random.default_rng(31)
K = jnp.asarray([260.0, 260.0, 159.5, 119.5])


def _features(uv, desc, F):
    return Features(uv=uv, response=jnp.ones(F), angle=jnp.zeros(F),
                    octave=jnp.zeros(F, jnp.int32), desc=desc,
                    valid=jnp.ones(F, bool))


def build_two_submaps(F=96, n_shared_kf=4):
    """One scene; map 0 in true world frame, map 1 Sim3-distorted; KF pairs
    at identical timestamps observing the same points."""
    ms = M.empty(max_kf=32, max_feat=F, max_pt=2048)
    X = jnp.asarray(RNG.uniform([-2, -1.5, 3], [2, 1.5, 8], (F, 3)).astype(np.float32))
    desc = jnp.asarray(RNG.integers(0, 2**32, (F, 8), dtype=np.uint32))

    S_true = lie.sim3_make(
        lie.so3_exp(jnp.asarray([0.05, -0.1, 0.08])),
        jnp.asarray([0.5, -0.3, 0.9]),
        jnp.asarray(1.4),
    )  # maps map-1 world -> map-0 world
    S_inv = lie.sim3_inverse(S_true)
    X_1 = lie.sim3_apply(S_inv, X)  # same points in map-1 world

    # map 0: KFs at t = 0..n-1;  map 1: same times (timestamp association)
    ms, pid0 = M.add_points(ms, X, desc, jnp.ones(F, bool), 0, map_id=0)
    ms, pid1 = M.add_points(ms, X_1, desc, jnp.ones(F, bool), 0, map_id=1)

    for i in range(n_shared_kf):
        T0 = lie.se3(lie.so3_exp(jnp.asarray([0.0, 0.01 * i, 0.0])),
                     jnp.asarray([0.1 * i, 0.0, 0.0]))
        uv0, _ = camera.project_world(K, T0, X)
        ms, _ = M.insert_keyframe(ms, T0, _features(uv0, desc, F), float(i),
                                  pid0, map_id=0)
        # the corresponding map-1 KF sees the SAME pixels (same physical
        # camera): pose in map-1 world is T0 ∘ S_true (as Sim3, normalized)
        Q = lie.sim3_compose(lie.sim3_from_se3(T0), S_true)
        T1 = lie.se3(Q[:4], Q[4:7] / lie.sim3_scale(Q))
        uv1, _ = camera.project_world(K, T1, X_1)
        ms, _ = M.insert_keyframe(ms, T1, _features(uv1, desc, F), float(i),
                                  pid1, map_id=1)
    ms = ms._replace(n_maps=jnp.int32(2))
    return ms, S_true, X


class TestKFMatching:
    def test_matches_by_time(self):
        ms, _, _ = build_two_submaps()
        m = merge_mod.match_kfs_by_time(
            ms.kf_time, ms.kf_valid, ms.kf_map_id, 0, 1, max_pairs=8)
        assert int(jnp.sum(m.valid)) == 4
        # each dst KF paired with the equal-time src KF
        for i in range(8):
            if bool(m.valid[i]):
                td = float(ms.kf_time[m.dst_kf[i]])
                ts = float(ms.kf_time[m.src_kf[i]])
                assert abs(td - ts) < 1e-6


class TestSim3Recovery:
    def test_compute_submap_sim3(self):
        ms, S_true, X = build_two_submaps()
        m = merge_mod.match_kfs_by_time(
            ms.kf_time, ms.kf_valid, ms.kf_map_id, 0, 1, max_pairs=8)
        pairs = merge_mod.associate_points(ms, m, radius=3.0)
        assert int(jnp.sum(pairs.valid)) > 100
        S, ratio, inl = merge_mod.compute_submap_sim3(
            jax.random.PRNGKey(0), K, ms, m, pairs)
        assert float(ratio) > 0.8
        # S should map map-1 points onto map-0 points
        X1 = ms.pt_xyz[96:192]
        err = jnp.linalg.norm(lie.sim3_apply(S, X1) - ms.pt_xyz[:96], axis=-1)
        assert float(jnp.median(err)) < 0.02
        assert abs(float(lie.sim3_scale(S)) - 1.4) < 0.02


class TestFullMerge:
    def test_merge_submaps(self):
        ms, S_true, X = build_two_submaps()
        cfg = MergeConfig(max_match_kf=8)
        ms2, ok, info = merge_mod.merge_submaps(
            ms, K, src_id=1, dst_id=0, cfg=cfg, key=jax.random.PRNGKey(1))
        assert ok, info
        assert info["inlier_ratio"] > 0.5
        # all KFs now in map 0
        assert int(M.map_kf_count(ms2, 1)) == 0
        assert int(M.map_kf_count(ms2, 0)) == 8
        # duplicate points fused: valid point count dropped
        assert int(jnp.sum(ms2.pt_valid)) < int(jnp.sum(ms.pt_valid))
        # transformed src KF poses consistent with dst KFs at same time:
        # paired KFs observed the same scene from the same physical camera
        for i in range(4):
            Ta = ms2.kf_pose[2 * i]      # map-0 KF
            Tb = ms2.kf_pose[2 * i + 1]  # was map-1 KF, now corrected
            e = lie.se3_log(lie.se3_compose(Ta, lie.se3_inverse(Tb)))
            assert float(jnp.linalg.norm(e)) < 0.05, f"pair {i}"

    def test_merge_rejects_garbage(self):
        ms, _, _ = build_two_submaps()
        # destroy src map geometry -> association still fires (pixels match)
        # but Sim3 inliers collapse
        ms = ms._replace(
            pt_xyz=jnp.where(
                (ms.pt_map_id == 1)[:, None],
                jnp.asarray(RNG.uniform(-20, 20, ms.pt_xyz.shape).astype(np.float32)),
                ms.pt_xyz,
            )
        )
        cfg = MergeConfig(max_match_kf=8)
        ms2, ok, info = merge_mod.merge_submaps(
            ms, K, src_id=1, dst_id=0, cfg=cfg, key=jax.random.PRNGKey(2))
        assert not ok


class TestSampler:
    def test_pd_controller_tracks_setpoint(self):
        pd = PDController(0.8, 0.08, 12.0)
        out_high = pd.step(30.0)   # flow above setpoint -> negative corr.
        assert out_high < 0
        out_low = pd.step(2.0)
        assert out_low > 0

    def test_bundle_assembly(self):
        cfg = SamplerConfig(n_track_last=5, n_new_track_first=5, min_bundle=8)
        asm = BundleAssembler(cfg)
        front = [RecordedFrame(float(t), np.zeros((4, 4))) for t in range(10)]
        lost = [RecordedFrame(9.5 + 0.1 * i, np.zeros((4, 4))) for i in range(5)]
        back = [RecordedFrame(10.0 + t, np.zeros((4, 4))) for t in range(6)]
        bundle = asm.assemble(front, lost, back)
        assert bundle is not None
        times = [f.time for f in bundle]
        assert times == sorted(times)
        assert times[0] == 5.0  # only the front tail
        # lost frames inside the gap are included
        assert any(9.4 < t < 10.0 for t in times)

    def test_bundle_rejects_no_lost(self):
        cfg = SamplerConfig(min_bundle=5)
        asm = BundleAssembler(cfg)
        front = [RecordedFrame(float(t), np.zeros((4, 4))) for t in range(10)]
        back = [RecordedFrame(20.0 + t, np.zeros((4, 4))) for t in range(10)]
        assert asm.assemble(front, [], back) is None


def test_sync_backend_failure_is_single_attempt():
    """Regression (r4): a failed synchronous backend build must mark the
    back map attempted — the reference marks both maps merged when the
    bundle is PUBLISHED (CloudImageSampler.cc:190-191), before any result.
    Without it the coordinator re-ran the full backend build every frame."""
    from rumi_slam_tpu.config import tiny_config
    from rumi_slam_tpu.rumination.coordinator import RuminationCoordinator
    from rumi_slam_tpu.system import SlamSystem
    from test_async_rumination import FakeBackend, _bundle

    slam = SlamSystem(tiny_config())
    backend = FakeBackend(fail=True, delay=0.0)
    coord = RuminationCoordinator(slam, slam.cfg, backend=backend)
    coord._assemble_bundle = lambda info, f, b: _bundle(10)

    info = coord._run_rumination(0, 1)
    assert info["result"] == "backend_failed"
    assert info["backend_reason"] == "fake: told to fail"
    assert backend.calls == 1
    # the back map is now marked attempted: maybe_ruminate's
    # `active in merged_maps` guard prevents any further build
    assert 1 in coord.merged_maps


def test_sampler_reset_on_publish_fences_failed_merges():
    """VERDICT r4 #8: the sampler clears when the bundle is PUBLISHED
    (reference CloudImageSampler.cc:190-199), so a later loss gap after a
    FAILED rumination builds its bundle from its own lost frames only —
    stale frames from the first gap must not leak into the second bundle."""
    import jax.numpy as jnp

    from rumi_slam_tpu.config import tiny_config
    from rumi_slam_tpu.rumination.coordinator import RuminationCoordinator
    from rumi_slam_tpu.rumination.sampler import RecordedFrame
    from rumi_slam_tpu.system import SlamSystem
    from test_async_rumination import FakeBackend, _bundle

    slam = SlamSystem(tiny_config())
    backend = FakeBackend(fail=True, delay=0.0)
    coord = RuminationCoordinator(slam, slam.cfg, backend=backend)
    coord._assemble_bundle = lambda info, f, b: _bundle(10)

    # first gap: record lost frames, attempt fails
    img = jnp.zeros((8, 8), jnp.float32)
    for i in range(6):
        coord.sampler.record(img, 1.0 + 0.1 * i)
    assert coord.sampler.all_frames
    info = coord._run_rumination(0, 1)
    assert info["result"] == "backend_failed"
    # publish cleared the sampler: the failed merge leaves no stale frames
    assert not coord.sampler.all_frames and not coord.sampler.sampled

    # second gap records fresh frames only
    for i in range(4):
        coord.sampler.record(img, 9.0 + 0.1 * i)
    times = [f.time for f in coord.sampler.all_frames]
    assert min(times) >= 9.0, times
