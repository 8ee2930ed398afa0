"""Async rumination shard: the edge/cloud split as a dedicated-device worker
(reference actionlib sendGoal/ActionFinishCb flow, cloud_edge_main.cpp:530/733)."""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from rumi_slam_tpu.config import tiny_config
from rumi_slam_tpu.rumination import cloud_map
from rumi_slam_tpu.rumination.remote import AsyncRuminationShard, pick_rumination_device
from rumi_slam_tpu.rumination.sampler import RecordedFrame


class FakeBackend:
    """Deterministic stand-in (the reference's mock actionlib server,
    scripts/utils/cloud_action_scripts/server.py)."""

    def __init__(self, delay=0.05, fail=False):
        self.delay = delay
        self.fail = fail
        self.calls = 0

    def build(self, bundle, anchor_times=(), anchor_split=None):
        self.calls += 1
        time.sleep(self.delay)
        if self.fail:
            self.last_failure = "fake: told to fail"
            return None
        n_kf, n_feat, n_pt = 4, 8, 16
        return cloud_map.CloudMap(
            kf_pose=jnp.zeros((n_kf, 7)).at[:, 0].set(1.0),
            kf_uv=jnp.zeros((n_kf, n_feat, 2)),
            kf_octave=jnp.zeros((n_kf, n_feat), jnp.int32),
            kf_angle=None,
            kf_desc=None,
            kf_feat_valid=jnp.ones((n_kf, n_feat), bool),
            kf_point=jnp.full((n_kf, n_feat), -1, jnp.int32),
            kf_time=jnp.arange(n_kf, dtype=jnp.float32),
            kf_valid=jnp.ones(n_kf, bool),
            pt_xyz=jnp.zeros((n_pt, 3)),
            pt_valid=jnp.ones(n_pt, bool),
        )


def _bundle(n=5):
    return [RecordedFrame(float(i), np.zeros((8, 8), np.float32))
            for i in range(n)]


def test_submit_poll_roundtrip():
    shard = AsyncRuminationShard(tiny_config(), backend=FakeBackend())
    try:
        assert shard.submit(7, _bundle())
        assert shard.busy or shard.poll() is not None  # racing is fine
        deadline = time.time() + 10
        got = None
        while got is None and time.time() < deadline:
            got = shard.poll()
            time.sleep(0.01)
        assert got is not None
        job, cm = got
        assert job == 7
        assert cm is not None and int(cm.kf_valid.sum()) == 4
        assert not shard.busy
    finally:
        shard.shutdown()


def test_refuses_overlapping_goals():
    shard = AsyncRuminationShard(tiny_config(), backend=FakeBackend(delay=0.3))
    try:
        assert shard.submit(1, _bundle())
        assert not shard.submit(2, _bundle())  # saturated
        deadline = time.time() + 10
        while shard.poll() is None and time.time() < deadline:
            time.sleep(0.01)
        assert shard.submit(3, _bundle())  # free again
    finally:
        shard.shutdown()


def test_backend_failure_reported():
    shard = AsyncRuminationShard(tiny_config(), backend=FakeBackend(fail=True))
    try:
        assert shard.submit(9, _bundle())
        deadline = time.time() + 10
        got = None
        while got is None and time.time() < deadline:
            got = shard.poll()
            time.sleep(0.01)
        assert got == (9, None)
    finally:
        shard.shutdown()


def test_pick_rumination_device():
    dev = pick_rumination_device()
    devs = jax.devices()
    if len(devs) > 1:
        assert dev is devs[-1]
    else:
        assert dev is None


def test_backend_steps_over_blank_frames_and_says_why_it_failed():
    """Covered-lens frames never reach the builder's tracker, and a build
    that returns None names the gate it failed."""
    from rumi_slam_tpu.rumination.backend import RuminationBackend

    backend = RuminationBackend(tiny_config())
    blank = np.full((240, 320), 40.0, np.float32)
    assert backend._is_blank(blank)
    assert not backend._is_blank(
        np.random.default_rng(0).uniform(0, 255, (240, 320)))
    bundle = [RecordedFrame(i / 30.0, blank) for i in range(6)]
    assert backend.build(bundle) is None
    assert backend.last_failure == "too_few_tracked: 0 KF, 0 OK of 6 frames"
