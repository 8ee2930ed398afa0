"""Tests that need a GPU (marked ``gpu``; the ``gpu`` fixture skips them
elsewhere).  Run on the card with ``python -m pytest tests -m gpu``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from rumi_slam_tpu.ops import matcher


def _window_args(F, P, seed=0):
    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    n = min(F, P) // 2
    rows = rng.choice(P, n, replace=False)
    dp[rows] = dq[:n] ^ (rng.random((n, 8)) < 0.03).astype(np.uint32)
    uq = rng.uniform(0, [640, 480], (F, 2)).astype(np.float32)
    up = rng.uniform(0, [640, 480], (P, 2)).astype(np.float32)
    up[rows] = uq[:n] + rng.normal(0, 4, (n, 2)).astype(np.float32)
    return (dq, dp, uq, up, np.float32(15.0), rng.random(F) > 0.05,
            rng.random(P) > 0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("F,P", [(2000, 16384), (300, 1000)])
def test_kernel_on_gpu_equals_cpu_reference(gpu, F, P):
    args = _window_args(F, P)
    fn = jax.jit(lambda *a: matcher.window_match(*a, max_dist=80.0,
                                                 ratio=0.85))
    got = jax.device_get(fn(*jax.device_put(args, gpu)))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = jax.device_get(fn(*jax.device_put(args, cpu)))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert (ref[0] >= 0).sum() > 0


@pytest.mark.gpu
def test_tracking_step_runs_on_gpu(gpu):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from __graft_entry__ import entry
    from rumi_slam_tpu.io.settings import preset

    step, args = entry(preset("tum3"))
    pose, n_inl = jax.block_until_ready(jax.jit(step)(*args))
    assert next(iter(pose.devices())).platform == "gpu"
    assert np.all(np.isfinite(np.asarray(pose)))
