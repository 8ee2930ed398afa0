"""Entry points on a machine without a GPU, the compile-cache placement, and
the windowed matcher at shapes that do not tile."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_entry_points_refuse_cpu(script):
    out = _run([os.path.join(REPO, script)])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Outside a checkout (no package beside it) the script fails cleanly."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], cwd=tmp_path, PYTHONPATH="")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


_CACHE_PROBE = """
import jax, jax.numpy as jnp
from rumi_slam_tpu.utils import compile_cache
print(compile_cache.configure())
print(jax.config.jax_compilation_cache_dir)
"""


def test_compile_cache_follows_env(tmp_path):
    d = tmp_path / "cache"
    out = _run(["-c", _CACHE_PROBE + """
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7.0)).block_until_ready()
"""], JAX_COMPILATION_CACHE_DIR=str(d))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(d), str(d)]
    assert any(d.iterdir()), "nothing was written to the cache directory"


def test_compile_cache_default_is_fixed_path_in_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert out.stdout.split() == [want, want]
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_library_import_sets_no_cache():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run(
        [sys.executable, "-c", "import rumi_slam_tpu.system, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"


def test_dryrun_multichip_refuses_too_few_devices():
    sys.path.insert(0, REPO)
    from __graft_entry__ import dryrun_multichip

    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"needs {n} devices"):
        dryrun_multichip(n)


def _popcount_window_match(dq, dp, uq, up, radius, vq, vp, max_dist, ratio):
    from rumi_slam_tpu.ops import matcher

    return matcher.match(matcher.hamming_matrix_popcount(dq, dp), vq, vp,
                         mask=matcher.radius_mask(uq, up, radius),
                         max_dist=max_dist, ratio=ratio)


@pytest.mark.parametrize("F,P", [(300, 1000), (77, 4096), (1000, 333)])
def test_window_match_equals_popcount_reference(F, P):
    """track_frame's matcher against the popcount oracle, at query and point
    counts that are not multiples of any tile."""
    from rumi_slam_tpu.ops import matcher

    rng = np.random.default_rng(F + P)
    dq = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    n = min(F, P) // 2
    rows = rng.choice(P, n, replace=False)
    dp[rows] = dq[:n] ^ (rng.random((n, 8)) < 0.03).astype(np.uint32)
    uq = rng.uniform(0, [640, 480], (F, 2)).astype(np.float32)
    up = rng.uniform(0, [640, 480], (P, 2)).astype(np.float32)
    up[rows] = uq[:n] + rng.normal(0, 4, (n, 2)).astype(np.float32)
    args = [jnp.asarray(x) for x in (dq, dp, uq, up)]
    vq, vp = jnp.asarray(rng.random(F) > 0.05), jnp.asarray(rng.random(P) > 0.1)
    got = matcher.window_match(*args, 15.0, vq, vp, max_dist=80.0, ratio=0.85)
    ref = _popcount_window_match(*args, 15.0, vq, vp, 80.0, 0.85)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    assert int((np.asarray(ref[0]) >= 0).sum()) > n // 4


def test_track_frame_runs_at_untiled_feature_count():
    """F = 300 queries against a 1000-slot map: shapes flow through the
    matcher, the post-filters and motion-only BA."""
    from rumi_slam_tpu.geometry import camera, lie
    from rumi_slam_tpu.mapstate import map_state as M
    from rumi_slam_tpu.ops.orb import Features
    from rumi_slam_tpu.tracking import tracker

    rng = np.random.default_rng(3)
    F, P = 300, 1000
    K = jnp.asarray([260.0, 260.0, 159.5, 119.5])
    X = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (P, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    ms = M.empty(4, F, P)._replace(
        pt_xyz=jnp.asarray(X), pt_desc=jnp.asarray(desc),
        pt_valid=jnp.ones(P, bool), pt_map_id=jnp.zeros(P, jnp.int32),
        n_pt=jnp.int32(P))
    pose = lie.se3_identity()
    uv = np.asarray(camera.project_world(K, pose, jnp.asarray(X))[0])
    feats = Features(
        uv=jnp.asarray(uv[:F]), response=jnp.ones(F), angle=jnp.zeros(F),
        octave=jnp.zeros(F, jnp.int32), desc=jnp.asarray(desc[:F]),
        valid=jnp.ones(F, bool))
    ms2, tr = tracker.track_frame(ms, K, feats, pose, 15.0, img_w=320,
                                  img_h=240)
    assert tr.assoc.shape == (F,)
    assert int(tr.n_inliers) > 50
    np.testing.assert_allclose(np.asarray(tr.pose), np.asarray(pose),
                               atol=1e-3)
