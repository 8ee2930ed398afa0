"""End-to-end test of the TUM dataset driver (examples/run_tum.py) on a
synthetic sequence written to disk in TUM layout (rgb.txt + pngs +
groundtruth.txt) — the reference's RunTxt replay contract."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_tum_dir(tmp_path, n_frames=30):
    from PIL import Image

    from rumi_slam_tpu.geometry import lie
    from rumi_slam_tpu.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=n_frames, width=320, height=240,
                            n_points=1500, seed=4, patch=3)
    (tmp_path / "rgb").mkdir(parents=True)
    lines = []
    for i in range(len(seq)):
        img, t = seq.frame(i)
        arr = np.asarray(img, np.uint8)
        Image.fromarray(arr, mode="L").save(tmp_path / "rgb" / f"{t:.6f}.png")
        lines.append(f"{t:.6f} rgb/{t:.6f}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(lines) + "\n")

    gt_lines = []
    for i in range(len(seq)):
        Twc = np.asarray(lie.se3_inverse(jnp.asarray(seq.poses_gt[i])))
        qw, qx, qy, qz = Twc[:4]
        tx, ty, tz = Twc[4:7]
        gt_lines.append(
            f"{seq.times[i]:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
            f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
        )
    (tmp_path / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return seq


@pytest.mark.slow
def test_run_tum_driver(tmp_path):
    pytest.importorskip("PIL")
    _write_tum_dir(tmp_path)

    # settings matching the synthetic camera (fx = 0.8 * width)
    yaml = tmp_path / "cam.yaml"
    yaml.write_text(
        "%YAML:1.0\n"
        "Camera1.fx: 256.0\nCamera1.fy: 256.0\n"
        "Camera1.cx: 159.5\nCamera1.cy: 119.5\n"
        "Camera.width: 320\nCamera.height: 240\nCamera.fps: 30\n"
        "ORBextractor.nFeatures: 256\nORBextractor.nLevels: 3\n"
    )

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "run_tum.py"),
         "--data", str(tmp_path), "--preset", str(yaml),
         "--out", str(tmp_path / "results"), "--no-rumination"],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]

    # result dir artifacts (reference result.csv + traj.png, whole_map.txt)
    runs = list((tmp_path / "results").iterdir())
    assert len(runs) == 1
    run = runs[0]
    assert (run / "whole_map.txt").exists()
    assert (run / "keyframes.txt").exists()
    assert (run / "traj.png").stat().st_size > 1000
    with open(run / "result.csv") as f:
        row = next(csv.DictReader(f))
    assert float(row["ate"]) < 0.2, row
    assert int(row["n_kf"]) >= 2


def test_paced_replay_drops_when_tracker_slow(tmp_path):
    """run_tum's paced loop (native SPSC ring, drop-oldest): a tracker
    slower than the replay clock MUST lose frames, and the loss must be
    counted — the reference's realtime semantics
    (cloud_edge_main.cpp:597-610).  Drives run_paced directly with a
    deliberately slow tracker stub."""
    import time

    from rumi_slam_tpu.runtime import native

    if not native.available():
        pytest.skip("native runtime not built")
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from run_tum import run_paced

    class Seq:
        times = np.arange(40) / 30.0
        _rgb_paths = ["f.png"] * 40    # non-PNM -> python producer path

        def __len__(self):
            return 40

        def frame(self, i):
            return np.full((24, 32), float(i), np.float32), float(self.times[i])

    class SlowSlam:
        tracked = []

        def track_monocular(self, img, t):
            self.tracked.append(t)
            time.sleep(0.08)       # 80 ms/frame vs 33 ms cadence

    slam = SlowSlam()
    drops, n_tracked = run_paced(slam, None, Seq(), str(tmp_path), pace=1.0)
    assert drops > 0, "slow tracker must drop frames"
    assert n_tracked + drops == 40
    assert n_tracked == len(slam.tracked)
