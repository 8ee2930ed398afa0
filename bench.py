"""Benchmark: the jitted per-frame tracking step on one GPU.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...} that
names the device it ran on.  Exits non-zero, printing no result, when JAX's
first device is not a GPU.

The reference's per-frame hot loop (ORB extraction + projection matching +
motion-only BA, /root/reference/src/rumi-slam/lib_src/Tracking.cc:1364-2520)
runs at a 30 fps input cadence (config/TUM3.yaml Camera.fps, BASELINE.md)
with a budget of 2000 ORB features x 8 pyramid levels.

Two numbers, both over frames that each consume a DIFFERENT pre-staged
camera frame:

* ``value`` / throughput_fps — pipelined dispatch (the device runs frames
  back-to-back; only the final result blocks).  vs_baseline is this over the
  30 fps input cadence.
* ``latency_p50_ms`` / ``latency_p95_ms`` — BLOCKING per-frame latency
  (the host blocks on every frame's result), against the 33 ms deadline.

Headline budget 2048 features (the reference's 2000, rounded up); the
1024-feature operating point is reported as ``secondary_1024``.  The step:
pyramid, FAST, bucketed top-k, orientation+BRIEF, int8 Hamming match
against a 16,384-slot map holding 2048 points, 3x6 LM pose iterations
(tracker.track_frame's motion-only BA; the reference runs 4x10 with early
exit, Optimizer.cc:723).  This times a bare step, not ``SlamSystem``.
"""

import json
import time

import numpy as np


def build_step(n_features: int):
    """Jitted per-frame step at a given feature budget; returns
    (step, frames, ms, pose)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from rumi_slam_tpu.config import Config
    from rumi_slam_tpu.geometry import lie
    from rumi_slam_tpu.io.synthetic import SyntheticSequence
    from rumi_slam_tpu.mapstate import map_state as M
    from rumi_slam_tpu.ops import orb
    from rumi_slam_tpu.tracking import tracker

    cfg = Config()
    cfg = dataclasses.replace(
        cfg, orb=dataclasses.replace(cfg.orb, n_features=n_features))
    K = cfg.intrinsics()
    H, W = cfg.camera.height, cfg.camera.width

    ms = M.empty(cfg.mapping.max_kf, cfg.orb.n_features, cfg.mapping.max_pt)
    rng = np.random.default_rng(0)
    n_seed = 2048
    ms = ms._replace(
        pt_xyz=ms.pt_xyz.at[:n_seed].set(jnp.asarray(
            rng.uniform([-3, -2, 2], [3, 2, 12], (n_seed, 3)).astype(np.float32))),
        pt_desc=ms.pt_desc.at[:n_seed].set(jnp.asarray(
            rng.integers(0, 2**32, (n_seed, 8), dtype=np.uint32))),
        pt_valid=ms.pt_valid.at[:n_seed].set(True),
        pt_map_id=ms.pt_map_id.at[:n_seed].set(0),
        n_pt=jnp.int32(n_seed),
    )
    pose = lie.se3_identity()
    o = cfg.orb

    def step(img, ms, pose):
        feats = orb.extract_orb(
            img, n_features=o.n_features, n_levels=o.n_levels,
            scale_factor=o.scale_factor, threshold=o.ini_th_fast,
            min_threshold=o.min_th_fast, cell=o.cell, k_cell=o.k_cell,
        )
        ms2, tr = tracker.track_frame(
            ms, K, feats, pose, cfg.tracking.match_radius,
            img_w=W, img_h=H,
        )
        return tr.pose, tr.n_inliers

    seq = SyntheticSequence(n_frames=32, width=W, height=H,
                            n_points=3000, seed=7)
    frames = []
    for i in range(len(seq)):
        f, _ = seq.frame(i)
        frames.append(jax.device_put(f))
    jax.block_until_ready(frames[-1])
    return jax.jit(step), frames, ms, pose


def measure(n_features: int, n_timed: int = 96):
    import jax

    step_j, frames, ms, pose = build_step(n_features)
    out = step_j(frames[0], ms, pose)       # warmup / compile
    jax.block_until_ready(out)

    # pipelined throughput
    t0 = time.perf_counter()
    outs = [step_j(frames[i % len(frames)], ms, pose) for i in range(n_timed)]
    jax.block_until_ready(outs)
    fps = n_timed / (time.perf_counter() - t0)

    # blocking per-frame latency
    lat = []
    for i in range(n_timed):
        t0 = time.perf_counter()
        jax.block_until_ready(step_j(frames[i % len(frames)], ms, pose))
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat)
    return {
        "throughput_fps": fps,
        "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p95_ms": float(np.percentile(lat, 95)),
    }


def main():
    from rumi_slam_tpu.utils import compile_cache, device

    devs = device.require_gpu()
    compile_cache.configure()
    head = measure(2048)
    sec = measure(1024)
    print(json.dumps({
        "metric": "tracking_fps_per_chip",
        "value": head["throughput_fps"],
        "unit": "frames/s",
        "vs_baseline": head["throughput_fps"] / 30.0,
        "feature_budget": 2048,
        "latency_p50_ms": head["latency_p50_ms"],
        "latency_p95_ms": head["latency_p95_ms"],
        "secondary_1024": sec,
        "device": device.describe(devs),
        "card": device.card_line(),
    }))


if __name__ == "__main__":
    main()
