"""Run the full SLAM system over a TUM RGB-D sequence directory.

Equivalent of the reference's dataset driver (cloud_edge_main.cpp: main :183 +
Grabber::RunTxt :550 — replay rgb.txt at the recorded cadence, track every
frame, poll the rumination coordinator, and at the end export the
duration-longest map's trajectory, score ATE against groundtruth, and write
result.csv + traj.png into a timestamped results directory :252-388).

Usage:
  python examples/run_tum.py --data /path/to/rgbd_dataset_freiburg3_xyz \
      --preset tum3 [--rgbd] [--pace 1.0] [--out results/]

With --pace > 0 (monocular) frames flow through the native C++ SPSC frame
ring (runtime/edge_runtime.cpp FrameQueue, drop-OLDEST when full): a producer
paces frames at pace x real time — the fully-native tum_start_replay thread
when the dataset is PGM/PPM, a Python decode thread otherwise — and the
tracking loop pops.  Frames the tracker cannot keep up with are dropped by
the ring and counted in result.csv's ``drops`` column, the reference's
realtime semantics (cloud_edge_main.cpp:597-610 paced replay racing the
tracker).  --pace 0 (default) replays offline, every frame tracked.
RGB-D mode paces by sleeping only (no ring, no drops).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_paced(slam, coord, seq, data_root: str, pace: float):
    """Realtime monocular replay through the native SPSC frame ring
    (reference cloud_edge_main.cpp:597-610: the replay clock never waits for
    the tracker; frames it cannot keep up with are lost).

    Producer: the C++ tum_start_replay thread when every frame is PGM/PPM
    (fully native decode+pace), else a Python decode thread pacing into the
    same native ring.  Consumer: this loop, popping whatever survived the
    drop-oldest policy.  Returns (drops, n_tracked)."""
    import threading

    from rumi_slam_tpu.runtime import native

    img0, _ = seq.frame(0)
    H, W = img0.shape
    if not native.available():
        raise RuntimeError("--pace needs the native runtime (g++)")
    q = native.FrameQueue(8, H, W)
    all_pnm = all(p.lower().endswith((".pgm", ".ppm", ".pnm"))
                  for p in seq._rgb_paths)
    nd = None
    fin = threading.Event()
    if all_pnm:
        nd = native.TumDataset(str(data_root))
        nd.start_replay(q, pace)
        done = lambda: nd.replay_done
    else:
        stop = threading.Event()

        def produce():
            start = time.perf_counter()
            tb = float(seq.times[0])
            for i in range(len(seq)):
                if stop.is_set():
                    break
                img, t = seq.frame(i)
                lag = (t - tb) / pace - (time.perf_counter() - start)
                if lag > 0:
                    time.sleep(lag)
                q.push(t, img)
            fin.set()

        threading.Thread(target=produce, daemon=True).start()
        done = fin.is_set

    n_tracked = 0
    try:
        while True:
            item = q.pop()
            if item is None:
                if done() and len(q) == 0:
                    break
                time.sleep(0.001)
                continue
            t, img = item
            slam.track_monocular(img, t)
            n_tracked += 1
            if coord is not None:
                coord.maybe_ruminate()
        return int(q.dropped), n_tracked
    finally:
        if nd is not None:
            nd.close()
        q.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="TUM sequence directory")
    ap.add_argument("--preset", default="tum3",
                    help="settings preset or YAML path")
    ap.add_argument("--rgbd", action="store_true",
                    help="use depth.txt for RGB-D tracking")
    ap.add_argument("--pace", type=float, default=0.0,
                    help="realtime pace factor (0 = offline)")
    ap.add_argument("--out", default="results")
    ap.add_argument("--no-rumination", action="store_true")
    ap.add_argument("--async-rumination", action="store_true",
                    help="build cloud submaps on the rumination shard "
                         "(global-mesh placed: last chip of last host) "
                         "overlapped with tracking")
    ap.add_argument("--viewer", type=int, default=0, metavar="PORT",
                    help="serve the live map viewer on this port")
    args = ap.parse_args()

    import importlib.util

    import numpy as np

    from rumi_slam_tpu.utils import compile_cache

    compile_cache.configure()
    from rumi_slam_tpu.evaluation import ate as ate_mod
    from rumi_slam_tpu.evaluation import harness, plot
    from rumi_slam_tpu.io import datasets, settings, trajectory
    from rumi_slam_tpu.rumination.coordinator import RuminationCoordinator
    from rumi_slam_tpu.system import SlamSystem
    from rumi_slam_tpu.utils.profiling import MemoryMonitor

    cfg = (
        settings.preset(args.preset)
        if not args.preset.endswith((".yaml", ".yml"))
        else settings.load_settings(args.preset)
    )
    if args.rgbd:
        import dataclasses

        # TumSequence.frame_rgbd already scales raw png units to meters
        cfg = dataclasses.replace(
            cfg, camera=dataclasses.replace(
                cfg.camera, depth_factor=1.0,
                baseline=cfg.camera.baseline or 0.075))
    seq = datasets.TumSequence(args.data)
    out_dir = Path(args.out) / time.strftime("%Y%m%d_%H%M%S")
    out_dir.mkdir(parents=True, exist_ok=True)

    slam = SlamSystem(cfg)
    shard = None
    if args.async_rumination and not args.no_rumination:
        from rumi_slam_tpu.rumination.remote import (
            AsyncRuminationShard, pick_rumination_device)

        shard = AsyncRuminationShard(cfg, device=pick_rumination_device())
    coord = (None if args.no_rumination
             else RuminationCoordinator(slam, cfg, async_shard=shard))

    viewer = None
    if args.viewer:
        from rumi_slam_tpu.evaluation.viewer import LiveViewer

        viewer = LiveViewer(slam, port=args.viewer).start()
        print(f"live viewer: http://localhost:{args.viewer}/")

    drops, n_tracked = 0, 0
    t0 = time.perf_counter()
    with MemoryMonitor() as mem:
        if args.pace > 0 and not args.rgbd:
            drops, n_tracked = run_paced(slam, coord, seq, args.data,
                                         args.pace)
        else:
            for i in range(len(seq)):
                if args.rgbd:
                    img, depth, t = seq.frame_rgbd(i)
                    slam.track_rgbd(img, depth, t)
                else:
                    img, t = seq.frame(i)
                    slam.track_monocular(img, t)
                n_tracked += 1
                if coord is not None:
                    coord.maybe_ruminate()
                if args.pace > 0 and i + 1 < len(seq):
                    lag = (seq.times[i + 1] - seq.times[0]) / args.pace - (
                        time.perf_counter() - t0)
                    if lag > 0:
                        time.sleep(lag)
    runtime = time.perf_counter() - t0

    if viewer is not None:
        viewer.stop()
    if shard is not None:
        # drain an in-flight cloud build before export (the reference waits
        # for CloudMerger idle at end of run, cloud_edge_main.cpp:613-617)
        deadline = time.perf_counter() + 120.0
        while shard.busy and time.perf_counter() < deadline:
            time.sleep(0.05)
        if coord is not None:
            coord.maybe_ruminate()
        shard.shutdown()

    times, poses = slam.trajectory_of_map()
    trajectory.save_tum(out_dir / "whole_map.txt", times, poses)
    kt, kp = slam.keyframe_trajectory()
    trajectory.save_tum(out_dir / "keyframes.txt", kt, kp)

    row = {"dataset": Path(args.data).name, "runtime_s": runtime,
           "n_kf": slam.stats["n_kf"], "rss_mb": mem.peak_mb(),
           "drops": drops, "n_tracked": n_tracked}
    if coord is not None:
        row["upload_mb"] = sum(
            h.get("upload_mb", 0.0) for h in coord.history)
        row["upload_mb_raw"] = sum(
            h.get("upload_mb_raw", 0.0) for h in coord.history)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    try:
        gt_times, gt_xyz, gt_quat = seq.groundtruth()
    except OSError:
        gt_times = None
    if gt_times is not None and gt_quat is not None:
        # TUM groundtruth rows are camera-to-world (tx ty tz qx qy qz qw);
        # evaluate_trajectory consumes world-to-camera [qw qx qy qz t]
        import jax
        import jax.numpy as jnp

        from rumi_slam_tpu.geometry import lie

        Twc = np.concatenate(
            [gt_quat[:, 3:4], gt_quat[:, 0:3], gt_xyz], axis=1
        ).astype(np.float32)
        gt_poses = np.asarray(jax.vmap(lie.se3_inverse)(jnp.asarray(Twc)))
        m = ate_mod.evaluate_trajectory(times, poses, gt_times, gt_poses)
        row.update(ate=m["ate"], rate=m["rate"], n_matched=m["n_matched"])
        if has_mpl:
            plot.plot_trajectory(out_dir / "traj.png", times, poses,
                                 gt_times, gt_poses)
    harness.write_result_csv(row, out_dir / "result.csv")
    if has_mpl:
        plot.plot_map(out_dir / "map.png", slam.ms)
    else:
        print("matplotlib is not installed: traj.png and map.png skipped")
    print(json.dumps(row))
    print("stage timings:\n" + slam.timer.report())
    print(f"results in {out_dir}")


if __name__ == "__main__":
    main()
