"""Full-system driver on a synthetic sequence: the framework's `main()`.

Role-equivalent of the reference's node driver
(/root/reference/src/rumi-slam/src/cloud_edge_main.cpp): replays a dataset
through the tracking front-end with the rumination coordinator attached,
then writes the reference's artifact set — whole-trajectory + per-map TUM
files, result.csv, traj.png, map.png, a MapState checkpoint, and the
per-stage timing report.

Usage:
  python examples/run_synthetic.py [--frames 110] [--lost 45:55] [--out out/run1]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=110)
    ap.add_argument("--lost", type=str, default="45:55",
                    help="frame span of simulated tracking loss, 'a:b' or 'none'")
    ap.add_argument("--out", type=str, default="out/synthetic")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--no-rumination", action="store_true")
    args = ap.parse_args()

    import importlib.util

    import numpy as np

    from rumi_slam_tpu.utils import compile_cache

    compile_cache.configure()
    from rumi_slam_tpu.config import tiny_config
    from rumi_slam_tpu.evaluation import ate, harness, plot
    from rumi_slam_tpu.io.synthetic import SyntheticSequence
    from rumi_slam_tpu.io import trajectory
    from rumi_slam_tpu.mapstate import checkpoint
    from rumi_slam_tpu.rumination.coordinator import RuminationCoordinator
    from rumi_slam_tpu.system import SlamSystem

    lost_span = None
    if args.lost != "none":
        a, b = args.lost.split(":")
        lost_span = (int(a), int(b))

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    seq = SyntheticSequence(
        n_frames=args.frames, width=args.width, height=args.height,
        n_points=2000, seed=args.seed, patch=3, lost_span=lost_span,
    )
    cfg = tiny_config()
    slam = SlamSystem(cfg)
    coord = None if args.no_rumination else RuminationCoordinator(slam, cfg)

    t0 = time.perf_counter()
    for i in range(len(seq)):
        img, t = seq.frame(i)
        st = slam.track_monocular(img, t)
        if coord is not None:
            info = coord.maybe_ruminate()
            if info:
                print(f"[rumination @ frame {i}] {info.get('result')}: "
                      f"{ {k: v for k, v in info.items() if k != 'result'} }")
        if i % 20 == 0:
            print(f"frame {i:4d}  state={st.name:16s} kf={slam.stats['n_kf']} "
                  f"maps={int(slam.ms.n_maps)}")
    runtime = time.perf_counter() - t0

    gt_t = np.asarray(seq.times)
    gt_p = np.stack([np.asarray(p) for p in seq.poses_gt])

    # artifacts (reference parity: whole_map.txt, result.csv, traj.png)
    kt, kp = slam.keyframe_trajectory()
    trajectory.save_tum(out / "whole_map.txt", kt, kp)
    ft, fp = slam.trajectory_of_map()
    trajectory.save_tum(out / "frame_trajectory.txt", ft, fp)
    m = ate.evaluate_trajectory(kt, kp, gt_t, gt_p)
    print(f"\nKF-trajectory ATE RMSE: {m['ate']:.4f} m | rate {m['rate']:.3f} "
          f"| {m['n_matched']} poses | runtime {runtime:.1f}s "
          f"({len(seq)/runtime:.1f} fps incl. host)")
    print("\nper-stage timings:\n" + slam.timer.report())

    row = {
        "dataset": "synthetic", "ate": m["ate"], "rate": m["rate"],
        "duration": float(gt_t[-1] - gt_t[0]), "runtime_s": runtime,
        "n_kf": slam.stats["n_kf"],
        "n_points": int(np.asarray(slam.ms.pt_valid).sum()),
        "n_maps": int(slam.ms.n_maps),
        "n_merges": sum(1 for h in (coord.history if coord else [])
                        if h.get("result") == "merged"),
    }
    harness.write_result_csv(row, out / "result.csv")
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: traj.png and map.png skipped")
    else:
        plot.plot_trajectory(out / "traj.png", kt, kp, gt_t, gt_p)
        plot.plot_map(out / "map.png", slam.ms)
    digest = checkpoint.save(slam.ms, out / "map.ckpt")
    print(f"\nartifacts in {out}/ (checkpoint sha256 {digest[:12]}…)")
    (out / "summary.json").write_text(json.dumps(row, indent=2))


if __name__ == "__main__":
    main()
