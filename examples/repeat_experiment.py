"""Statistical repetition driver: N independent runs -> experiment_results.csv.

Equivalent of the reference's experiment harness (scripts/repeat.sh runs
roslaunch 30x; scripts/utils/export_results.py harvests per-run result.csv
rows into experiment_results.csv — SLAM is RANSAC-nondeterministic, so the
reference treats DISTRIBUTIONS as the pass signal, SURVEY.md §4.5).

Usage:
  python examples/repeat_experiment.py --repeats 10 --out results/exp1 \
      [--frames 110] [--lost 45 55] [--no-rumination]

Runs the synthetic sequence by default (no datasets ship in this
environment); pass --data <tum_dir> to repeat over a real sequence.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default="results/experiment")
    ap.add_argument("--frames", type=int, default=110)
    ap.add_argument("--lost", type=int, nargs=2, default=None)
    ap.add_argument("--data", default=None, help="TUM dir (default synthetic)")
    ap.add_argument("--no-rumination", action="store_true")
    args = ap.parse_args()

    from rumi_slam_tpu.utils import compile_cache

    compile_cache.configure()
    from rumi_slam_tpu.config import tiny_config
    from rumi_slam_tpu.evaluation import harness

    if args.data:
        from rumi_slam_tpu.io.datasets import TumSequence

        def seq_factory(r):
            return TumSequence(args.data)
    else:
        from rumi_slam_tpu.io.synthetic import SyntheticSequence

        def seq_factory(r):
            return SyntheticSequence(
                n_frames=args.frames, width=320, height=240, n_points=2000,
                seed=10 + r, patch=3,
                lost_span=tuple(args.lost) if args.lost else None,
            )

    rows = harness.repeat_experiment(
        seq_factory, tiny_config(), repeats=args.repeats, out_dir=args.out,
        enable_rumination=not args.no_rumination,
    )
    print(json.dumps(harness.summarize(rows), indent=2))


if __name__ == "__main__":
    main()
