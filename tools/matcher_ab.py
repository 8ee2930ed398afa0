"""A/B of the windowed matcher on one GPU: the fused Pallas (Triton route)
kernel that ``matcher.window_match`` picks there, against the plain XLA
path ``matcher.window_match_reference``.

  python tools/matcher_ab.py            # on the GPU; prints one JSON line
  python tools/matcher_ab.py --rehearse # tiny shapes, CPU, kernel interpreted

1. Alone at F=2048 queries x P=16384 map slots (radius 15 px): outputs must
   be equal; median time over 50 calls, rounds in turns (plain, kernel,
   kernel, plain).
2. Inside bench.py's jitted tracking step (2048 features): median blocking
   per-frame latency over 64 frames per round, four rounds in turns.  The
   plain step is built with ``matcher.window_match`` swapped for the
   reference while it traces.
3. Device traces of the plain match and of both steps, reduced to the ops
   that take the most device time (the traces themselves are not kept).
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def top_ops(fn, args, n_calls=5, n=12):
    """Device time (µs, summed over ``n_calls`` calls) by op name, per line
    of the GPU planes of a profiler trace."""
    import jax
    from jax.profiler import ProfileData

    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(n_calls):
            jax.block_until_ready(fn(*args))
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                      "*.xplane.pb"))[0]
        pd = ProfileData.from_file(path)
        tot = defaultdict(lambda: defaultdict(float))
        for plane in pd.planes:
            if plane.name.startswith("/device:GPU"):
                for line in plane.lines:
                    for ev in line.events:
                        tot[line.name][ev.name] += ev.duration_ns / 1e3
    return {ln: sorted(d.items(), key=lambda kv: -kv[1])[:n]
            for ln, d in tot.items()}


def median_ms(fn, args, n):
    import jax

    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import bench
    from rumi_slam_tpu.ops import matcher
    from rumi_slam_tpu.ops.fused_matcher import fused_match
    from rumi_slam_tpu.tracking import tracker
    from rumi_slam_tpu.utils import compile_cache, device

    if args.rehearse:
        F, P, nf, n_calls, n_frames, rounds = 100, 1000, 256, 3, 2, 2
    else:
        device.require_gpu()
        F, P, nf, n_calls, n_frames, rounds = 2048, 16384, 2048, 50, 64, 4
    compile_cache.configure()
    res = {"F": F, "P": P, "radius_px": 15.0,
           "device": device.describe(jax.devices())}
    if not args.rehearse:
        res["card"] = device.card_line()

    rng = np.random.default_rng(0)
    dq = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    uq = rng.uniform(0, [640, 480], (F, 2)).astype(np.float32)
    up = rng.uniform(0, [640, 480], (P, 2)).astype(np.float32)
    rows = rng.choice(P, F // 2, replace=False)
    dp[rows] = dq[: F // 2]                       # planted true matches
    up[rows] = uq[: F // 2] + rng.normal(0, 3, (F // 2, 2))
    vq = rng.random(F) > 0.05
    vp = np.zeros(P, bool)
    vp[: min(P, 2048)] = True
    vp[rows] = True
    margs = ([jnp.asarray(x) for x in (dq, dp, uq, up)]
             + [jnp.float32(15.0), jnp.asarray(vq), jnp.asarray(vp)])

    kw = dict(max_dist=80.0, ratio=0.85)
    fns = {"plain": jax.jit(partial(matcher.window_match_reference, **kw)),
           "kernel": jax.jit(partial(fused_match, interpret=args.rehearse,
                                     **kw))}
    outs = {k: jax.block_until_ready(f(*margs)) for k, f in fns.items()}
    res["equal"] = all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(outs["plain"], outs["kernel"]))
    res["n_matched"] = int((np.asarray(outs["plain"][0]) >= 0).sum())
    alone = {k: [] for k in fns}
    for _ in range(rounds // 2):
        for k in ["plain", "kernel", "kernel", "plain"]:
            alone[k].append(median_ms(fns[k], margs, n_calls))
    res["alone_median_ms_per_round"] = alone
    print("alone", json.dumps(alone), flush=True)

    # the tracking step, once with the reference swapped in while it traces
    steps = {}
    kernel_choice = matcher.window_match
    for k, impl in (("plain", matcher.window_match_reference),
                    ("kernel", kernel_choice)):
        matcher.window_match = impl
        tracker.track_frame.clear_cache()
        try:
            steps[k] = bench.build_step(nf)
            step, frames, ms, pose = steps[k]
            out = jax.block_until_ready(step(frames[0], ms, pose))
        finally:
            matcher.window_match = kernel_choice
            tracker.track_frame.clear_cache()
        res[f"step_{k}_inliers_frame0"] = int(out[1])
    lat = {k: [] for k in steps}
    for _ in range(rounds // 2):
        for k in ["plain", "kernel", "kernel", "plain"]:
            step, frames, ms, pose = steps[k]
            ts = []
            for i in range(n_frames):
                t0 = time.perf_counter()
                jax.block_until_ready(step(frames[i % len(frames)], ms, pose))
                ts.append((time.perf_counter() - t0) * 1e3)
            lat[k].append(float(np.median(ts)))
    res["step_median_latency_ms_per_round"] = lat
    print("step", json.dumps(lat), flush=True)

    if not args.rehearse:
        res["trace_plain_match_us"] = top_ops(fns["plain"], margs)
        res["trace_kernel_match_us"] = top_ops(fns["kernel"], margs)
        for k, (step, frames, ms, pose) in steps.items():
            res[f"trace_step_{k}_us"] = top_ops(step, (frames[1], ms, pose))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
