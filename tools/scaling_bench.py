"""Sharded-BA strong-scaling measurement; prints one JSON object.

Two sections:

1. ``virtual_mesh_rows`` — strong scaling of the matrix-free PCG Schur BA
   (parallel.sharded_ba.sharded_bundle_adjust_pcg) at D = 1/2/4/8 devices of
   a VIRTUAL CPU mesh.  The platform of the mesh devices is recorded from
   the mesh itself (not jax.default_backend()), and the honest caveat fires
   whenever those devices are CPU or exceed the physical core count: on this
   2-core host, D > 2 rows time-slice cores and measure SPMD overhead, not
   speedup.  On a host with several GPUs the rows are real GPU scaling.

2. ``work_scaling_rows`` — the contention-free measurement: ONE device
   timing the identical per-shard program at shard sizes P/D.  This is what
   each device of a D-device mesh would run; it needs no multi-device
   hardware and no time-slicing caveat.

Problem size: 128 cameras, 131k points, ~1M observations — the post-merge
global-BA regime, not a toy.

Run:  python tools/scaling_bench.py            (default backend)
      JAX_PLATFORMS=cpu python tools/scaling_bench.py   (8 virtual CPUs)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax
import jax.numpy as jnp
import numpy as np

N_CAMS = 128
N_PTS = 131_072
OBS_PER_PT = 8          # every point seen by 8 consecutive cameras -> 1.05M obs
CG_ITERS = 32
LM_ITERS = 2            # per timed call; time is reported per LM iteration


def build_problem(seed=0):
    """Trajectory of N_CAMS cameras; each point observed by OBS_PER_PT
    consecutive cameras (the locality structure real maps have)."""
    from rumi_slam_tpu.geometry import camera, lie

    rng = np.random.default_rng(seed)
    K = jnp.asarray([200.0, 200.0, 127.5, 95.5])
    poses = []
    for i in range(N_CAMS):
        q = lie.so3_exp(jnp.asarray(
            rng.normal(scale=0.02, size=3).astype(np.float32)))
        poses.append(np.concatenate([
            np.asarray(q),
            np.asarray([0.15 * i, 0.5 * np.sin(0.2 * i), 0.0], np.float32)]))
    poses = jnp.asarray(np.stack(poses))

    base = (np.arange(N_PTS) * (N_CAMS - OBS_PER_PT) // N_PTS).astype(np.int32)
    X = np.empty((N_PTS, 3), np.float32)
    X[:, 0] = 0.15 * base + rng.uniform(-2, 4, N_PTS)
    X[:, 1] = rng.uniform(-2, 2, N_PTS)
    X[:, 2] = rng.uniform(2, 9, N_PTS)

    cam_g = base[:, None] + np.arange(OBS_PER_PT)[None, :]      # [P,R]
    uv_g = np.zeros((N_PTS, OBS_PER_PT, 2), np.float32)
    for r in range(OBS_PER_PT):
        # project all points into their r-th observer in one batch
        Xc = jax.vmap(lie.se3_apply)(poses[cam_g[:, r]], jnp.asarray(X))
        uv_g[:, r] = np.asarray(camera.project(K, Xc))
    uv_g += rng.normal(scale=0.5, size=uv_g.shape).astype(np.float32)
    conf_g = np.ones((N_PTS, OBS_PER_PT), np.float32)
    return K, poses, X, cam_g.astype(np.int32), uv_g, conf_g


def shard_arrays(X, cam_g, uv_g, conf_g, D):
    """Round-robin point sharding (matches partition_problem_grouped)."""
    P = X.shape[0]
    Pl = (P + D - 1) // D
    R = cam_g.shape[1]
    pts = np.zeros((D, Pl, 3), np.float32)
    cam = np.zeros((D, Pl, R), np.int32)
    uv = np.zeros((D, Pl, R, 2), np.float32)
    conf = np.zeros((D, Pl, R), np.float32)
    for d in range(D):
        g = np.arange(d, P, D)
        pts[d, : len(g)] = X[g]
        cam[d, : len(g)] = cam_g[g]
        uv[d, : len(g)] = uv_g[g]
        conf[d, : len(g)] = conf_g[g]
    return (pts.reshape(D * Pl, 3), cam.reshape(D * Pl, R),
            uv.reshape(D * Pl, R, 2), conf.reshape(D * Pl, R))


def perturb(poses, X, seed=1):
    from rumi_slam_tpu.geometry import lie

    rng = np.random.default_rng(seed)
    poses_n = jax.vmap(lie.se3_retract)(poses, jnp.asarray(
        rng.normal(scale=0.005, size=(N_CAMS, 6)).astype(np.float32)))
    poses_n = poses_n.at[0].set(poses[0]).at[1].set(poses[1])
    X_n = X + rng.normal(scale=0.02, size=X.shape).astype(np.float32)
    return poses_n, X_n


def time_call(fn, *args, reps=3):
    r = fn(*args)
    jax.block_until_ready(r[0])          # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn(*args)
        jax.block_until_ready(r[0])
    return (time.perf_counter() - t0) / reps / LM_ITERS, float(r[2])


def run():
    from jax.sharding import Mesh

    from rumi_slam_tpu.parallel import sharded_ba

    K, poses, X, cam_g, uv_g, conf_g = build_problem()
    poses_n, X_n = perturb(poses, X)
    cam_free = jnp.asarray([False, False] + [True] * (N_CAMS - 2))
    n_obs = int((conf_g > 0).sum())
    devs = jax.devices()
    platform = devs[0].platform
    ncpu = os.cpu_count()

    def call(mesh, pts, cam, uv, conf):
        return sharded_ba.sharded_bundle_adjust_pcg(
            mesh, K, poses_n, jnp.asarray(pts), jnp.asarray(cam),
            jnp.asarray(uv), jnp.asarray(conf), cam_free,
            n_iters=LM_ITERS, cg_iters=CG_ITERS)

    # -- section 1: virtual-mesh strong scaling (honest labels) ----------
    mesh_rows = []
    base = None
    for D in [1, 2, 4, 8]:
        if len(devs) < D:
            break
        mesh = Mesh(np.array(devs[:D]), ("ba",))
        pts, cam, uv, conf = shard_arrays(X_n, cam_g, uv_g, conf_g, D)
        dt, cost = time_call(call, mesh, pts, cam, uv, conf)
        if base is None:
            base = dt
        mesh_rows.append({
            "devices": D,
            "ms_per_lm_iter": round(dt * 1e3, 1),
            "speedup": round(base / dt, 3),
            "efficiency": round(base / dt / D, 3),
            "cost": cost,
        })
        print(f"[mesh {platform} D={D}] {dt*1e3:.1f} ms/LM-iter "
              f"eff={base/dt/D:.3f}", flush=True)

    # -- section 2: contention-free per-device work scaling --------------
    work_rows = []
    mesh1 = Mesh(np.array(devs[:1]), ("ba",))
    for D in [1, 2, 4, 8]:
        g = np.arange(0, N_PTS, D)       # the shard device 0 would own
        pts, cam, uv, conf = shard_arrays(
            X_n[g], cam_g[g], uv_g[g], conf_g[g], 1)
        dt, _ = time_call(call, mesh1, pts, cam, uv, conf)
        work_rows.append({
            "shard_of": D,
            "points_on_device": len(g),
            "ms_per_lm_iter": round(dt * 1e3, 1),
        })
        print(f"[work 1/{D} shard] {dt*1e3:.1f} ms/LM-iter", flush=True)

    out = {
        "metric": "sharded_ba_strong_scaling",
        "solver": "matrix-free PCG Schur (sharded_bundle_adjust_pcg), "
                  f"{CG_ITERS} CG iters/LM iter",
        "mesh_platform": platform,
        "device_kind": devs[0].device_kind,
        "physical_cores": ncpu,
        "problem": {"cams": N_CAMS, "points": N_PTS, "obs": n_obs},
        # one [C,6,6]+[C,6] psum + cost scalars, then one [C,6] per CG step
        "psum_bytes_per_lm_iter": N_CAMS * 42 * 4 + 8
        + CG_ITERS * N_CAMS * 6 * 4,
        "virtual_mesh_rows": mesh_rows,
        "work_scaling_rows": work_rows,
    }
    if platform == "cpu":
        out["honest_caveat"] = (
            f"virtual CPU mesh on a {ncpu}-core host: the mesh devices are "
            f"CPU, rows with devices > {ncpu} time-slice cores, and XLA:CPU "
            "shares one intra-op thread pool across devices — "
            "virtual_mesh_rows therefore measure SPMD overhead, NOT device "
            "scaling; work_scaling_rows (one device, 1/D shard) bound it.")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    run()
