"""Distributed global bundle adjustment: Schur reduction over collectives.

The reference has no distributed optimizer at all (SURVEY.md §2.5: its only
"distribution" is ROS TCP between edge and cloud processes); scaling global BA
across the GPUs of a host is this framework's replacement for the reference's
single-threaded g2o GlobalBundleAdjustemnt (/root/reference/src/rumi-slam/
lib_src/Optimizer.cc:48, run in a side thread by CloudMerging.cc:1957).

Sharding contract (mesh axis ``ba``):
  * POINTS are sharded in blocks; every observation of a point lives on that
    point's shard.  Hence per-shard Hpp blocks are complete, per-shard cross
    blocks W are disjoint, and the reduced camera system is ADDITIVE across
    shards:  S = psum_d [ Hcc_d - W_d Hpp_d^-1 W_d^T ].
  * Cameras are replicated (the reduced system [6C,6C] is small); each device
    solves it identically after the psum — no broadcast needed.
  * Point updates are computed locally per shard; nothing but the [6C,6C]+
    [6C] Schur terms ever crosses NVLink per iteration.

This is the standard distributed-Hessian-assembly recipe mapped onto
jax.shard_map + psum; on GPUs XLA hands the psum to NCCL over NVLink.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import camera, lie
from ..optim.ba import _inv3x3
from ..optim import robust

CHI2_MONO = 5.991


def partition_problem(cam_idx, pt_idx, uv, conf, n_points, n_shards):
    """Host-side repartition: points round-robin by block to shards; every
    observation follows its point.  Pads per-shard obs counts to the max.

    Returns dict of numpy arrays shaped [D, ...] ready for shard_map, plus
    the point permutation (shard-major) used to scatter points.
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    conf = np.asarray(conf)

    pt_shard = pt_idx % n_shards
    pt_local = pt_idx // n_shards
    pts_per_shard = (n_points + n_shards - 1) // n_shards

    counts = np.bincount(pt_shard, minlength=n_shards)
    obs_per_shard = max(int(counts.max()), 1)

    D = n_shards
    cam_s = np.zeros((D, obs_per_shard), np.int32)
    ptl_s = np.zeros((D, obs_per_shard), np.int32)
    uv_s = np.zeros((D, obs_per_shard, 2), np.float32)
    conf_s = np.zeros((D, obs_per_shard), np.float32)
    for d in range(D):
        sel = pt_shard == d
        n = int(sel.sum())
        cam_s[d, :n] = cam_idx[sel]
        ptl_s[d, :n] = pt_local[sel]
        uv_s[d, :n] = uv[sel]
        conf_s[d, :n] = conf[sel]

    # point scatter: global point g lives at shard g%D, local row g//D
    perm = np.arange(pts_per_shard * D).reshape(pts_per_shard, D).T  # [D, ppS]
    return {
        "cam_idx": cam_s,
        "pt_local": ptl_s,
        "uv": uv_s,
        "conf": conf_s,
        "pts_per_shard": pts_per_shard,
        "point_rows": perm,  # [D, pts_per_shard] global row per local slot
    }


def _shard_terms(K, poses, pts_l, cam_idx, ptl_idx, uv, conf, lam, cam_free_f):
    """Per-shard assembly of Schur terms (runs inside shard_map)."""
    C = poses.shape[0]
    Pl = pts_l.shape[0]
    pose_o = poses[cam_idx]
    X_o = pts_l[ptl_idx]
    r, Jc, Jp, depth = camera.reproj_residual_and_jacobians(K, pose_o, X_o, uv)
    chi2 = jnp.sum(r * r, axis=-1) * conf
    w = conf * robust.huber_weight(chi2, CHI2_MONO) * (depth > 0.05)
    cost = jnp.sum(jnp.where(conf > 0, robust.huber_cost(chi2, CHI2_MONO), 0.0))

    Hcc = jax.ops.segment_sum(jnp.einsum("oki,o,okj->oij", Jc, w, Jc),
                              cam_idx, num_segments=C)
    bc = jax.ops.segment_sum(jnp.einsum("oki,o,ok->oi", Jc, w, r),
                             cam_idx, num_segments=C)
    Hpp = jax.ops.segment_sum(jnp.einsum("oki,o,okj->oij", Jp, w, Jp),
                              ptl_idx, num_segments=Pl)
    bp = jax.ops.segment_sum(jnp.einsum("oki,o,ok->oi", Jp, w, r),
                             ptl_idx, num_segments=Pl)

    Hcc_d = Hcc + lam * jnp.eye(6) * jnp.maximum(
        jnp.trace(Hcc, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6)
    Hpp_d = Hpp + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(Hpp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6)
    Hpp_inv = _inv3x3(Hpp_d)

    Wblk = jnp.zeros((Pl, C, 6, 3), poses.dtype).at[ptl_idx, cam_idx].add(
        jnp.einsum("oki,o,okj->oij", Jc, w, Jp))
    Y = jnp.einsum("pcij,pjk->pcik", Wblk, Hpp_inv)
    S_corr = jnp.einsum("pcik,pdmk->cidm", Y, Wblk)
    S_local = -S_corr
    diag = jnp.arange(C)
    S_local = S_local.at[diag, :, diag, :].add(Hcc_d)
    b_local = bc - jnp.einsum("pcik,pk->ci", Y, bp)
    return S_local, b_local, Wblk, Hpp_inv, bp, cost


@partial(jax.jit, static_argnames=("mesh", "n_iters"))
def sharded_bundle_adjust(
    mesh: Mesh, K, poses, points_sh, cam_idx_sh, ptl_idx_sh, uv_sh, conf_sh,
    cam_free, *, n_iters: int = 8
):
    """Run distributed LM-BA.

    Args (sh = GLOBAL arrays sharded along their leading axis by mesh axis
    "ba"; with D devices each shard sees 1/D of the leading dim):
      points_sh [D*Pl, 3]; cam_idx_sh/ptl_idx_sh [D*Od]; uv_sh [D*Od, 2];
      conf_sh [D*Od]; poses [C,7] and cam_free [C] replicated.
    Returns (poses [C,7], points_sh [D*Pl, 3], final cost).
    """
    cam_free_f = cam_free.astype(jnp.float32)

    def step(poses, pts_l, cam_idx, ptl_idx, uv, conf, lam):
        C = poses.shape[0]
        S_local, b_local, Wblk, Hpp_inv, bp, cost = _shard_terms(
            K, poses, pts_l, cam_idx, ptl_idx, uv, conf, lam, cam_free_f)
        S = jax.lax.psum(S_local, "ba")
        b_red = jax.lax.psum(b_local, "ba")
        cost_tot = jax.lax.psum(cost, "ba")

        diag = jnp.arange(C)
        S = S * cam_free_f[:, None, None, None] * cam_free_f[None, None, :, None]
        S = S.at[diag, :, diag, :].add(jnp.eye(6) * (1.0 - cam_free_f)[:, None, None])
        b_red = b_red * cam_free_f[:, None]

        Sd = S.reshape(C * 6, C * 6) + 1e-8 * jnp.eye(C * 6)
        dxc = -jnp.linalg.solve(Sd, b_red.reshape(C * 6)).reshape(C, 6)
        dxc = dxc * cam_free_f[:, None]

        t_p = jnp.einsum("pcik,ci->pk", Wblk, dxc)
        dxp = -jnp.einsum("pij,pj->pi", Hpp_inv, bp + t_p)
        return lie.se3_retract(poses, dxc), pts_l + dxp, cost_tot

    def eval_cost(poses, pts_l, cam_idx, ptl_idx, uv, conf):
        pose_o = poses[cam_idx]
        X_o = pts_l[ptl_idx]
        r, _, _, _ = camera.reproj_residual_and_jacobians(K, pose_o, X_o, uv)
        chi2 = jnp.sum(r * r, axis=-1) * conf
        c = jnp.sum(jnp.where(conf > 0, robust.huber_cost(chi2, CHI2_MONO), 0.0))
        return jax.lax.psum(c, "ba")

    def shard_body(poses, pts_l, cam_idx, ptl_idx, uv, conf):
        def body(carry, _):
            poses, pts_l, lam = carry
            cost0 = eval_cost(poses, pts_l, cam_idx, ptl_idx, uv, conf)
            new_poses, new_pts, _ = step(poses, pts_l, cam_idx, ptl_idx, uv, conf, lam)
            cost1 = eval_cost(new_poses, new_pts, cam_idx, ptl_idx, uv, conf)
            accept = cost1 < cost0
            poses = jnp.where(accept, new_poses, poses)
            pts_l = jnp.where(accept, new_pts, pts_l)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
            return (poses, pts_l, lam), cost1

        (poses, pts_l, _), costs = jax.lax.scan(
            body, (poses, pts_l, jnp.float32(1e-4)), None, length=n_iters)
        return poses, pts_l, costs[-1]

    fn = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P("ba"), P("ba"), P("ba"), P("ba"), P("ba")),
        out_specs=(P(), P("ba"), P()),
        check_vma=False,
    )
    return fn(poses, points_sh, cam_idx_sh, ptl_idx_sh, uv_sh, conf_sh)


# ---------------------------------------------------------------------------
# Matrix-free distributed Schur solve (PCG) — removes the replicated wall.
#
# The version above psums the DENSE reduced camera system S [6C,6C]
# (O(C^2) bytes, every iteration) and solves it replicated on every device
# (O(C^3) flops) — fine for the welding-window sizes the rumination merge
# uses, but a scaling wall for post-merge global BA at hundreds of cameras
# (VERDICT r3 missing #1).  The fix is the standard large-scale-BA recipe:
# never materialize S.  Run preconditioned conjugate gradients on the
# reduced system, applying  S x = Hcc_d x - sum_p W_p Hpp^-1 W_p^T x
# matrix-free.  Every term of the matvec shards over points; the only
# cross-device traffic per CG iteration is a psum of a [C,6] vector
# (3 KB at C=128 vs 2.4 MB for dense S) plus two scalars — a payload that
# crosses NVLink in microseconds.  The per-LM-iteration psum of the
# block-diagonal Hcc [C,6,6] (18 KB) doubles as the block-Jacobi
# preconditioner.
#
# Observation layout ("grouped"): observations are grouped by point, R slots
# per point (conf=0 padding), so Hpp/bp reduce with a reshape instead of a
# segment_sum and the cross blocks A[p,r] = Jc^T w Jp stay point-local.
# partition_problem_grouped() builds it from the flat (cam_idx, pt_idx) form.
# ---------------------------------------------------------------------------


def partition_problem_grouped(cam_idx, pt_idx, uv, conf, n_points, n_shards,
                              obs_per_point: int):
    """Group observations by point (R slots each, conf-0 padded), then shard
    points round-robin exactly like partition_problem.

    Returns dict with [D, Pl*R] obs arrays and the [D, Pl] point row map.
    Observations beyond ``obs_per_point`` for one point are dropped (callers
    size R to the max multiplicity; a count is returned for visibility).
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    conf = np.asarray(conf)
    R = obs_per_point
    D = n_shards
    Pl = (n_points + D - 1) // D

    cam_g = np.zeros((n_points, R), np.int32)
    uv_g = np.zeros((n_points, R, 2), np.float32)
    conf_g = np.zeros((n_points, R), np.float32)
    slot = np.zeros(n_points, np.int32)
    dropped = 0
    order = np.argsort(pt_idx, kind="stable")
    for o in order:
        if conf[o] <= 0:
            continue
        p = pt_idx[o]
        s = slot[p]
        if s >= R:
            dropped += 1
            continue
        cam_g[p, s] = cam_idx[o]
        uv_g[p, s] = uv[o]
        conf_g[p, s] = conf[o]
        slot[p] = s + 1

    # shard: global point g -> shard g % D, local row g // D
    cam_s = np.zeros((D, Pl, R), np.int32)
    uv_s = np.zeros((D, Pl, R, 2), np.float32)
    conf_s = np.zeros((D, Pl, R), np.float32)
    rows = np.full((D, Pl), n_points, np.int64)
    for d in range(D):
        g = np.arange(d, n_points, D)
        cam_s[d, : len(g)] = cam_g[g]
        uv_s[d, : len(g)] = uv_g[g]
        conf_s[d, : len(g)] = conf_g[g]
        rows[d, : len(g)] = g
    return {
        "cam_idx": cam_s,
        "uv": uv_s,
        "conf": conf_s,
        "pts_per_shard": Pl,
        "point_rows": rows,
        "dropped_obs": dropped,
    }


def _grouped_terms(K, poses, pts_l, cam_idx, uv, conf, lam):
    """Per-shard terms in the grouped layout.

    pts_l [Pl,3]; cam_idx/conf [Pl,R]; uv [Pl,R,2].
    Returns (Hcc_local [C,6,6], bc_corr_local [C,6] = bc - W Hpp^-1 bp,
             A [Pl,R,6,3], Hpp_inv [Pl,3,3], bp [Pl,3], cost_local).
    """
    C = poses.shape[0]
    Pl, R = cam_idx.shape
    cam_f = cam_idx.reshape(-1)
    pose_o = poses[cam_f]
    X_o = jnp.repeat(pts_l, R, axis=0)
    r, Jc, Jp, depth = camera.reproj_residual_and_jacobians(
        K, pose_o, X_o, uv.reshape(-1, 2))
    conf_f = conf.reshape(-1)
    chi2 = jnp.sum(r * r, axis=-1) * conf_f
    w = conf_f * robust.huber_weight(chi2, CHI2_MONO) * (depth > 0.05)
    cost = jnp.sum(jnp.where(conf_f > 0,
                             robust.huber_cost(chi2, CHI2_MONO), 0.0))

    Hcc = jax.ops.segment_sum(jnp.einsum("oki,o,okj->oij", Jc, w, Jc),
                              cam_f, num_segments=C)
    bc = jax.ops.segment_sum(jnp.einsum("oki,o,ok->oi", Jc, w, r),
                             cam_f, num_segments=C)

    JpR = Jp.reshape(Pl, R, 2, 3)
    wR = w.reshape(Pl, R)
    rR = r.reshape(Pl, R, 2)
    Hpp = jnp.einsum("prki,pr,prkj->pij", JpR, wR, JpR)
    bp = jnp.einsum("prki,pr,prk->pi", JpR, wR, rR)
    Hpp_d = Hpp + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(Hpp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6)
    Hpp_inv = _inv3x3(Hpp_d)

    A = jnp.einsum("oki,o,okj->oij", Jc, w, Jp).reshape(Pl, R, 6, 3)
    # b_reduced correction: bc[c] -= sum_{p,r:cam=c} A[p,r] Hpp^-1 bp[p]
    u = jnp.einsum("pij,pj->pi", Hpp_inv, bp)                  # [Pl,3]
    corr = jnp.einsum("prij,pj->pri", A, u).reshape(-1, 6)     # [Pl*R,6]
    bc_corr = bc - jax.ops.segment_sum(corr, cam_f, num_segments=C)
    return Hcc, bc_corr, A, Hpp_inv, bp, cost


@partial(jax.jit, static_argnames=("mesh", "n_iters", "cg_iters"))
def sharded_bundle_adjust_pcg(
    mesh: Mesh, K, poses, points_sh, cam_idx_sh, uv_sh, conf_sh, cam_free,
    *, n_iters: int = 8, cg_iters: int = 32
):
    """Distributed LM-BA with a matrix-free PCG Schur solve.

    Args (leading axis sharded over mesh axis "ba"):
      points_sh  [D*Pl, 3]     — point positions, round-robin sharded
      cam_idx_sh [D*Pl, R]     — camera index per (point, obs-slot)
      uv_sh      [D*Pl, R, 2]  — measured pixels
      conf_sh    [D*Pl, R]     — information weight, 0 = padding slot
      poses [C,7], cam_free [C] — replicated.
    Returns (poses [C,7], points_sh [D*Pl,3], final cost).

    Collective traffic per LM iteration: one psum of Hcc [C,6,6] + b [C,6]
    + cost scalars, plus ``cg_iters`` psums of [C,6] — nothing scales with
    C^2 or with the point/observation count.
    """
    free = cam_free.astype(jnp.float32)

    def shard_body(poses, pts_l, cam_idx, uv, conf):
        C = poses.shape[0]

        def lm_step(poses, pts_l, lam):
            Hcc_l, b_l, A, Hpp_inv, bp, cost_l = _grouped_terms(
                K, poses, pts_l, cam_idx, uv, conf, lam)
            Hcc = jax.lax.psum(Hcc_l, "ba")
            b = jax.lax.psum(b_l, "ba")
            cost0 = jax.lax.psum(cost_l, "ba")
            Hcc_d = Hcc + lam * jnp.eye(6) * jnp.maximum(
                jnp.trace(Hcc, axis1=-2, axis2=-1)[:, None, None] / 6.0,
                1e-6)
            # gauge: fixed cameras become identity rows of the system
            b = b * free[:, None]
            Minv = _inv6x6(Hcc_d)  # block-Jacobi preconditioner

            cam_f = cam_idx.reshape(-1)

            def S_mv(x):
                # x [C,6] replicated; returns S x (psum'd, replicated)
                x = x * free[:, None]
                hx = jnp.einsum("cij,cj->ci", Hcc_d, x)
                xg = x[cam_f].reshape(*cam_idx.shape, 6)       # [Pl,R,6]
                t = jnp.einsum("prij,pri->pj", A, xg)          # [Pl,3]
                u = jnp.einsum("pij,pj->pi", Hpp_inv, t)
                back = jnp.einsum("prij,pj->pri", A, u).reshape(-1, 6)
                corr = jax.ops.segment_sum(back, cam_f, num_segments=C)
                y = hx - jax.lax.psum(corr, "ba")
                return y * free[:, None]

            # PCG on S dx = -b
            x0 = jnp.zeros_like(b)
            r0 = -b
            z0 = jnp.einsum("cij,cj->ci", Minv, r0) * free[:, None]
            p0 = z0

            def cg_body(carry, _):
                x, r, z, p = carry
                Sp = S_mv(p)
                pSp = jnp.sum(p * Sp)
                rz = jnp.sum(r * z)
                alpha = rz / jnp.where(jnp.abs(pSp) > 1e-12, pSp, 1.0)
                alpha = jnp.where(jnp.abs(pSp) > 1e-12, alpha, 0.0)
                x = x + alpha * p
                r = r - alpha * Sp
                z = jnp.einsum("cij,cj->ci", Minv, r) * free[:, None]
                beta = jnp.sum(r * z) / jnp.where(jnp.abs(rz) > 1e-12,
                                                  rz, 1.0)
                beta = jnp.where(jnp.abs(rz) > 1e-12, beta, 0.0)
                p = z + beta * p
                return (x, r, z, p), None

            (dxc, _, _, _), _ = jax.lax.scan(
                cg_body, (x0, r0, z0, p0), None, length=cg_iters)
            dxc = dxc * free[:, None]

            # back-substitute points: dxp = -Hpp^-1 (bp + W^T dxc)
            dg = dxc[cam_f].reshape(*cam_idx.shape, 6)
            t_p = jnp.einsum("prij,pri->pj", A, dg)
            dxp = -jnp.einsum("pij,pj->pi", Hpp_inv, bp + t_p)
            return lie.se3_retract(poses, dxc), pts_l + dxp, cost0

        def eval_cost(poses, pts_l):
            cam_f = cam_idx.reshape(-1)
            pose_o = poses[cam_f]
            X_o = jnp.repeat(pts_l, cam_idx.shape[1], axis=0)
            r, _, _, _ = camera.reproj_residual_and_jacobians(
                K, pose_o, X_o, uv.reshape(-1, 2))
            conf_f = conf.reshape(-1)
            chi2 = jnp.sum(r * r, axis=-1) * conf_f
            c = jnp.sum(jnp.where(conf_f > 0,
                                  robust.huber_cost(chi2, CHI2_MONO), 0.0))
            return jax.lax.psum(c, "ba")

        def body(carry, _):
            poses, pts_l, lam = carry
            cost0 = eval_cost(poses, pts_l)
            new_poses, new_pts, _ = lm_step(poses, pts_l, lam)
            cost1 = eval_cost(new_poses, new_pts)
            accept = cost1 < cost0
            poses = jnp.where(accept, new_poses, poses)
            pts_l = jnp.where(accept, new_pts, pts_l)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0),
                           1e-8, 1e4)
            return (poses, pts_l, lam), cost1

        (poses, pts_l, _), costs = jax.lax.scan(
            body, (poses, pts_l, jnp.float32(1e-4)), None, length=n_iters)
        return poses, pts_l, costs[-1]

    fn = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P("ba"), P("ba"), P("ba"), P("ba")),
        out_specs=(P(), P("ba"), P()),
        check_vma=False,
    )
    return fn(poses, points_sh, cam_idx_sh, uv_sh, conf_sh)


def _inv6x6(M):
    """Batched 6x6 inverse via solve against identity (C is small)."""
    eye = jnp.broadcast_to(jnp.eye(6, dtype=M.dtype), M.shape)
    return jnp.linalg.solve(
        M + 1e-8 * jnp.eye(6, dtype=M.dtype), eye)
