"""Sim(3) pose-graph (essential-graph) optimization.

JAX equivalent of the reference's Optimizer::OptimizeEssentialGraph
(/root/reference/src/rumi-slam/lib_src/Optimizer.cc:1357 and merge variant
:1625): Gauss-Newton over per-keyframe Sim3 vertices with relative-pose
residuals on spanning-tree + covisibility + loop edges, then point correction
by each point's reference KF transform (the reference's post-optimization MP
propagation).

Design: edges are a static-capacity SoA list (i, j, S_ij_meas [8], weight).
The residual for edge (i,j) is log(S_ij_meas^-1 * S_i * S_j^-1) in the Sim3
tangent — 7 numbers.  Jacobians come from jax.jacfwd over the two endpoint
tangents (7x7 blocks, exact); the normal equations assemble by segment_sum
into a block-sparse H that we solve dense (7K x 7K; K <= 256 keyframes is
well within a single-chip dense solve, and the distributed variant shards
edges exactly like parallel/sharded_ba.py shards observations).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie


class PoseGraphEdges(NamedTuple):
    i: jnp.ndarray       # [E] int32
    j: jnp.ndarray       # [E] int32
    S_ij: jnp.ndarray    # [E,8] measured relative Sim3: S_i * S_j^-1
    weight: jnp.ndarray  # [E] float32 (0 disables)


def relative_sim3(S_i, S_j):
    """S_ij = S_i * S_j^-1 (the measurement model)."""
    return lie.sim3_compose(S_i, lie.sim3_inverse(S_j))


def edge_residual(S_i, S_j, S_ij_meas):
    """[...,7] tangent residual log(meas^-1 * S_i * S_j^-1)."""
    rel = relative_sim3(S_i, S_j)
    err = lie.sim3_compose(lie.sim3_inverse(S_ij_meas), rel)
    return lie.sim3_log(err)


def build_edges_from_covisibility(kf_sim3, covis_weights, kf_valid, *,
                                  min_weight: int = 100, max_edges: int = 2048,
                                  seq_window: int = 1):
    """Construct the essential-graph edge list the reference uses: strong
    covisibility edges (weight>=100) + sequential (spanning-tree-like) edges.
    Host-side helper (numpy), returns PoseGraphEdges padded to max_edges."""
    import numpy as np

    Wc = np.asarray(covis_weights)
    valid = np.asarray(kf_valid)
    K = Wc.shape[0]
    edges = []
    for a in range(K):
        if not valid[a]:
            continue
        for step in range(1, seq_window + 1):  # sequential chain
            b = a + step
            if b < K and valid[b]:
                edges.append((a, b, 1.0))
        for b in range(a + 1, K):
            if valid[b] and Wc[a, b] >= min_weight:
                edges.append((a, b, float(Wc[a, b]) / 100.0))
    edges = edges[:max_edges]
    E = max_edges
    i = np.zeros(E, np.int32)
    j = np.zeros(E, np.int32)
    w = np.zeros(E, np.float32)
    for n, (a, b, ww) in enumerate(edges):
        i[n], j[n], w[n] = a, b, ww
    S = np.stack([
        np.asarray(relative_sim3(kf_sim3[int(a)], kf_sim3[int(b)]))
        if w[n] > 0 else np.asarray(lie.sim3_identity())
        for n, (a, b) in enumerate(zip(i, j))
    ]) if E else np.zeros((0, 8), np.float32)
    return PoseGraphEdges(
        i=jnp.asarray(i), j=jnp.asarray(j), S_ij=jnp.asarray(S),
        weight=jnp.asarray(w),
    )


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_pose_graph(kf_sim3, edges: PoseGraphEdges, fixed, *,
                        n_iters: int = 10, lam0: float = 1e-4):
    """Gauss-Newton over Sim3 vertices.

    Args:
      kf_sim3: [K,8] current per-KF world->camera Sim3 (scale 1 for normal
        KFs; loop-corrected KFs carry the drift-corrected scale).
      edges: measurement list (weights 0 pad).
      fixed: [K] bool — anchored vertices (the reference fixes the loop KF's
        neighborhood / the initial KF).
    Returns optimized [K,8].
    """
    K = kf_sim3.shape[0]

    def residual_of(tau_i, tau_j, S_i, S_j, S_m):
        return edge_residual(
            lie.sim3_retract(S_i, tau_i), lie.sim3_retract(S_j, tau_j), S_m
        )

    z7 = jnp.zeros(7)
    J_i_fn = jax.vmap(jax.jacfwd(residual_of, argnums=0),
                      in_axes=(None, None, 0, 0, 0))
    J_j_fn = jax.vmap(jax.jacfwd(residual_of, argnums=1),
                      in_axes=(None, None, 0, 0, 0))
    r_fn = jax.vmap(residual_of, in_axes=(None, None, 0, 0, 0))

    free = (~fixed).astype(jnp.float32)

    def body(carry, _):
        S, lam = carry
        Si = S[edges.i]
        Sj = S[edges.j]
        r = r_fn(z7, z7, Si, Sj, edges.S_ij)          # [E,7]
        Ji = J_i_fn(z7, z7, Si, Sj, edges.S_ij)       # [E,7,7]
        Jj = J_j_fn(z7, z7, Si, Sj, edges.S_ij)
        w = edges.weight

        # assemble dense H [K,7,K,7], b [K,7]
        Hii = jax.ops.segment_sum(jnp.einsum("eki,e,ekj->eij", Ji, w, Ji),
                                  edges.i, num_segments=K)
        Hjj = jax.ops.segment_sum(jnp.einsum("eki,e,ekj->eij", Jj, w, Jj),
                                  edges.j, num_segments=K)
        bi = jax.ops.segment_sum(jnp.einsum("eki,e,ek->ei", Ji, w, r),
                                 edges.i, num_segments=K)
        bj = jax.ops.segment_sum(jnp.einsum("eki,e,ek->ei", Jj, w, r),
                                 edges.j, num_segments=K)
        Hij = jnp.einsum("eki,e,ekj->eij", Ji, w, Jj)  # [E,7,7]

        H = jnp.zeros((K, 7, K, 7))
        diag = jnp.arange(K)
        H = H.at[diag, :, diag, :].add(Hii + Hjj)
        H = H.at[edges.i, :, edges.j, :].add(Hij)
        H = H.at[edges.j, :, edges.i, :].add(jnp.swapaxes(Hij, -1, -2))
        b = bi + bj

        # fix anchors
        H = H * free[:, None, None, None] * free[None, None, :, None]
        H = H.at[diag, :, diag, :].add(jnp.eye(7) * (1.0 - free)[:, None, None]
                                       + lam * jnp.eye(7))
        b = b * free[:, None]

        dx = -jnp.linalg.solve(
            H.reshape(K * 7, K * 7) + 1e-8 * jnp.eye(K * 7), b.reshape(K * 7)
        ).reshape(K, 7)
        dx = dx * free[:, None]

        S_new = lie.sim3_retract(S, dx)
        cost0 = jnp.sum(w * jnp.sum(r * r, axis=-1))
        r1 = r_fn(z7, z7, S_new[edges.i], S_new[edges.j], edges.S_ij)
        cost1 = jnp.sum(w * jnp.sum(r1 * r1, axis=-1))
        accept = cost1 < cost0
        S = jnp.where(accept, S_new, S)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e2)
        return (S, lam), cost1

    (S, _), _ = jax.lax.scan(body, (kf_sim3, jnp.float32(lam0)), None,
                             length=n_iters)
    return S


class PoseGraphEdgesSE3(NamedTuple):
    """SE(3) edge list for the 4-DoF pose graph."""

    i: jnp.ndarray       # [E] int32
    j: jnp.ndarray       # [E] int32
    T_ij: jnp.ndarray    # [E,7] measured relative SE3: T_i * T_j^-1
    weight: jnp.ndarray  # [E] float32 (0 disables)


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_pose_graph_4dof(kf_se3, edges: PoseGraphEdgesSE3, fixed, *,
                             n_iters: int = 10, lam0: float = 1e-4):
    """4-DoF pose graph — the reference's OptimizeEssentialGraph4DoF
    (Optimizer.cc:5417): for gravity-aligned (visual-inertial) maps roll and
    pitch are observable from the IMU, so each vertex optimizes only yaw +
    translation.  Implemented as the SE(3) graph with the per-vertex tangent
    restricted to (yaw, v) — tau6 = (0, 0, yaw, v) under the same
    left-multiplicative retraction as the full graph.

    Args:
      kf_se3: [K,7] per-KF T_cw.
      fixed:  [K] bool anchors.
    Returns optimized [K,7].
    """
    K = kf_se3.shape[0]

    def retract4(T, tau4):
        tau6 = jnp.concatenate([jnp.zeros(2), tau4])
        return lie.se3_retract(T, tau6)

    def residual_of(tau_i, tau_j, T_i, T_j, T_m):
        rel = lie.se3_compose(retract4(T_i, tau_i),
                              lie.se3_inverse(retract4(T_j, tau_j)))
        err = lie.se3_compose(lie.se3_inverse(T_m), rel)
        return lie.se3_log(err)

    z4 = jnp.zeros(4)
    J_i_fn = jax.vmap(jax.jacfwd(residual_of, argnums=0),
                      in_axes=(None, None, 0, 0, 0))
    J_j_fn = jax.vmap(jax.jacfwd(residual_of, argnums=1),
                      in_axes=(None, None, 0, 0, 0))
    r_fn = jax.vmap(residual_of, in_axes=(None, None, 0, 0, 0))
    free = (~fixed).astype(jnp.float32)

    def body(carry, _):
        T, lam = carry
        Ti = T[edges.i]
        Tj = T[edges.j]
        r = r_fn(z4, z4, Ti, Tj, edges.T_ij)         # [E,6]
        Ji = J_i_fn(z4, z4, Ti, Tj, edges.T_ij)      # [E,6,4]
        Jj = J_j_fn(z4, z4, Ti, Tj, edges.T_ij)
        w = edges.weight

        Hii = jax.ops.segment_sum(jnp.einsum("eki,e,ekj->eij", Ji, w, Ji),
                                  edges.i, num_segments=K)
        Hjj = jax.ops.segment_sum(jnp.einsum("eki,e,ekj->eij", Jj, w, Jj),
                                  edges.j, num_segments=K)
        bi = jax.ops.segment_sum(jnp.einsum("eki,e,ek->ei", Ji, w, r),
                                 edges.i, num_segments=K)
        bj = jax.ops.segment_sum(jnp.einsum("eki,e,ek->ei", Jj, w, r),
                                 edges.j, num_segments=K)
        Hij = jnp.einsum("eki,e,ekj->eij", Ji, w, Jj)

        H = jnp.zeros((K, 4, K, 4))
        diag = jnp.arange(K)
        H = H.at[diag, :, diag, :].add(Hii + Hjj)
        H = H.at[edges.i, :, edges.j, :].add(Hij)
        H = H.at[edges.j, :, edges.i, :].add(jnp.swapaxes(Hij, -1, -2))
        b = bi + bj

        H = H * free[:, None, None, None] * free[None, None, :, None]
        H = H.at[diag, :, diag, :].add(jnp.eye(4) * (1.0 - free)[:, None, None]
                                       + lam * jnp.eye(4))
        b = b * free[:, None]

        dx = -jnp.linalg.solve(
            H.reshape(K * 4, K * 4) + 1e-8 * jnp.eye(K * 4), b.reshape(K * 4)
        ).reshape(K, 4)
        dx = dx * free[:, None]

        T_new = jax.vmap(retract4)(T, dx)
        cost0 = jnp.sum(w * jnp.sum(r * r, axis=-1))
        r1 = r_fn(z4, z4, T_new[edges.i], T_new[edges.j], edges.T_ij)
        cost1 = jnp.sum(w * jnp.sum(r1 * r1, axis=-1))
        accept = cost1 < cost0
        T = jnp.where(accept, T_new, T)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e2)
        return (T, lam), cost1

    (T, _), _ = jax.lax.scan(body, (kf_se3, jnp.float32(lam0)), None,
                             length=n_iters)
    return T


def correct_points(pt_xyz, pt_ref_kf, pt_valid, kf_sim3_old, kf_sim3_new):
    """Move points with their reference KF (the reference's MP correction
    after essential-graph optimization, Optimizer.cc:1560-1620 analogue):
    X' = S_new_ref^-1 ( S_old_ref ( X ) )."""
    ref = jnp.clip(pt_ref_kf, 0)
    S_old = kf_sim3_old[ref]
    S_new = kf_sim3_new[ref]
    moved = lie.sim3_apply(
        lie.sim3_inverse(S_new), lie.sim3_apply(S_old, pt_xyz)
    )
    return jnp.where(pt_valid[:, None] & (pt_ref_kf >= 0)[:, None],
                     moved, pt_xyz)
