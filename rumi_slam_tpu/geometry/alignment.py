"""Closed-form Sim(3)/SE(3) point-cloud alignment: Horn and Umeyama.

JAX equivalent of the reference's Sim3Solver closed forms
(/root/reference/src/rumi-slam/lib_src/Sim3Solver.cc:406-441 — Horn
``ComputeSim3`` and Eigen::umeyama-based ``umeyamaSolve``).  Both are written
as weighted batched least squares so RANSAC becomes a ``vmap`` over hypothesis
subsets and the final solve a single masked call.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import lie


def umeyama_alignment(src, dst, weights=None, *, with_scale=True):
    """Weighted Umeyama: find Sim3 S with  dst ~= s R src + t.

    Args:
      src, dst: [N,3] point sets.
      weights:  [N] nonnegative (None = uniform). Zero-weight rows are ignored,
                which is how masked/padded inputs are handled under jit.
      with_scale: if False, scale is fixed to 1 (SE3 / Horn-without-scale).

    Returns:
      S [8] Sim3 (see geometry.lie) mapping src-frame to dst-frame.
    """
    n = src.shape[0]
    w = jnp.ones((n,), src.dtype) if weights is None else weights
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    wn = w / wsum

    mu_s = jnp.sum(wn[:, None] * src, axis=0)
    mu_d = jnp.sum(wn[:, None] * dst, axis=0)
    sc = src - mu_s
    dc = dst - mu_d

    # covariance dst-src
    Sigma = jnp.einsum("n,ni,nj->ij", wn, dc, sc)
    U, D, Vt = jnp.linalg.svd(Sigma)
    det_sign = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
    S_fix = jnp.diag(jnp.array([1.0, 1.0, 1.0], src.dtype).at[2].set(det_sign))
    R = U @ S_fix @ Vt

    var_s = jnp.sum(wn * jnp.sum(sc * sc, axis=-1))
    trace_DS = jnp.sum(D * jnp.diag(S_fix))
    s = jnp.where(with_scale, trace_DS / jnp.maximum(var_s, 1e-12), 1.0)

    t = mu_d - s * (R @ mu_s)
    q = lie.quat_from_matrix(R)
    return jnp.concatenate([q, t, jnp.log(jnp.maximum(s, 1e-12))[None]], axis=-1)


def horn_alignment(src, dst, weights=None):
    """Horn's quaternion method with scale: dst ~= s R src + t.

    Same contract as :func:`umeyama_alignment`; this is the solver the
    reference uses inside Sim3Solver RANSAC (Sim3Solver.cc:437-540).  Uses the
    4x4 quaternion eigenproblem, so it needs only a symmetric eigendecomposition
    (cheap and batched on the device).
    """
    n = src.shape[0]
    w = jnp.ones((n,), src.dtype) if weights is None else weights
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    wn = w / wsum

    mu_s = jnp.sum(wn[:, None] * src, axis=0)
    mu_d = jnp.sum(wn[:, None] * dst, axis=0)
    sc = src - mu_s
    dc = dst - mu_d

    M = jnp.einsum("n,ni,nj->ij", wn, sc, dc)  # src->dst correlation
    sxx, sxy, sxz = M[0, 0], M[0, 1], M[0, 2]
    syx, syy, syz = M[1, 0], M[1, 1], M[1, 2]
    szx, szy, szz = M[2, 0], M[2, 1], M[2, 2]
    N = jnp.array(
        [
            [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
            [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
            [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
            [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz],
        ],
        dtype=src.dtype,
    )
    evals, evecs = jnp.linalg.eigh(N)
    q = evecs[:, -1]  # largest eigenvalue -> optimal quaternion (w,x,y,z)
    q = lie.quat_normalize(jnp.where(q[0] < 0, -q, q))

    rot_sc = lie.quat_rotate(q[None], sc)
    num = jnp.sum(wn * jnp.sum(dc * rot_sc, axis=-1))
    den = jnp.sum(wn * jnp.sum(sc * sc, axis=-1))
    s = num / jnp.maximum(den, 1e-12)
    s = jnp.maximum(s, 1e-9)

    t = mu_d - s * lie.quat_rotate(q[None], mu_s[None])[0]
    return jnp.concatenate([q, t, jnp.log(s)[None]], axis=-1)
