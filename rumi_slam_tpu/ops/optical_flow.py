"""Pyramidal Lucas-Kanade optical flow (sparse, vmapped, pure JAX).

JAX replacement for the OpenCV ``calcOpticalFlowPyrLK`` call inside the
reference's lost-frame sampler (/root/reference/src/rumi-slam/lib_src/
KFDSample.cc:131 — flow magnitude drives the PD-controlled keyframe-density
sampling of lost frames).  Fixed iteration counts, masked outputs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import image as im


def _gradients(img):
    gy, gx = jnp.gradient(img)
    return gx, gy


def _gather_patches_bilinear(img, yx_f, win_r):
    """Patches at FRACTIONAL centers: bilinear blend of the four
    integer-center patches (subpixel sampling — OpenCV's LK interpolates;
    integer rounding biases the converged displacement by up to 0.5 px)."""
    i0 = jnp.floor(yx_f).astype(jnp.int32)
    f = yx_f - i0.astype(yx_f.dtype)           # [N,2] (fy, fx)
    fy = f[:, 0][:, None, None]
    fx = f[:, 1][:, None, None]
    P00 = im.gather_patches(img, i0, win_r)
    P01 = im.gather_patches(img, i0 + jnp.asarray([0, 1]), win_r)
    P10 = im.gather_patches(img, i0 + jnp.asarray([1, 0]), win_r)
    P11 = im.gather_patches(img, i0 + jnp.asarray([1, 1]), win_r)
    return ((1 - fy) * (1 - fx) * P00 + (1 - fy) * fx * P01
            + fy * (1 - fx) * P10 + fy * fx * P11)


def _lk_level(prev, cur, pts, disp, *, win_r=7, iters=5):
    """One pyramid level of LK refinement.

    pts: [N,2] (x,y) in this level's coords.  disp: [N,2] current estimate.
    """
    gx, gy = _gradients(prev)
    # template + gradients sampled at the TRUE fractional point positions —
    # truncating here while P1 below interpolates would register the
    # template against a shifted grid (phantom sub-pixel flow on identical
    # frames)
    yx = jnp.stack([pts[:, 1], pts[:, 0]], -1)
    P0 = _gather_patches_bilinear(prev, yx, win_r)   # [N,w,w]
    Gx = _gather_patches_bilinear(gx, yx, win_r)
    Gy = _gather_patches_bilinear(gy, yx, win_r)

    g11 = jnp.sum(Gx * Gx, axis=(1, 2))
    g12 = jnp.sum(Gx * Gy, axis=(1, 2))
    g22 = jnp.sum(Gy * Gy, axis=(1, 2))
    det = g11 * g22 - g12 * g12
    ok = det > 1e-6
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)

    def body(i, disp):
        yx2 = jnp.stack(
            [pts[:, 1] + disp[:, 1], pts[:, 0] + disp[:, 0]], -1
        )
        P1 = _gather_patches_bilinear(cur, yx2, win_r)
        dt = P1 - P0
        b1 = jnp.sum(dt * Gx, axis=(1, 2))
        b2 = jnp.sum(dt * Gy, axis=(1, 2))
        du = -(g22 * b1 - g12 * b2) * inv_det
        dv = -(g11 * b2 - g12 * b1) * inv_det
        step = jnp.stack([du, dv], -1)
        step = jnp.clip(step, -4.0, 4.0)
        return disp + step * ok[:, None]

    disp = jax.lax.fori_loop(0, iters, body, disp)
    return disp, ok


@partial(jax.jit, static_argnames=("n_levels", "win_r", "iters"))
def lk_flow(prev, cur, pts, valid, *, n_levels=3, win_r=7, iters=5):
    """Track points from ``prev`` to ``cur``.

    Args:
      prev, cur: [H,W] float32 images.
      pts: [N,2] (x,y) point locations in ``prev``.
      valid: [N] bool.
    Returns (flow [N,2], ok [N] bool).
    """
    pyr_p = [prev]
    pyr_c = [cur]
    for _ in range(1, n_levels):
        h, w = pyr_p[-1].shape
        pyr_p.append(im.resize_bilinear(pyr_p[-1], (h // 2, w // 2)))
        pyr_c.append(im.resize_bilinear(pyr_c[-1], (h // 2, w // 2)))

    disp = jnp.zeros_like(pts)
    ok_all = valid
    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0 ** lvl
        disp_l = disp / scale
        # pixel-CENTER-aligned level coordinates: resize maps source pixel x
        # to (x + 0.5)/s - 0.5 at the coarser level (plain x/s accumulates a
        # ~0.25 px offset per level into the coarse-to-fine handoff)
        pts_l = (pts + 0.5) / scale - 0.5
        disp_l, ok = _lk_level(pyr_p[lvl], pyr_c[lvl], pts_l, disp_l,
                               win_r=win_r, iters=iters)
        disp = disp_l * scale
        ok_all = ok_all & ok
    return disp, ok_all


def mean_flow_magnitude(prev, cur, pts, valid):
    """Mean |flow| over valid tracked points (reference Calmoptflmag,
    KFDSample.cc:186-198). Returns a scalar."""
    flow, ok = lk_flow(prev, cur, pts, valid)
    mag = jnp.linalg.norm(flow, axis=-1)
    n = jnp.maximum(jnp.sum(ok.astype(jnp.float32)), 1.0)
    return jnp.sum(jnp.where(ok, mag, 0.0)) / n
