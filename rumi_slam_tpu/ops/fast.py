"""FAST-16/9 corner detector as a dense, branch-free array program.

JAX replacement for the per-cell OpenCV FAST calls in the reference's
ORBextractor::ComputeKeyPointsOctTree
(/root/reference/src/rumi-slam/lib_src/ORBextractor.cc:726-860).  Instead of
scalar pixel loops, the whole segment test runs as 16 shifted-image compares +
a cumulative-sum window reduction, producing a dense score map that downstream
bucketed top-k selection consumes (ops/select.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 — 16 (dy, dx) offsets in contiguous ring order.
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9: need >= 9 contiguous bright or dark circle pixels


def fast_score_pair(img, th_strong: float, th_weak: float, border: int = 16):
    """Both strong- and weak-threshold score maps from ONE shared
    circle-difference pass (the reference's iniThFAST/minThFAST retry,
    ORBextractor.cc:726-860, without recomputing the 16 shifts)."""
    shifted = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), (0, 1)) for dy, dx in CIRCLE], axis=0
    )
    d = shifted - img[None]
    h, w = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (
        (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    )

    def score_at(threshold):
        bright = (d > threshold).astype(jnp.int32)
        dark = (d < -threshold).astype(jnp.int32)

        def has_arc(flags):
            ext = jnp.concatenate([flags, flags[: ARC_LEN - 1]], axis=0)
            cs = jnp.cumsum(ext, axis=0)
            cs = jnp.concatenate([jnp.zeros_like(cs[:1]), cs], axis=0)
            win = cs[ARC_LEN:] - cs[:-ARC_LEN]
            return jnp.max(win, axis=0) >= ARC_LEN

        is_corner = has_arc(bright) | has_arc(dark)
        sad_bright = jnp.sum(jnp.maximum(d - threshold, 0.0), axis=0)
        sad_dark = jnp.sum(jnp.maximum(-d - threshold, 0.0), axis=0)
        score = jnp.maximum(sad_bright, sad_dark)
        return jnp.where(is_corner & inside, score, 0.0)

    return score_at(th_strong), score_at(th_weak)


def fast_score(img, threshold: float, border: int = 16):
    """Dense FAST-16/9 corner score map.

    Args:
      img: [H, W] float32 intensities.
      threshold: intensity difference threshold (reference default ini=20/min=7,
        config/TUM3.yaml ORBextractor.iniThFAST).
      border: pixels near the edge are zeroed (keypoint patches must fit).

    Returns:
      score: [H, W] float32 — 0 where not a corner, else a SAD-style strength
      (sum of circle differences beyond threshold on the stronger polarity).
    """
    shifted = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), (0, 1)) for dy, dx in CIRCLE], axis=0
    )  # [16, H, W]
    d = shifted - img[None]

    bright = (d > threshold).astype(jnp.int32)
    dark = (d < -threshold).astype(jnp.int32)

    def has_arc(flags):
        ext = jnp.concatenate([flags, flags[: ARC_LEN - 1]], axis=0)  # [24,H,W]
        cs = jnp.cumsum(ext, axis=0)
        cs = jnp.concatenate([jnp.zeros_like(cs[:1]), cs], axis=0)  # [25,H,W]
        win = cs[ARC_LEN:] - cs[:-ARC_LEN]  # [16,H,W] window sums
        return jnp.max(win, axis=0) >= ARC_LEN

    is_corner = has_arc(bright) | has_arc(dark)

    sad_bright = jnp.sum(jnp.maximum(d - threshold, 0.0), axis=0)
    sad_dark = jnp.sum(jnp.maximum(-d - threshold, 0.0), axis=0)
    score = jnp.maximum(sad_bright, sad_dark)
    score = jnp.where(is_corner, score, 0.0)

    h, w = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (
        (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    )
    return jnp.where(inside, score, 0.0)


def nms3x3(score):
    """Keep only 3x3-local maxima (ties broken toward the first in raster
    order by strict comparison against the dilated map)."""
    from .image import max_pool3x3

    dil = max_pool3x3(score)
    return jnp.where((score >= dil) & (score > 0.0), score, 0.0)
