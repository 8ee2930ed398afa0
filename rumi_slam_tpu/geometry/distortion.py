"""Radial-tangential (OpenCV "plumb bob") distortion + keypoint undistortion.

JAX equivalent of the reference's Frame::UndistortKeyPoints
(/root/reference/src/rumi-slam/lib_src/Frame.cc — cv::undistortPoints over the
extracted keypoints, using Camera1.k1/k2/p1/p2[/k3] from the YAML settings;
Settings.cc reads the same five coefficients).  The pipeline stays pinhole:
keypoints are undistorted ONCE after extraction, exactly as the reference
does, so every downstream kernel sees ideal pixels.

``undistort_points`` inverts the distortion by fixed-count Newton/fixed-point
iteration (cv::undistortPoints uses the same fixed-point scheme, 5
iterations) — jit-friendly, no data-dependent control flow.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def distort_normalized(xy, dist):
    """Apply radtan distortion to normalized coords [...,2].

    dist: [5] (k1, k2, p1, p2, k3).
    """
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    x_t = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([x * radial + x_t, y * radial + y_t], axis=-1)


@partial(jax.jit, static_argnames=("n_iters",))
def undistort_points(K, dist, uv, *, n_iters: int = 8):
    """Undistort pixel keypoints [...,2] -> ideal pinhole pixels.

    Fixed-point iteration x_{n+1} = (x_d - tangential(x_n)) / radial(x_n),
    the cv::undistortPoints scheme (default 5 iterations; 8 here for the
    stronger TUM1 distortion).
    """
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy

    def body(i, xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        x_t = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / jnp.where(jnp.abs(radial) < 1e-9, 1e-9, radial)
        return jnp.stack([(xd - x_t) * inv, (yd - y_t) * inv], axis=-1)

    xy = jax.lax.fori_loop(0, n_iters, body,
                           jnp.stack([xd, yd], axis=-1))
    return jnp.stack(
        [xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], axis=-1
    )


def has_distortion(dist) -> bool:
    import numpy as np

    return dist is not None and bool(np.any(np.asarray(dist) != 0.0))
