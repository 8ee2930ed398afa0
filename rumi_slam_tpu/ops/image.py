"""Image primitives: pyramid, separable blur, patch gather (pure JAX).

These replace the OpenCV calls in the reference's ORBextractor
(/root/reference/src/rumi-slam/lib_src/ORBextractor.cc:1093 ComputePyramid,
GaussianBlur before descriptor sampling at :1080) with XLA-fusable array ops.
Images are ``float32 [H, W]`` in [0, 255].
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def resize_bilinear(img, new_hw):
    return jax.image.resize(img, new_hw, method="linear")


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def sep_conv2d(img, k1d):
    """Separable 2D convolution with reflect padding, [H,W] float32.

    Implemented as shift-and-add (slice + scalar-multiply-accumulate), not
    ``lax.conv``: small-radius separable filters are bandwidth-bound
    elementwise work, and shifts keep the default layout and fuse cleanly
    into consumers such as the ORB patch gather.
    """
    r = (len(k1d) - 1) // 2
    k = jnp.asarray(k1d)
    h, w = img.shape
    x = jnp.pad(img, ((r, r), (0, 0)), mode="reflect")
    x = sum(k[i] * x[i:i + h, :] for i in range(2 * r + 1))
    x = jnp.pad(x, ((0, 0), (r, r)), mode="reflect")
    x = sum(k[i] * x[:, i:i + w] for i in range(2 * r + 1))
    return x


def gaussian_blur(img, sigma=2.0, radius=3):
    return sep_conv2d(img, gaussian_kernel1d(sigma, radius))


def build_pyramid(img, n_levels: int, scale_factor: float):
    """List of images; level i has shape floor(shape / scale^i)."""
    h, w = img.shape
    pyr = [img]
    for i in range(1, n_levels):
        s = scale_factor ** i
        pyr.append(resize_bilinear(img, (max(8, int(h / s)), max(8, int(w / s)))))
    return pyr


def max_pool3x3(x):
    """3x3 max filter, same shape (for NMS)."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )


def gather_patches(img, centers_yx, patch_radius: int):
    """Gather square patches around integer centers.

    Args:
      img: [H, W] float32.
      centers_yx: [N, 2] int32 (y, x) patch centers (level coordinates).
      patch_radius: patches are (2r+1, 2r+1).

    Returns [N, 2r+1, 2r+1].  Centers near the border read into a
    reflect-padded canvas, so all outputs are well-defined.

    Implemented rows-then-columns: a whole-row gather (contiguous,
    bandwidth-friendly) followed by per-patch dynamic column slices, instead
    of a naive 2D dynamic_slice or flat scalar gathers.
    """
    r = patch_radius
    padded = jnp.pad(img, r, mode="reflect")
    size = 2 * r + 1
    n = centers_yx.shape[0]
    wp = padded.shape[1]

    rows = (centers_yx[:, 0, None] + jnp.arange(size)[None, :]).reshape(-1)
    strips = padded[rows].reshape(n, size, wp)

    def one(strip, x):
        return jax.lax.dynamic_slice(strip, (0, x), (size, size))

    return jax.vmap(one)(strips, centers_yx[:, 1])


def gather_patches_multi(imgs, centers_yx, patch_radius: int):
    """gather_patches over C stacked images sharing the same centers.

    imgs: [C, H, W]; returns [C, N, 2r+1, 2r+1].  One rows-gather + one
    dynamic-slice pass serves all channels (used to fetch the raw and the
    blurred pixels of each keypoint patch in a single gather).
    """
    r = patch_radius
    padded = jnp.pad(imgs, ((0, 0), (r, r), (r, r)), mode="reflect")
    size = 2 * r + 1
    n = centers_yx.shape[0]
    wp = padded.shape[2]

    rows = (centers_yx[:, 0, None] + jnp.arange(size)[None, :]).reshape(-1)
    strips = padded[:, rows].reshape(-1, n, size, wp)

    def one(strip_c, x):
        return jax.lax.dynamic_slice(strip_c, (0, 0, x),
                                     (strip_c.shape[0], size, size))

    return jnp.swapaxes(
        jax.vmap(one, in_axes=(1, 0))(strips, centers_yx[:, 1]), 0, 1
    )


@partial(jax.jit, static_argnames=("out_hw",))
def resize_to(img, out_hw):
    return resize_bilinear(img, out_hw)
