"""Oriented-BRIEF (ORB-style) feature extraction as one jitted array program.

JAX re-design of the reference's ORBextractor
(/root/reference/src/rumi-slam/lib_src/ORBextractor.cc — pyramid :1093, FAST +
quad-tree :726, intensity-centroid orientation, BRIEF descriptors :989-1091).
Differences by design, not omission:

* keypoint spread via bucketed top-k (ops/select.py) instead of the serial
  quad-tree;
* the sampling pattern is generated from a fixed-seed Gaussian (as in the
  BRIEF paper) rather than OpenCV's learned table — descriptors are
  self-consistent within this framework, which is all SLAM needs;
* rotation is discretized to 30 bins of 12 degrees (exactly OpenCV ORB's
  discretization) so BRIEF sampling becomes ONE ±1-difference bf16 matmul over
  all 30 precomputed rotated index tables (column b*256+k = point1 - point0 of
  bit k at bin b; ``patch @ D > 0`` IS the BRIEF test) followed by a bin
  gather — one tensor-core product instead of per-keypoint rotated
  gathers, and half the FLOPs and device-memory traffic of sampling both
  pattern points separately;
* Gaussian blur runs once per pyramid LEVEL (the reference blurs level images
  too, ORBextractor.cc:1080); orientation reads the unblurred patches;
* everything is static-shape: each pyramid level contributes a fixed budget
  of slots, invalid slots carry ``valid=False``.

All level keypoints are reported in level-0 pixel coordinates with their
octave and angle, matching the data the reference's Frame keeps per keypoint.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import fast, image, select

PATCH_R = 19  # gather radius: covers rotated pattern (|p|<=13 -> 13*sqrt(2)~18.4)
PATCH = 2 * PATCH_R + 1
PATTERN_R = 13
N_BITS = 256
N_ROT_BINS = 30  # 12-degree rotation bins (OpenCV ORB uses the same)

_rng = np.random.default_rng(20230817)
PATTERN = np.clip(
    _rng.normal(scale=PATTERN_R / 2.0, size=(N_BITS, 2, 2)), -PATTERN_R, PATTERN_R
).astype(np.float32)  # [256, 2(points), 2(y,x)]


def _build_rotation_tables():
    """Per-bin flattened patch indices [N_ROT_BINS, 512] and the ±1
    DIFFERENCE sampling matrix [PATCH*PATCH, N_ROT_BINS*256] for the matmul
    path: column (b*256 + k) holds +1 at bin-b's rotated index of pattern
    point 1 of bit k and -1 at point 0, so ``patch @ D > 0`` IS the BRIEF
    test — half the FLOPs and half the intermediate of sampling both
    points separately."""
    tabs = []
    for b in range(N_ROT_BINS):
        th = 2.0 * np.pi * b / N_ROT_BINS
        c, s = np.cos(th), np.sin(th)
        py, px = PATTERN[:, :, 0], PATTERN[:, :, 1]
        ry = px * s + py * c
        rx = px * c - py * s
        iy = np.clip(np.round(ry).astype(np.int64) + PATCH_R, 0, PATCH - 1)
        ix = np.clip(np.round(rx).astype(np.int64) + PATCH_R, 0, PATCH - 1)
        tabs.append((iy * PATCH + ix).reshape(-1))  # [512]
    tab = np.stack(tabs)  # [30, 512] (pairs interleaved: bit k -> 2k, 2k+1)
    D = np.zeros((PATCH * PATCH, N_ROT_BINS * N_BITS), np.float32)
    cols = np.arange(N_BITS)
    for b in range(N_ROT_BINS):
        np.add.at(D, (tab[b, 0::2], b * N_BITS + cols), -1.0)  # point 0
        np.add.at(D, (tab[b, 1::2], b * N_BITS + cols), +1.0)  # point 1
    return tab, D


ROT_TABLE, _SAMPLING = _build_rotation_tables()
SAMPLING_BF16 = jnp.asarray(_SAMPLING.astype(np.dtype("bfloat16")))

# circular mask for the intensity-centroid orientation (radius 15)
_ORI_R = 15
_oy, _ox = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
ORI_MASK = ((_oy**2 + _ox**2) <= _ORI_R**2).astype(np.float32)
ORI_Y = (_oy * ORI_MASK).astype(np.float32)
ORI_X = (_ox * ORI_MASK).astype(np.float32)


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set (SoA)."""

    uv: jnp.ndarray        # [N, 2] float32 — (x, y) in level-0 pixels
    response: jnp.ndarray  # [N] float32
    angle: jnp.ndarray     # [N] float32 radians
    octave: jnp.ndarray    # [N] int32
    desc: jnp.ndarray      # [N, 8] uint32 — 256 packed BRIEF bits
    valid: jnp.ndarray     # [N] bool

    @property
    def capacity(self):
        return self.uv.shape[0]


def level_budgets(n_features: int, n_levels: int, scale_factor: float):
    """Per-level keypoint budgets proportional to level area (reference
    distributes per-level counts the same way, ORBextractor.cc ctor)."""
    inv = [1.0 / (scale_factor ** (2 * i)) for i in range(n_levels)]
    total = sum(inv)
    raw = [max(8, int(round(n_features * v / total))) for v in inv]
    raw[0] += n_features - sum(raw)
    return raw


def _orientation(patches):
    """Intensity-centroid angle per patch [N, P, P] -> [N] radians."""
    m01 = jnp.einsum("nij,ij->n", patches, jnp.asarray(ORI_Y))
    m10 = jnp.einsum("nij,ij->n", patches, jnp.asarray(ORI_X))
    return jnp.arctan2(m01, m10)


def _descriptors(patches, angles):
    """Rotation-binned BRIEF via one ±1-difference bf16 matmul.

    patches: [N, P, P] (blurred); angles: [N].  Returns packed [N, 8] uint32.
    """
    n = patches.shape[0]
    bins = jnp.round(angles * (N_ROT_BINS / (2.0 * jnp.pi))).astype(jnp.int32)
    bins = jnp.mod(bins, N_ROT_BINS)
    flat = patches.reshape(n, PATCH * PATCH).astype(jnp.bfloat16)
    diffs = jnp.dot(flat, SAMPLING_BF16, preferred_element_type=jnp.float32)
    diffs = diffs.reshape(n, N_ROT_BINS, N_BITS)
    vals = jnp.take_along_axis(diffs, bins[:, None, None], axis=1)[:, 0, :]
    bits = (vals > 0).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(
        bits.reshape(n, 8, 32) << shifts[None, None, :], axis=-1
    )
    return packed.astype(jnp.uint32)


@jax.jit
def descriptors_at(img, uv, valid):
    """Orientation + BRIEF descriptors for EXTERNALLY GIVEN keypoints (level-0
    pixels) — the reference's CloudFrameComputeDescriptors
    (ORBextractor.cc:989: descriptors for cloud-map KFs whose keypoints came
    over the wire without descriptors).

    Returns (desc [N,8] uint32, angle [N]).
    """
    yx = jnp.stack(
        [jnp.round(uv[:, 1]).astype(jnp.int32),
         jnp.round(uv[:, 0]).astype(jnp.int32)], axis=-1
    )
    h, w = img.shape
    yx = jnp.clip(yx, 0, jnp.asarray([h - 1, w - 1]))
    # blur once at image level (cheaper than per-patch, and border-correct)
    both = image.gather_patches_multi(
        jnp.stack([img, image.gaussian_blur(img)]), yx, PATCH_R
    )
    angles = _orientation(both[0])
    desc = _descriptors(both[1], angles)
    zero = jnp.zeros_like(desc)
    return jnp.where(valid[:, None], desc, zero), jnp.where(valid, angles, 0.0)


@partial(
    jax.jit,
    static_argnames=("n_features", "n_levels", "scale_factor", "cell", "k_cell"),
)
def extract_orb(
    img,
    *,
    n_features: int = 1024,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell: int = 32,
    k_cell: int = 5,
) -> Features:
    """Full multi-scale ORB extraction on one image.

    The reference retries weak cells with ``minThFAST`` when ``iniThFAST``
    finds nothing (ORBextractor.cc:726-860); here both thresholds' score maps
    come from one shared circle-difference pass and the strong one is
    preferred per pixel by a large score bonus — one pass, no data-dependent
    control flow.
    """
    budgets = level_budgets(n_features, n_levels, scale_factor)
    pyr = image.build_pyramid(img, n_levels, scale_factor)

    uvs, resps, octs, valids, patch_list, blur_list = [], [], [], [], [], []
    for lvl in range(n_levels):
        il = pyr[lvl]
        strong, weak = fast.fast_score_pair(il, threshold, min_threshold)
        strong = fast.nms3x3(strong)
        weak = fast.nms3x3(weak)
        bonus = 1e6
        score = jnp.where(strong > 0, strong + bonus, weak)
        yx, resp, valid = select.select_keypoints(
            score, budgets[lvl], cell=cell, k_cell=k_cell
        )
        resp = jnp.where(resp > bonus / 2, resp - bonus, resp)
        both = image.gather_patches_multi(
            jnp.stack([il, image.gaussian_blur(il)]), yx, PATCH_R
        )
        patch_list.append(both[0])
        blur_list.append(both[1])

        s = scale_factor ** lvl
        # pixel-CENTER-aligned upscale: resize maps level pixel x to level-0
        # coordinate (x + 0.5) * s - 0.5; plain x * s biases high-level
        # keypoints by 0.5 * (s - 1) px (~1.3 px at level 7)
        uv0 = (
            jnp.stack(
                [yx[:, 1].astype(jnp.float32), yx[:, 0].astype(jnp.float32)],
                -1,
            )
            + 0.5
        ) * s - 0.5
        uvs.append(uv0)
        resps.append(resp)
        octs.append(jnp.full((budgets[lvl],), lvl, jnp.int32))
        valids.append(valid)

    # batch the per-keypoint work across ALL levels (patches share shape)
    patches = jnp.concatenate(patch_list, 0)          # [N, P, P]
    angles = _orientation(patches)
    desc = _descriptors(jnp.concatenate(blur_list, 0), angles)

    return Features(
        uv=jnp.concatenate(uvs, 0),
        response=jnp.concatenate(resps, 0),
        angle=angles,
        octave=jnp.concatenate(octs, 0),
        desc=desc,
        valid=jnp.concatenate(valids, 0),
    )
