"""Fused Pallas matcher: equivalence (interpret mode), padding and the
per-platform choice; global BA."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from rumi_slam_tpu.geometry import camera, lie
from rumi_slam_tpu.mapstate import map_state as M
from rumi_slam_tpu.ops import matcher
from rumi_slam_tpu.ops.fused_matcher import fused_match
from rumi_slam_tpu.tracking.local_mapping import global_bundle_adjustment


@pytest.mark.parametrize("F,P", [(256, 1024), (100, 1000), (130, 20),
                                 (67, 1100)])
def test_fused_match_equals_reference(F, P):
    rng = np.random.default_rng(0)
    dq = jnp.asarray(rng.integers(0, 2**32, (F, 8), dtype=np.uint32))
    dp = jnp.asarray(rng.integers(0, 2**32, (P, 8), dtype=np.uint32))
    # duplicate some point descriptors from queries so real matches exist
    n = min(F, P, 100)
    rows = rng.choice(P, n, replace=False)
    qrows = rng.choice(F, n, replace=False)
    dp = dp.at[rows].set(dq[qrows])
    valid_q = jnp.asarray(rng.random(F) > 0.1)
    valid_p = jnp.asarray(rng.random(P) > 0.1)
    uv_q = jnp.asarray(rng.uniform(0, 300, (F, 2)), jnp.float32)
    uv_p = jnp.asarray(rng.uniform(0, 300, (P, 2)), jnp.float32)
    uv_p = uv_p.at[rows].set(uv_q[qrows] + 5.0)
    radius = 60.0

    idx_f, dist_f = fused_match(dq, dp, uv_q, uv_p, radius, valid_q, valid_p,
                                max_dist=80.0, ratio=0.9, interpret=True)
    dist = matcher.hamming_matrix(dq, dp)
    mask = matcher.radius_mask(uv_q, uv_p, radius)
    idx_r, dist_r = matcher.match(dist, valid_q, valid_p, mask=mask,
                                  max_dist=80.0, ratio=0.9)
    np.testing.assert_array_equal(np.asarray(idx_f), np.asarray(idx_r))
    matched = np.asarray(idx_r) >= 0
    assert matched.sum() > n // 2
    np.testing.assert_array_equal(np.asarray(dist_f), np.asarray(dist_r))


def _match_args(F=70, P=300):
    rng = np.random.default_rng(1)
    return (jnp.asarray(rng.integers(0, 2**32, (F, 8), dtype=np.uint32)),
            jnp.asarray(rng.integers(0, 2**32, (P, 8), dtype=np.uint32)),
            jnp.zeros((F, 2)), jnp.zeros((P, 2)), jnp.float32(15.0),
            jnp.ones(F, bool), jnp.ones(P, bool))


def test_window_match_picks_kernel_per_platform():
    """One choice point: the Triton kernel when lowered for CUDA, the plain
    reference on the CPU, an error anywhere else."""
    traced = jax.jit(matcher.window_match).trace(*_match_args())
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "fused_window_match" in cuda and "triton" in cuda
    assert "fused_window_match" not in cpu and "triton" not in cpu
    with pytest.raises(NotImplementedError):
        traced.lower(lowering_platforms=("rocm",))


@pytest.mark.parametrize("F,P,Fp,ps", [
    (2000, 16384, 2048, 1024),
    (70, 300, 128, 64),
    (65, 5001, 128, 512),
])
def test_fused_match_pads_to_tiles(F, P, Fp, ps):
    """Queries pad to the 64-query tile, points to 16 power-of-two splits of
    whole 64-point sub-tiles: the kernel's operands take these shapes."""
    args = _match_args(F, P)
    jaxpr = jax.make_jaxpr(lambda *a: fused_match(
        *a, interpret=True))(*args)
    txt = str(jaxpr)
    assert f"i8[{Fp},256]" in txt and f"i8[{ps * 16},256]" in txt
    assert f"f32[16,{Fp}]" in txt


def test_global_bundle_adjustment_reduces_error():
    """Perturbed poses+points over a small full map; GBA must pull both back
    (reference GlobalBundleAdjustemnt, Optimizer.cc:48)."""
    rng = np.random.default_rng(1)
    K = jnp.asarray([260.0, 260.0, 159.5, 119.5])
    n_kf, n_feat, n_pt = 6, 64, 64

    X_true = jnp.asarray(rng.uniform([-2, -2, 3], [2, 2, 9], (n_pt, 3)),
                         jnp.float32)
    poses_true = []
    for i in range(n_kf):
        q = lie.so3_exp(jnp.asarray(rng.normal(scale=0.02, size=3), jnp.float32))
        t = jnp.asarray([0.25 * i, 0.02 * i, 0.0], jnp.float32)
        poses_true.append(lie.se3(q, t))
    poses_true = jnp.stack(poses_true)

    ms = M.empty(n_kf, n_feat, n_pt)
    kf_uv = []
    for i in range(n_kf):
        uv, z = camera.project_world(K, poses_true[i], X_true)
        kf_uv.append(uv)
    kf_uv = jnp.stack(kf_uv)
    ms = ms._replace(
        kf_pose=poses_true,
        kf_uv=kf_uv,
        kf_feat_valid=jnp.ones((n_kf, n_feat), bool),
        kf_point=jnp.tile(jnp.arange(n_pt)[None, :], (n_kf, 1)),
        kf_map_id=jnp.zeros(n_kf, jnp.int32),
        kf_valid=jnp.ones(n_kf, bool),
        kf_time=jnp.arange(n_kf, dtype=jnp.float32),
        pt_xyz=X_true,
        pt_valid=jnp.ones(n_pt, bool),
        pt_map_id=jnp.zeros(n_pt, jnp.int32),
        n_kf=jnp.int32(n_kf),
        n_pt=jnp.int32(n_pt),
    )

    # perturb everything except the two gauge anchors
    pert_pose = poses_true.at[2:, 4:7].add(
        jnp.asarray(rng.normal(scale=0.05, size=(n_kf - 2, 3)), jnp.float32)
    )
    pert_pts = X_true + jnp.asarray(rng.normal(scale=0.05, size=(n_pt, 3)),
                                    jnp.float32)
    ms_p = ms._replace(kf_pose=pert_pose, pt_xyz=pert_pts)

    ms_o = global_bundle_adjustment(ms_p, K, 0, n_iters=25)

    err_before = float(jnp.linalg.norm(pert_pose[2:] - poses_true[2:],
                                       axis=-1).mean())
    err_after = float(jnp.linalg.norm(ms_o.kf_pose[2:] - poses_true[2:],
                                      axis=-1).mean())
    assert err_after < 0.2 * err_before
    pt_err = float(jnp.linalg.norm(ms_o.pt_xyz - X_true, axis=-1).mean())
    assert pt_err < 0.02
