"""Unit tests for the ORB frontend: FAST, selection, descriptors, matching."""

import jax
import jax.numpy as jnp
import numpy as np

from rumi_slam_tpu.ops import fast, matcher, orb, select

RNG = np.random.default_rng(1)


def checkerboard(h=120, w=160, sq=16):
    y, x = np.mgrid[0:h, 0:w]
    img = (((y // sq) + (x // sq)) % 2) * 200.0 + 20.0
    return jnp.asarray(img.astype(np.float32))


def textured_image(h=120, w=160, n_blobs=40, seed=3):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 60.0, np.float32)
    for _ in range(n_blobs):
        cy, cx = rng.integers(12, h - 12), rng.integers(12, w - 12)
        s = rng.integers(2, 5)
        img[cy - s : cy + s, cx - s : cx + s] = rng.uniform(120, 255)
    return jnp.asarray(img)


class TestFast:
    def test_detects_blob_corners(self):
        # NOTE: checkerboard X-junctions are NOT FAST corners (bright/dark
        # arcs alternate at < 9 contiguous); square-blob L-corners are.
        img = textured_image()
        score = fast.fast_score(img, 20.0)
        assert float(jnp.sum(score > 0)) > 10

    def test_flat_image_no_corners(self):
        img = jnp.full((64, 64), 128.0)
        score = fast.fast_score(img, 20.0)
        assert float(jnp.sum(score)) == 0.0

    def test_nms_is_sparse(self):
        img = textured_image()
        s = fast.fast_score(img, 15.0)
        nms = fast.nms3x3(s)
        assert float(jnp.sum(nms > 0)) <= float(jnp.sum(s > 0))


class TestSelect:
    def test_budget_and_spread(self):
        img = textured_image()
        s = fast.nms3x3(fast.fast_score(img, 10.0))
        yx, resp, valid = select.select_keypoints(s, 64, cell=32, k_cell=4)
        assert yx.shape == (64, 2)
        n = int(jnp.sum(valid))
        assert n > 8
        # per-cell cap respected
        cells = (yx[:, 0] // 32) * 100 + yx[:, 1] // 32
        cells = np.asarray(cells)[np.asarray(valid)]
        _, counts = np.unique(cells, return_counts=True)
        assert counts.max() <= 4

    def test_scores_sorted_desc(self):
        img = textured_image()
        s = fast.nms3x3(fast.fast_score(img, 10.0))
        _, resp, valid = select.select_keypoints(s, 32)
        r = np.asarray(resp)[np.asarray(valid)]
        assert np.all(np.diff(r) <= 1e-6)


class TestExtract:
    def test_shapes_and_validity(self):
        img = textured_image(160, 200)
        f = orb.extract_orb(img, n_features=128, n_levels=4)
        assert f.uv.shape == (128, 2)
        assert f.desc.shape == (128, 8)
        assert f.desc.dtype == jnp.uint32
        assert int(jnp.sum(f.valid)) > 20
        # uv within image bounds (level-0 coords)
        uv = np.asarray(f.uv)[np.asarray(f.valid)]
        assert uv[:, 0].max() < 200 and uv[:, 1].max() < 160

    def test_descriptor_invariance_to_shift(self):
        """Same scene shifted -> descriptors of corresponding kps match."""
        base = np.asarray(textured_image(160, 200, seed=7))
        sh = np.roll(base, (0, 8), (0, 1))
        f1 = orb.extract_orb(jnp.asarray(base), n_features=96, n_levels=2)
        f2 = orb.extract_orb(jnp.asarray(sh), n_features=96, n_levels=2)
        idx, mdist = matcher.match_descriptors(f1, f2, max_dist=60.0, ratio=0.9)
        matched = np.asarray(idx) >= 0
        assert matched.sum() >= 10
        # matched pairs should be displaced by ~(8, 0)
        uv1 = np.asarray(f1.uv)[matched]
        uv2 = np.asarray(f2.uv)[np.asarray(idx)[matched]]
        d = uv2 - uv1
        med = np.median(d, axis=0)
        assert abs(med[0] - 8.0) < 1.5 and abs(med[1]) < 1.5


class TestMatcher:
    def test_mxu_matches_popcount(self):
        a = jnp.asarray(RNG.integers(0, 2**32, size=(33, 8), dtype=np.uint32))
        b = jnp.asarray(RNG.integers(0, 2**32, size=(47, 8), dtype=np.uint32))
        d1 = matcher.hamming_matrix(a, b)
        d2 = matcher.hamming_matrix_popcount(a, b)
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))

    def test_identity_match(self):
        a = jnp.asarray(RNG.integers(0, 2**32, size=(16, 8), dtype=np.uint32))
        d = matcher.hamming_matrix(a, a)
        idx, mdist = matcher.match(
            d, jnp.ones(16, bool), jnp.ones(16, bool), ratio=1.0
        )
        np.testing.assert_array_equal(np.asarray(idx), np.arange(16))
        assert float(jnp.max(mdist)) == 0.0

    def test_mask_blocks_matches(self):
        a = jnp.asarray(RNG.integers(0, 2**32, size=(8, 8), dtype=np.uint32))
        d = matcher.hamming_matrix(a, a)
        mask = jnp.zeros((8, 8), bool)
        idx, _ = matcher.match(d, jnp.ones(8, bool), jnp.ones(8, bool), mask=mask)
        assert np.all(np.asarray(idx) == -1)

    def test_radius_mask(self):
        uv_a = jnp.asarray([[0.0, 0.0], [10.0, 10.0]])
        uv_b = jnp.asarray([[1.0, 0.0], [20.0, 20.0]])
        m = matcher.radius_mask(uv_a, uv_b, 5.0)
        assert bool(m[0, 0]) and not bool(m[0, 1]) and not bool(m[1, 1])

    def test_chunked_matches_dense(self):
        """match_chunked (the bounded-memory whole-map reloc path) must agree
        with the dense matcher exactly — same top-2, threshold, ratio."""
        a = jnp.asarray(RNG.integers(0, 2**32, size=(64, 8), dtype=np.uint32))
        b = jnp.asarray(RNG.integers(0, 2**32, size=(256, 8), dtype=np.uint32))
        va = jnp.asarray(RNG.random(64) > 0.1)
        vb = jnp.asarray(RNG.random(256) > 0.1)
        d = matcher.hamming_matrix(a, b)
        idx_d, md_d = matcher.match(d, va, vb, max_dist=120.0, ratio=0.95)
        idx_c, md_c = matcher.match_chunked(
            a, va, b, vb, n_chunks=8, max_dist=120.0, ratio=0.95)
        np.testing.assert_array_equal(np.asarray(idx_d), np.asarray(idx_c))
        np.testing.assert_allclose(np.asarray(md_d), np.asarray(md_c))
