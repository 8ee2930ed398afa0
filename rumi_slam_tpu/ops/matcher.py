"""Batched Hamming descriptor matching as int8 matmuls.

JAX replacement for the reference's ORBmatcher
(/root/reference/src/rumi-slam/lib_src/ORBmatcher.cc — SearchByProjection :39
/:1498, SearchForInitialization :581, SearchByBoW :682, Fuse :1015,
DescriptorDistance :1830).  All of those strategies reduce to ONE primitive
here: a dense masked Hamming-distance matrix plus per-call-site masks
(projection windows, grid radii, octave gates), then best/second-best
selection with ratio and rotation-consistency checks.

The distance matrix itself is one product: packed 256-bit descriptors are
unpacked to ±1 int8 vectors and  ham(a,b) = (256 - a·b)/2  is an int8 matmul
with int32 accumulation (exact), which XLA hands to the int8 tensor cores.
A popcount path is kept as the verification oracle.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

TH_LOW = 50.0    # reference ORBmatcher.h TH_LOW
TH_HIGH = 100.0  # reference ORBmatcher.h TH_HIGH
HISTO_BINS = 30


def unpack_pm1(desc_packed):
    """[N, 8] uint32 -> [N, 256] int8 in {-1, +1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc_packed[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(desc_packed.shape[0], 256)
    return (2 * bits.astype(jnp.int8) - 1).astype(jnp.int8)


def hamming_matrix(desc_a, desc_b):
    """Dense Hamming distances [Na, Nb] (float32) via an int8 matmul."""
    a = unpack_pm1(desc_a)
    b = unpack_pm1(desc_b)
    dots = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )
    return (256 - dots).astype(jnp.float32) * 0.5


def hamming_matrix_popcount(desc_a, desc_b):
    """Reference popcount implementation (oracle for tests)."""
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.float32)


def radius_mask(uv_a, uv_b, radius):
    """[Na, Nb] bool — b within ``radius`` px of a.  ``radius`` may be scalar
    or per-a [Na] (the reference scales windows by octave)."""
    d = uv_a[:, None, :] - uv_b[None, :, :]
    r = jnp.asarray(radius)
    r2 = (r * r)[..., None] if r.ndim == 1 else r * r
    return jnp.sum(d * d, axis=-1) <= r2


def octave_mask(oct_a, oct_b, tol=1):
    return jnp.abs(oct_a[:, None] - oct_b[None, :]) <= tol


@partial(jax.jit, static_argnames=("cross_check",))
def match(
    dist,
    valid_a,
    valid_b,
    *,
    mask=None,
    max_dist=TH_LOW,
    ratio=0.9,
    cross_check=False,
):
    """Best-match selection from a distance matrix.

    Args:
      dist: [Na, Nb] distances.
      valid_a/valid_b: validity masks.
      mask: optional [Na, Nb] bool of allowed pairs (projection windows etc).
      max_dist: absolute acceptance threshold.
      ratio: Lowe ratio — best < ratio * second-best (reference mfNNratio).
      cross_check: also require a to be b's best match.

    Returns:
      idx_b: [Na] int32 — matched column per row, -1 if none.
      mdist: [Na] float32 — distance of the accepted match (inf if none).
    """
    big = jnp.float32(1e9)
    allowed = valid_a[:, None] & valid_b[None, :]
    if mask is not None:
        allowed &= mask
    d = jnp.where(allowed, dist, big)

    # best and second best per row
    top2_neg, top2_idx = jax.lax.top_k(-d, 2)
    best = -top2_neg[:, 0]
    second = -top2_neg[:, 1]
    idx = top2_idx[:, 0]

    ok = (best <= max_dist) & (best < ratio * second) & valid_a
    if cross_check:
        col_best = jnp.argmin(d, axis=0)  # [Nb]
        ok &= col_best[idx] == jnp.arange(d.shape[0])
    return jnp.where(ok, idx, -1), jnp.where(ok, best, jnp.inf)


@partial(jax.jit, static_argnames=("n_chunks",))
def match_chunked(desc_a, valid_a, desc_b, valid_b, *, n_chunks: int,
                  max_dist=TH_LOW, ratio=0.9):
    """Best-match selection against a LARGE descriptor bank without ever
    materializing the full [Na, Nb] distance matrix.

    ``desc_b`` is processed in ``n_chunks`` row blocks under a lax.scan that
    carries the running (best, second-best, argbest) per query row — peak
    device memory is one [Na, Nb/n_chunks] block instead of the whole matrix
    (the r2/r3 whole-map-relocalization scaling wall: [1024, 256*1024] f32
    would be ~1 GB at full KF capacity).

    Returns (idx_b [Na] int32 global column, -1 if none; mdist [Na]).
    """
    big = jnp.float32(1e9)
    Nb = desc_b.shape[0]
    assert Nb % n_chunks == 0, (Nb, n_chunks)
    Cb = Nb // n_chunks
    a = unpack_pm1(desc_a)                                   # [Na,256] int8

    desc_b_c = desc_b.reshape(n_chunks, Cb, 8)
    valid_b_c = valid_b.reshape(n_chunks, Cb)
    base = jnp.arange(n_chunks, dtype=jnp.int32) * Cb

    def body(carry, inp):
        best, second, bidx = carry
        d_c, ok_c, b0 = inp
        b = unpack_pm1(d_c)
        dots = jax.lax.dot_general(
            a, b, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)
        d = (256 - dots).astype(jnp.float32) * 0.5
        d = jnp.where(valid_a[:, None] & ok_c[None, :], d, big)
        top2_neg, top2_idx = jax.lax.top_k(-d, 2)
        cb, cs = -top2_neg[:, 0], -top2_neg[:, 1]
        ci = top2_idx[:, 0].astype(jnp.int32) + b0
        new_best = jnp.minimum(best, cb)
        new_idx = jnp.where(cb < best, ci, bidx)
        new_second = jnp.minimum(jnp.minimum(second, cs),
                                 jnp.maximum(best, cb))
        return (new_best, new_second, new_idx), None

    Na = desc_a.shape[0]
    init = (jnp.full((Na,), big), jnp.full((Na,), big),
            jnp.full((Na,), -1, jnp.int32))
    (best, second, idx), _ = jax.lax.scan(
        body, init, (desc_b_c, valid_b_c, base))
    ok = (best <= max_dist) & (best < ratio * second) & valid_a
    return jnp.where(ok, idx, -1), jnp.where(ok, best, jnp.inf)


def window_match_reference(desc_a, desc_b, uv_a, uv_b, radius, valid_a,
                           valid_b, *, max_dist=TH_LOW, ratio=0.9):
    """Best match of each ``a`` among the ``b`` within ``radius`` px (the
    projection window of SearchByProjection): dense Hamming matrix, radius
    mask, top-2 selection.  Returns (idx_b [Na], mdist [Na]) as ``match``.
    The plain path: it runs on the CPU and is the reference the fused
    kernel is checked against."""
    return match(hamming_matrix(desc_a, desc_b), valid_a, valid_b,
                 mask=radius_mask(uv_a, uv_b, radius), max_dist=max_dist,
                 ratio=ratio)


def window_match(desc_a, desc_b, uv_a, uv_b, radius, valid_a, valid_b, *,
                 max_dist=TH_LOW, ratio=0.9):
    """``window_match_reference``'s contract, chosen per platform when the
    program is lowered: the plain path on the CPU, the fused Pallas kernel
    (ops.fused_matcher) on CUDA GPUs, and an error on any other platform."""
    from .fused_matcher import fused_match

    kw = dict(max_dist=max_dist, ratio=ratio)
    return jax.lax.platform_dependent(
        desc_a, desc_b, uv_a, uv_b, radius, valid_a, valid_b,
        cpu=partial(window_match_reference, **kw),
        cuda=partial(fused_match, **kw))


def rotation_consistency(idx_b, angle_a, angle_b, keep_top=3):
    """Keep only matches whose angle difference falls in the ``keep_top`` most
    popular of 30 histogram bins (reference ComputeThreeMaxima,
    ORBmatcher.cc:1790-1828).  Returns filtered idx_b."""
    matched = idx_b >= 0
    dang = angle_a - angle_b[jnp.clip(idx_b, 0)]
    dang = jnp.mod(dang, 2 * jnp.pi)
    bins = jnp.clip(
        (dang * (HISTO_BINS / (2 * jnp.pi))).astype(jnp.int32), 0, HISTO_BINS - 1
    )
    hist = jnp.zeros(HISTO_BINS, jnp.int32).at[bins].add(matched.astype(jnp.int32))
    top_vals, top_bins = jax.lax.top_k(hist, keep_top)
    # reference drops maxima <10% of the best bin
    good_bin = top_vals >= jnp.maximum(1, (0.1 * top_vals[0]).astype(jnp.int32))
    in_top = jnp.any(
        (bins[:, None] == top_bins[None, :]) & good_bin[None, :], axis=-1
    )
    return jnp.where(matched & in_top, idx_b, -1)


def match_descriptors(
    feats_a,
    feats_b,
    *,
    mask=None,
    max_dist=TH_LOW,
    ratio=0.9,
    cross_check=False,
    check_rotation=True,
):
    """Convenience wrapper over two Features pytrees (ops.orb.Features)."""
    dist = hamming_matrix(feats_a.desc, feats_b.desc)
    idx, mdist = match(
        dist,
        feats_a.valid,
        feats_b.valid,
        mask=mask,
        max_dist=max_dist,
        ratio=ratio,
        cross_check=cross_check,
    )
    if check_rotation:
        idx = rotation_consistency(idx, feats_a.angle, feats_b.angle)
        mdist = jnp.where(idx >= 0, mdist, jnp.inf)
    return idx, mdist
