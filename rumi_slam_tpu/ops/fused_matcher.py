"""Fused windowed Hamming match for Hopper (Pallas, Triton route).

Same contract as ``ops.matcher.window_match_reference``:
``matcher.match(hamming_matrix(q, p), valid_q, valid_p,
mask=radius_mask(uv_q, uv_p, radius))``; ``matcher.window_match`` picks this
kernel on CUDA GPUs.  The plain path writes an [F, P] float32 distance matrix
and a mask to device memory and runs ``top_k`` over them; this kernel forms
each distance tile with an int8 tensor-core product, applies the radius gate
from the pixel coordinates in registers, and keeps only a running
(best, second, argbest) per query.

Grid: query tiles x point splits.  Each program walks its split in point
sub-tiles; a small ``jnp`` pass merges the splits' partial top-2.

Validity is positional: invalid queries move to -1e9 and invalid points to
+1e9 in pixel space, so the radius gate rejects them.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .matcher import unpack_pm1

_BIG = 1e9  # plain float: a kernel cannot capture jnp constants

# Tiles and launch: 64-query tiles x 16 point splits, walked in 64-point
# sub-tiles, 4 warps, 3 pipeline stages -- the fastest of those tried on an
# H100 at F=2048, P=16384 (PERF.md).
BQ, BP, SPLITS = 64, 64, 16
NUM_WARPS, NUM_STAGES = 4, 3


def _kernel(r2_ref, qd_ref, pd_ref, qx_ref, qy_ref, px_ref, py_ref,
            best_ref, second_ref, idx_ref):
    bq, bp = BQ, BP
    n_steps = pd_ref.shape[0] // bp
    col_base = pl.program_id(1) * pd_ref.shape[0]
    r2 = r2_ref[()]
    q = qd_ref[...]
    qx = qx_ref[...][:, None]
    qy = qy_ref[...][:, None]
    cols = jax.lax.broadcasted_iota(jnp.int32, (bq, bp), 1)

    def body(step, carry):
        best, second, bidx = carry
        sl = pl.ds(step * bp, bp)
        dots = pl.dot(q, pd_ref[sl, :], trans_b=True)           # [bq, bp] i32
        dist = (256 - dots).astype(jnp.float32) * 0.5
        du = qx - px_ref[sl][None, :]
        dv = qy - py_ref[sl][None, :]
        dist = jnp.where(du * du + dv * dv <= r2, dist, _BIG)

        tile_best = jnp.min(dist, axis=1)
        tile_arg = jnp.argmin(dist, axis=1).astype(jnp.int32)
        tile_second = jnp.min(
            jnp.where(cols == tile_arg[:, None], _BIG, dist), axis=1)
        tile_arg = tile_arg + col_base + step * bp
        # ties keep the earlier column, as top_k does
        new_idx = jnp.where(tile_best < best, tile_arg, bidx)
        new_second = jnp.minimum(jnp.minimum(second, tile_second),
                                 jnp.maximum(best, tile_best))
        return jnp.minimum(best, tile_best), new_second, new_idx

    init = (jnp.full((bq,), _BIG, jnp.float32),
            jnp.full((bq,), _BIG, jnp.float32),
            jnp.full((bq,), -1, jnp.int32))
    best, second, bidx = jax.lax.fori_loop(0, n_steps, body, init)
    best_ref[...] = best
    second_ref[...] = second
    idx_ref[...] = bidx


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@partial(jax.jit, static_argnames=("interpret",))
def fused_match(desc_q, desc_p, uv_q, uv_p, radius, valid_q, valid_p, *,
                max_dist=80.0, ratio=0.9, interpret: bool = False):
    """Windowed best match of F query descriptors against P points.

    Args:
      desc_q [F, 8] / desc_p [P, 8]: packed uint32 descriptors.
      uv_q [F, 2] / uv_p [P, 2]: query and projected point pixels.
      radius: scalar window radius in pixels.
      valid_q [F] / valid_p [P]: validity masks.
    F and P need not tile: queries pad to ``BQ`` and points to ``SPLITS``
    power-of-two splits of ``BP``-wide sub-tiles.
    Returns (idx [F] int32, -1 none; dist [F] float32, inf none).
    """
    F, P = desc_q.shape[0], desc_p.shape[0]
    bq, splits = BQ, SPLITS
    Fp = pl.cdiv(F, bq) * bq
    ps = max(BP, _next_pow2(pl.cdiv(P, splits)))
    Pp = ps * splits

    qd = jnp.pad(unpack_pm1(desc_q), ((0, Fp - F), (0, 0)))
    pd = jnp.pad(unpack_pm1(desc_p), ((0, Pp - P), (0, 0)))
    quv = jnp.pad(jnp.where(valid_q[:, None], uv_q, -_BIG).astype(jnp.float32),
                  ((0, Fp - F), (0, 0)), constant_values=-_BIG)
    puv = jnp.pad(jnp.where(valid_p[:, None], uv_p, _BIG).astype(jnp.float32),
                  ((0, Pp - P), (0, 0)), constant_values=_BIG)
    r2 = jnp.square(jnp.asarray(radius, jnp.float32))

    q_spec = pl.BlockSpec((bq,), lambda i, j: (i,))
    p_spec = pl.BlockSpec((ps,), lambda i, j: (j,))
    out_spec = pl.BlockSpec((None, bq), lambda i, j: (j, i))
    best, second, idx = pl.pallas_call(
        _kernel,
        grid=(Fp // bq, splits),
        in_specs=[
            pl.BlockSpec((), lambda i, j: ()),
            pl.BlockSpec((bq, 256), lambda i, j: (i, 0)),
            pl.BlockSpec((ps, 256), lambda i, j: (j, 0)),
            q_spec, q_spec, p_spec, p_spec,
        ],
        out_specs=[out_spec, out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((splits, Fp), jnp.float32),
                   jax.ShapeDtypeStruct((splits, Fp), jnp.float32),
                   jax.ShapeDtypeStruct((splits, Fp), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="fused_window_match",
    )(r2, qd, pd, quv[:, 0], quv[:, 1], puv[:, 0], puv[:, 1])

    # merge the splits' partial top-2: the first split holding the minimum
    # wins (lower columns, as top_k), second = min of everything else
    win = jnp.argmin(best, axis=0)
    rows = jnp.arange(Fp)
    b = best[win, rows]
    others = jnp.where(jnp.arange(splits)[:, None] == win[None, :], _BIG, best)
    s = jnp.minimum(jnp.min(second, axis=0), jnp.min(others, axis=0))
    i = idx[win, rows]
    b, s, i = b[:F], s[:F], i[:F]
    ok = (b <= max_dist) & (b < ratio * s) & valid_q & (i >= 0)
    return jnp.where(ok, i, -1), jnp.where(ok, b, jnp.inf)
