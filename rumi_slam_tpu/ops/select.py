"""Spatially-bucketed keypoint selection (quad-tree replacement).

The reference spreads keypoints with a sequential quad-tree
(ORBextractor::DistributeOctTree,
/root/reference/src/rumi-slam/lib_src/ORBextractor.cc:538-724) — inherently
serial.  The JAX equivalent: per-cell top-k over a fixed grid followed
by a global top-N, which yields the same spatial-spread effect as a fully
parallel reduction (SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("n_total", "cell", "k_cell"))
def select_keypoints(score, n_total: int, cell: int = 32, k_cell: int = 5):
    """Pick up to ``n_total`` keypoints from a dense score map.

    Per-cell cap ``k_cell`` enforces spatial spread; a global top-N then fills
    the budget from the strongest remaining candidates.

    Returns:
      yx:    [n_total, 2] int32 (y, x); rows past the real count are (0,0).
      s:     [n_total] float32 scores (0 for invalid rows).
      valid: [n_total] bool.
    """
    h, w = score.shape
    ph = (h + cell - 1) // cell * cell
    pw = (w + cell - 1) // cell * cell
    sp = jnp.pad(score, ((0, ph - h), (0, pw - w)), constant_values=0.0)

    ncy, ncx = ph // cell, pw // cell
    cells = sp.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell
    )
    cs, ci = jax.lax.top_k(cells, k_cell)  # [ncells, k_cell]

    # flat-cell index -> global (y, x)
    cell_ids = jax.lax.broadcasted_iota(jnp.int32, (ncy * ncx, k_cell), 0)
    cy = cell_ids // ncx
    cx = cell_ids % ncx
    iy = ci // cell
    ix = ci % cell
    gy = cy * cell + iy
    gx = cx * cell + ix

    flat_s = cs.reshape(-1)
    flat_y = gy.reshape(-1)
    flat_x = gx.reshape(-1)

    k = min(n_total, flat_s.shape[0])
    top_s, top_i = jax.lax.top_k(flat_s, k)
    yx = jnp.stack([flat_y[top_i], flat_x[top_i]], axis=-1)
    valid = top_s > 0.0
    if k < n_total:
        pad = n_total - k
        yx = jnp.concatenate([yx, jnp.zeros((pad, 2), jnp.int32)], axis=0)
        top_s = jnp.concatenate([top_s, jnp.zeros((pad,), top_s.dtype)], axis=0)
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)], axis=0)
    yx = jnp.where(valid[:, None], yx, 0)
    top_s = jnp.where(valid, top_s, 0.0)
    return yx.astype(jnp.int32), top_s, valid
