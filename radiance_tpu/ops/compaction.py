"""Wavefront compaction + material-sorted shading queues.

The wavefront optimizations of the literature (SURVEY.md 7): stream-compact
live rays between bounces and sort shading work by shader/material key so
each SBT dispatch touches a dense, coherent queue instead of a masked full
wavefront.  XLA requires static shapes, so "compaction" here is
*permutation*: live rays are moved to the front (stable), the count rides
along, and downstream stages simply process a prefix.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def compact_mask(mask: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stable front-compaction permutation for a bool mask.

    Returns (perm [N] i32, count []) where perm lists indices of True
    entries first (in order), then the False entries.  Gathering any ray
    array by `perm` yields the compacted layout.
    """
    n = mask.shape[0]
    # cumsum + scatter instead of a sort: one prefix sum and one
    # scatter, linear in N.  Stability falls out of the scan:
    # live entry i lands at (#live before i), dead entry i at
    # n_live + (#dead before i).
    if n == 0:
        return jnp.zeros(0, jnp.int32), jnp.int32(0)
    idx = jnp.arange(n, dtype=jnp.int32)
    c_live = jnp.cumsum(mask.astype(jnp.int32)).astype(jnp.int32)
    n_live = c_live[-1]
    pos = jnp.where(mask, c_live - 1, n_live + (idx - c_live))
    perm = jnp.zeros(n, jnp.int32).at[pos].set(idx)
    return perm, n_live


def sort_by_key(keys: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Material/shader-key sort permutation (stable).

    Returns (perm, sorted_keys).  The wavefront analog of the reference's
    SBT switch (shader.cl:574-605): after permutation, rays with the same
    hit-shader key are contiguous, so masked dispatch touches dense runs.
    """
    perm = jnp.argsort(keys, stable=True).astype(jnp.int32)
    return perm, keys[perm]


def apply_perm(tree, perm: jnp.ndarray):
    """Gather every array leaf of a pytree by the permutation."""
    return jax.tree_util.tree_map(lambda x: x[perm], tree)


def invert_perm(perm: jnp.ndarray) -> jnp.ndarray:
    """Inverse permutation (scatter results back to pixel order)."""
    n = perm.shape[0]
    return jnp.zeros(n, perm.dtype).at[perm].set(
        jnp.arange(n, dtype=perm.dtype))


def segment_bounds(sorted_keys: jnp.ndarray, n_keys: int) -> jnp.ndarray:
    """Start offsets of each key segment in a sorted key array.

    Returns [n_keys + 1] i32 with segment k spanning
    [bounds[k], bounds[k+1]).  n_keys must be a static upper bound.
    """
    ks = jnp.arange(n_keys + 1, dtype=sorted_keys.dtype)
    return jnp.searchsorted(sorted_keys, ks, side="left").astype(jnp.int32)


def _part1by2(v):
    """Spread 10 bits to every 3rd bit (Morton interleave helper)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def coherence_key(origin, direction):
    """Sort key grouping rays into traversal-coherent runs: direction
    octant (major) then a 30-bit Morton code of the origin.  Secondary
    waves (bounce/shadow) arrive in pixel order with scattered origins
    and directions; a global sort by this key brings rays that visit
    the same nodes next to each other (the ray-reordering idea of the
    wavefront literature, PAPERS.md)."""
    oct_ = ((direction[:, 0] < 0).astype(jnp.int32)
            + 2 * (direction[:, 1] < 0).astype(jnp.int32)
            + 4 * (direction[:, 2] < 0).astype(jnp.int32))
    lo = jnp.min(origin, axis=0)
    hi = jnp.max(origin, axis=0)
    q = ((origin - lo) / jnp.maximum(hi - lo, 1e-20) * 1023.0)
    q = jnp.clip(q, 0.0, 1023.0).astype(jnp.int32)
    morton = (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
              | (_part1by2(q[:, 2]) << 2))
    # (oct << 28) + (morton >> 2) stays inside int32
    return (oct_ << 28) + (morton >> 2)
