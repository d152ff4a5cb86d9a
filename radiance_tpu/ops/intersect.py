"""Ray/primitive intersection routines (batched, elementwise).

Equivalents of the reference's device intersection routines
(reference: radiance/shader/radiance.cl:194-251): slab AABB test and
Möller–Trumbore triangle test, written as shape-polymorphic `jnp`
functions that broadcast over arbitrary leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp

FLT_MAX = jnp.float32(3.4028235e38)


def intersect_aabb(origin, inv_dir, box_min, box_max, t_clip=None):
    """Slab test (reference: radiance.cl:195-208).

    origin/inv_dir: [..., 3]; box_min/box_max: [..., 3].
    Returns bool [...] -- True when tFar > max(tNear, 0).

    `inv_dir` is the precomputed reciprocal direction (the reference divides
    per node; we hoist the reciprocal out of the traversal loop).
    `t_clip` (optional [...] ) additionally culls nodes whose entry distance
    exceeds the current best hit -- a pure pruning optimization that never
    changes which closest hit is found.
    """
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    # A ray parallel to an axis (inv_dir = +-inf) that starts exactly on
    # one of that axis's slab planes gives 0 * inf = NaN.  It lies inside
    # the (inclusive) slab for every t, so that axis must not constrain
    # the interval; NaN would instead fail every comparison and cull the
    # box.
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    t_near = jnp.max(jnp.where(jnp.isnan(lo), -jnp.inf, lo), axis=-1)
    t_far = jnp.min(jnp.where(jnp.isnan(hi), jnp.inf, hi), axis=-1)
    # The reference tests tFar > max(tNear, 0) strictly (radiance.cl:204),
    # which rejects zero-thickness boxes -- flat axis-aligned geometry
    # (walls, quads) produces exactly those, so the reference silently culls
    # it.  We use the inclusive comparison: the AABB test is only a
    # conservative cull; the triangle test remains the authority.
    hit = t_far >= jnp.maximum(t_near, 0.0)
    if t_clip is not None:
        hit = jnp.logical_and(hit, t_near < t_clip)
    return hit


def intersect_triangle(origin, direction, v0, e1, e2):
    """Möller–Trumbore (reference: radiance.cl:211-251), edge-precomputed form.

    origin/direction: [..., 3]; v0/e1/e2: [..., 3] with e1 = v1 - v0,
    e2 = v2 - v0 (the reference recomputes edges per test; we precompute them
    at BVH build time since the leaf bundles are already reordered copies).

    Returns (valid [...], t [...], b1 [...], b2 [...]).
    Matches the reference's accept conditions exactly:
    det != 0, 0 <= b1 <= 1, b2 >= 0, b1 + b2 <= 1, t > 0.
    """
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    # The reference computes 1/det then rejects det == 0; in IEEE f32 the
    # division yields inf which the comparisons below reject the same way,
    # but we keep the explicit predicate for exact parity.
    inv_det = 1.0 / det
    s = origin - v0
    b1 = inv_det * jnp.sum(s * pvec, axis=-1)
    qvec = jnp.cross(s, e1)
    b2 = inv_det * jnp.sum(direction * qvec, axis=-1)
    t = inv_det * jnp.sum(e2 * qvec, axis=-1)

    valid = (
        (det != 0.0)
        & (b1 >= 0.0) & (b1 <= 1.0)
        & (b2 >= 0.0) & (b1 + b2 <= 1.0)
        & (t > 0.0)
    )
    return valid, t, b1, b2


def intersect_triangle_soup(origin, direction, v0, e1, e2, tmin, tmax):
    """Brute-force closest hit against a triangle soup; the test oracle.

    origin/direction: [N, 3]; v0/e1/e2: [T, 3].
    Returns (t [N], tri_idx [N], b1 [N], b2 [N]) with t = +inf on miss.
    Accept window matches traversal: tmin < t < tmax (radiance.cl:91).
    """
    o = origin[:, None, :]
    d = direction[:, None, :]
    valid, t, b1, b2 = intersect_triangle(o, d, v0[None], e1[None], e2[None])
    valid = valid & (t > tmin) & (t < tmax)
    t = jnp.where(valid, t, FLT_MAX)
    best = jnp.argmin(t, axis=1)
    n = jnp.arange(origin.shape[0])
    t_best = t[n, best]
    hit = t_best < FLT_MAX
    return (
        t_best,
        jnp.where(hit, best, -1),
        b1[n, best],
        b2[n, best],
    )
