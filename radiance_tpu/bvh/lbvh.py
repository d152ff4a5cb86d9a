"""On-device LBVH builder: Morton sort + Karras hierarchy in pure JAX.

The reference builds BVHs exclusively on the host with a recursive SAH
sweep (reference: radiance/src/bvh.cpp:46-285) -- fine for static scenes,
but rebuilds for animated geometry would round-trip the device.  This
builder runs entirely on the device with vectorized primitives:

  1. quantize triangle centroids to a 10-bit grid, interleave to 30-bit
     Morton codes
  2. sort (jnp.argsort on (code << 32 | index) keys -- unique keys make
     the Karras construction well-defined)
  3. group 8 consecutive sorted triangles into one leaf bundle (leaf
     collapsing keeps the traversal's fixed-width bundle contract)
  4. Karras-style internal-node construction: each internal node's range,
     split, and children computed independently (fully parallel)
  5. leaf-up AABB propagation and root-down escape threading, each as a
     fixed number of whole-array gather passes (no sequential recursion)

Output is a DeviceScene (single identity instance) directly usable by
ops.traversal -- no host round trip.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from radiance_tpu import config
from radiance_tpu.bvh.device import (
    DeviceScene, KIND_INNER, KIND_TRI_LEAF, KIND_INST_LEAF,
    META_A_MASK, META_COUNT_SHIFT, META_KIND_SHIFT)

LEAF_W = config.LEAF_WIDTH


def _expand_bits(v: jnp.ndarray) -> jnp.ndarray:
    """Spread 10 bits to every 3rd position (u32)."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(p: jnp.ndarray) -> jnp.ndarray:
    """[N, 3] float in [0, 1] -> 30-bit Morton codes (u32)."""
    q = jnp.clip(p * 1024.0, 0.0, 1023.0).astype(jnp.uint32)
    return ((_expand_bits(q[:, 0]) << 2)
            | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def _bit_length(x: jnp.ndarray) -> jnp.ndarray:
    """Position of highest set bit (0 for x == 0), branch-free, u32."""
    x = x.astype(jnp.uint32)
    n = jnp.zeros(x.shape, dtype=jnp.int32)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (jnp.uint32(1) << shift)
        n = n + jnp.where(big, shift, 0)
        x = jnp.where(big, x >> shift, x)
    return n + jnp.where(x > 0, 1, 0).astype(jnp.int32)


def _delta(keys, i, j, g: int):
    """Common-prefix length of 64-bit keys represented as (code, index)
    u32 pairs; -1 when j out of range.  Indices are unique so keys never
    collide (the Karras construction requires distinct keys)."""
    codes, idxs = keys
    j_ok = (j >= 0) & (j < g)
    jc = jnp.clip(j, 0, g - 1)
    xc = codes[i] ^ codes[jc]
    xi = idxs[i] ^ idxs[jc]
    nlz = jnp.where(xc != 0,
                    32 - _bit_length(xc),
                    64 - _bit_length(xi))
    return jnp.where(j_ok, nlz, -1)


def _karras_children(keys: jnp.ndarray, g: int):
    """For internal nodes i in [0, g-2]: (left, right, left_is_leaf,
    right_is_leaf) following Karras 2012 construction over g leaves."""
    i = jnp.arange(g - 1)
    # range/search loops need ~log2(g) rounds; g is static at trace time
    rounds = max(int(g).bit_length() + 1, 2)

    d = jnp.sign(_delta(keys, i, i + 1, g) - _delta(keys, i, i - 1, g))
    d = jnp.where(d == 0, 1, d).astype(jnp.int32)

    delta_min = _delta(keys, i, i - d, g)

    # find upper bound on range length by galloping
    lmax = jnp.full_like(i, 2)
    for _ in range(rounds):
        probe = _delta(keys, i, i + lmax * d, g)
        grow = probe > delta_min
        lmax = jnp.where(grow, lmax * 2, lmax)

    # binary search the exact other end
    l = jnp.zeros_like(i)
    t = lmax // 2
    for _ in range(rounds):
        probe = _delta(keys, i, i + (l + t) * d, g)
        l = jnp.where((t > 0) & (probe > delta_min), l + t, l)
        t = t // 2
    j = i + l * d

    # split position: highest differing bit within [min(i,j), max(i,j)]
    delta_node = _delta(keys, i, j, g)
    s = jnp.zeros_like(i)
    t = (l + 1) // 2
    # ceil-halving sequence
    for _ in range(rounds):
        probe = _delta(keys, i, i + (s + t) * d, g)
        s = jnp.where((t > 0) & (probe > delta_node), s + t, s)
        t = jnp.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + jnp.minimum(d, 0)

    left_is_leaf = jnp.minimum(i, j) == gamma
    right_is_leaf = jnp.maximum(i, j) == gamma + 1
    return gamma, left_is_leaf, right_is_leaf, i, j


def build_lbvh(tri_v0: jnp.ndarray, tri_v1: jnp.ndarray, tri_v2: jnp.ndarray,
               prim_id: jnp.ndarray):
    """Device-side LBVH over triangles.

    tri_v0/v1/v2: [T, 3] f32 vertex positions; prim_id: [T] i32.
    Returns dict of arrays shaped like DeviceScene's BLAS portion:
    node_packed [Nn, 8] (Nn = 2*G-1, G = ceil(T/8) leaf groups, node 0 is
    the root), bundle_packed [G, 8, 12].
    """
    t = tri_v0.shape[0]
    g = max(-(-t // LEAF_W), 2)  # at least 2 groups so internals exist

    lo = jnp.minimum(jnp.minimum(tri_v0, tri_v1), tri_v2)
    hi = jnp.maximum(jnp.maximum(tri_v0, tri_v1), tri_v2)
    centers = (lo + hi) * 0.5
    smin = jnp.min(lo, axis=0)
    smax = jnp.max(hi, axis=0)
    norm = (centers - smin) / jnp.maximum(smax - smin, 1e-12)
    codes = morton3d(norm)

    order = jnp.argsort(codes.astype(jnp.uint32))
    # group keys: (code of first tri in group, unique group index) pairs
    first = order[jnp.minimum(jnp.arange(g) * LEAF_W, t - 1)]
    gkeys = (codes[first].astype(jnp.uint32),
             jnp.arange(g, dtype=jnp.uint32))

    gamma, left_leaf, right_leaf, ri, rj = _karras_children(gkeys, g)

    n_internal = g - 1
    n_nodes = n_internal + g
    # node layout: internal nodes [0, g-1), leaves [g-1, 2g-1)
    left = jnp.where(left_leaf, gamma + n_internal, gamma)
    right = jnp.where(right_leaf, gamma + 1 + n_internal, gamma + 1)

    # --- leaf bundles ---
    lane = jnp.arange(LEAF_W)
    slots = jnp.arange(g)[:, None] * LEAF_W + lane[None, :]
    valid = slots < t
    sl = jnp.minimum(slots, t - 1)
    src = order[sl]
    v0g = jnp.where(valid[..., None], tri_v0[src], 0.0)
    v1g = jnp.where(valid[..., None], tri_v1[src], 0.0)
    v2g = jnp.where(valid[..., None], tri_v2[src], 0.0)
    pidg = jnp.where(valid, prim_id[src], -1).astype(jnp.int32)

    # bundles are packed in INT32 space: device float ops may flush
    # denormal bit patterns to zero and canonicalize NaN payloads, so an int
    # (prim id, meta word, escape index) bitcast into an f32 array and
    # then touched by ANY f32 update/select is silently corrupted on
    # device (e.g. meta 0x00000faf -> 0x0, esc 0xffffffff ->
    # 0x7fc00000).  Building the packed rows as int32 and bitcasting
    # ONCE at the end is bit-safe: gathers/slices of the f32 result
    # are pure data movement.
    bundle_i = jnp.zeros((g, LEAF_W, 12), jnp.int32)
    bundle_i = bundle_i.at[:, :, 0:3].set(
        jax.lax.bitcast_convert_type(v0g, jnp.int32))
    bundle_i = bundle_i.at[:, :, 3:6].set(
        jax.lax.bitcast_convert_type(v1g - v0g, jnp.int32))
    bundle_i = bundle_i.at[:, :, 6:9].set(
        jax.lax.bitcast_convert_type(v2g - v0g, jnp.int32))
    bundle_i = bundle_i.at[:, :, 9].set(pidg)

    leaf_lo = jnp.min(jnp.where(valid[..., None], lo[src], jnp.inf), axis=1)
    leaf_hi = jnp.max(jnp.where(valid[..., None], hi[src], -jnp.inf), axis=1)

    # --- bottom-up AABB propagation (fixed passes; depth <= 64) ---
    node_lo = jnp.zeros((n_nodes, 3), jnp.float32).at[n_internal:].set(leaf_lo)
    node_hi = jnp.zeros((n_nodes, 3), jnp.float32).at[n_internal:].set(leaf_hi)

    def aabb_pass(state):
        nlo, nhi, _ = state
        new_lo = nlo.at[:n_internal].set(
            jnp.minimum(nlo[left], nlo[right]))
        new_hi = nhi.at[:n_internal].set(
            jnp.maximum(nhi[left], nhi[right]))
        changed = jnp.any(new_lo != nlo) | jnp.any(new_hi != nhi)
        return new_lo, new_hi, changed

    # iterate to the fixed point (union propagation is monotone, so this
    # terminates in tree-depth passes regardless of Morton pathologies)
    node_lo, node_hi, _ = jax.lax.while_loop(
        lambda s: s[2], aabb_pass,
        (node_lo, node_hi, jnp.asarray(True)))

    # --- parent pointers + top-down escape threading ---
    parent = jnp.zeros(n_nodes, jnp.int32)
    parent = parent.at[left].set(jnp.arange(n_internal, dtype=jnp.int32))
    parent = parent.at[right].set(jnp.arange(n_internal, dtype=jnp.int32))
    is_left = jnp.zeros(n_nodes, bool).at[left].set(True)
    sibling = jnp.zeros(n_nodes, jnp.int32)
    sibling = sibling.at[left].set(right)

    esc = jnp.full(n_nodes, jnp.int32(-2))
    esc = esc.at[0].set(-1)
    esc = jnp.where(is_left, sibling, esc).at[0].set(-1)

    def esc_pass(e):
        # right children inherit the parent's escape once it resolves
        pe = e[parent]
        return jnp.where((~is_left) & (jnp.arange(n_nodes) != 0), pe, e)

    esc = jax.lax.while_loop(lambda e: jnp.any(e == -2), esc_pass, esc)

    # --- pack ---
    is_leaf_node = jnp.arange(n_nodes) >= n_internal
    left_full = jnp.zeros(n_nodes, jnp.int32).at[:n_internal].set(left)
    a = jnp.where(is_leaf_node, jnp.arange(n_nodes) - n_internal, left_full)
    counts = jnp.sum(valid, axis=1).astype(jnp.int32)
    count_f = jnp.where(is_leaf_node,
                        counts[jnp.maximum(jnp.arange(n_nodes) - n_internal, 0)],
                        0)
    kind = jnp.where(is_leaf_node, KIND_TRI_LEAF, KIND_INNER)
    meta = (a.astype(jnp.uint32) & META_A_MASK) \
        | (count_f.astype(jnp.uint32) << META_COUNT_SHIFT) \
        | (kind.astype(jnp.uint32) << META_KIND_SHIFT)

    # int32-space packing (see bundle comment above): one bitcast at
    # the END, never an f32 op over rows holding int bit patterns
    packed_i = jnp.zeros((n_nodes, 8), jnp.int32)
    packed_i = packed_i.at[:, 0:3].set(
        jax.lax.bitcast_convert_type(node_lo, jnp.int32))
    packed_i = packed_i.at[:, 3:6].set(
        jax.lax.bitcast_convert_type(node_hi, jnp.int32))
    packed_i = packed_i.at[:, 6].set(
        jax.lax.bitcast_convert_type(meta, jnp.int32))
    packed_i = packed_i.at[:, 7].set(esc.astype(jnp.int32))
    return dict(node_packed_i=packed_i, bundle_packed_i=bundle_i,
                n_internal=n_internal, counts=counts)


def lbvh_scene(vertices: jnp.ndarray, triangles: jnp.ndarray) -> DeviceScene:
    """Build a single-instance DeviceScene fully on device.

    vertices: [V, 3] f32; triangles: [T, 3] i32.
    The TLAS is one instance leaf (identity transform) in front of the
    BLAS; suitable for per-frame rebuilds of dynamic geometry.
    """
    tri = triangles.astype(jnp.int32)
    v0 = vertices[tri[:, 0]]
    v1 = vertices[tri[:, 1]]
    v2 = vertices[tri[:, 2]]
    prim = jnp.arange(tri.shape[0], dtype=jnp.int32)
    blas = build_lbvh(v0, v1, v2, prim)

    bp_i = blas["node_packed_i"]
    nb = bp_i.shape[0]

    # TLAS: single instance-leaf root at node 0; BLAS nodes at offset 1.
    # Rebase BLAS child indices (+1) without disturbing leaf bundle
    # refs -- ALL in int32 space (device f32 ops may corrupt int bit
    # patterns: denormal flush + NaN canonicalization; see build_lbvh)
    meta = jax.lax.bitcast_convert_type(bp_i[:, 6], jnp.uint32)
    a = (meta & META_A_MASK).astype(jnp.int32)
    kind = (meta >> META_KIND_SHIFT).astype(jnp.int32)
    a = jnp.where(kind == KIND_INNER, a + 1, a)
    meta = (a.astype(jnp.uint32) & META_A_MASK) \
        | (meta & ~jnp.uint32(META_A_MASK))
    esc = bp_i[:, 7]
    esc = jnp.where(esc >= 0, esc + 1, esc)
    bp_i = bp_i.at[:, 6].set(
        jax.lax.bitcast_convert_type(meta, jnp.int32))
    bp_i = bp_i.at[:, 7].set(esc)

    tlas_meta = (jnp.uint32(0)
                 | (jnp.uint32(1) << META_COUNT_SHIFT)
                 | (jnp.uint32(KIND_INST_LEAF) << META_KIND_SHIFT))
    tlas_row_i = jnp.concatenate([
        bp_i[0, 0:3], bp_i[0, 3:6],
        jax.lax.bitcast_convert_type(tlas_meta, jnp.int32)[None],
        jnp.full((1,), -1, jnp.int32)])
    node_packed_i = jnp.concatenate([tlas_row_i[None], bp_i], axis=0)
    # the ONE int->f32 bitcast; downstream only gathers/slices this
    node_packed = jax.lax.bitcast_convert_type(node_packed_i,
                                               jnp.float32)
    bundle_packed = jax.lax.bitcast_convert_type(
        blas["bundle_packed_i"], jnp.float32)

    eye = jnp.eye(4, dtype=jnp.float32)[None]
    n_nodes = nb + 1
    zeros3 = jnp.zeros((n_nodes, 3), jnp.float32)
    return DeviceScene(
        node_min=node_packed[:, 0:3],
        node_max=node_packed[:, 3:6],
        node_a=jnp.zeros(n_nodes, jnp.int32),   # unpacked mirrors unused by
        node_b=jnp.zeros(n_nodes, jnp.int32),   # the packed traversal path
        node_kind=jnp.zeros(n_nodes, jnp.int32),
        node_esc=jnp.zeros(n_nodes, jnp.int32),
        bundle_v0=bundle_packed[:, :, 0:3],
        bundle_e1=bundle_packed[:, :, 3:6],
        bundle_e2=bundle_packed[:, :, 6:9],
        bundle_prim=blas["bundle_packed_i"][:, :, 9],
        node_packed=node_packed,
        bundle_packed=bundle_packed,
        inst_transform=eye,
        inst_inv=eye,
        inst_id=jnp.zeros(1, jnp.int32),
        inst_custom=jnp.zeros(1, jnp.int32),
        inst_sbt=jnp.zeros(1, jnp.int32),
        inst_blas_root=jnp.ones(1, jnp.int32),
    )
