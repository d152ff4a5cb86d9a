"""DeviceScene: the SoA acceleration-structure layout traversal consumes.

Redesign of the reference's pointer-chasing byte-blob layout
(reference: radiance/shader/data.cl:92-99 offset macros): instead of one
buffer with byte offsets, the scene is a pytree of flat arrays:

- one global node array (TLAS nodes first, then every BLAS's nodes with
  child indices rebased), split into SoA fields for coalesced gathers,
  threaded with precomputed escape indices for stackless traversal
- triangle leaves normalized to <= LEAF_WIDTH primitives and stored as
  pre-dereferenced 8-wide bundles (v0/e1/e2), so a leaf visit is a single
  contiguous gather + one 8-wide vectorized Moller-Trumbore
- instances as SoA with **precomputed inverse transforms** (the reference
  inverts the 4x4 per ray per instance-visit in-shader, radiance.cl:164-169;
  we hoist the inverse to build time)

Constructors exist for both the host-build path (BottomAccelStruct /
Instance objects) and the serialized-TLAS path (cache files), so
reference-layout caches render directly.  All assembly is vectorized
NumPy -- a 1M-triangle scene assembles in seconds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import functools

import numpy as np

import jax
import jax.numpy as jnp
from radiance_tpu.core import struct

from radiance_tpu import config
from radiance_tpu.core import types

# node_kind values
KIND_INNER = 0
KIND_TRI_LEAF = 1
KIND_INST_LEAF = 2


@struct.dataclass
class DeviceScene:
    """Flat device arrays for two-level traversal.  All jnp arrays."""
    node_min: jnp.ndarray      # [Nn, 3] f32
    node_max: jnp.ndarray      # [Nn, 3] f32
    node_a: jnp.ndarray        # [Nn] i32: inner->left child | tri leaf->bundle idx | inst leaf->first slot
    node_b: jnp.ndarray        # [Nn] i32: inner->right child | leaf->count
    node_kind: jnp.ndarray     # [Nn] i32
    node_esc: jnp.ndarray      # [Nn] i32 escape index for stackless traversal
                               # (-1 = exit this tree); left-first threaded order
                               # visits nodes exactly like the reference's
                               # push-right-pop-left stack walk (radiance.cl:66-67)

    bundle_v0: jnp.ndarray     # [Nb, W, 3] f32
    bundle_e1: jnp.ndarray     # [Nb, W, 3] f32
    bundle_e2: jnp.ndarray     # [Nb, W, 3] f32
    bundle_prim: jnp.ndarray   # [Nb, W] i32 (primID; -1 padding)

    inst_transform: jnp.ndarray  # [Ni, 4, 4] f32 (object -> world)
    inst_inv: jnp.ndarray        # [Ni, 4, 4] f32 (world -> object)
    inst_id: jnp.ndarray         # [Ni] i32 (creation order = gl_InstanceID)
    inst_custom: jnp.ndarray     # [Ni] i32
    inst_sbt: jnp.ndarray        # [Ni] i32
    inst_blas_root: jnp.ndarray  # [Ni] i32 absolute node index

    # --- hot-path packed mirrors (single-gather traversal layouts) ---
    # node_packed[i] = [min.xyz, max.xyz, bitcast(meta), bitcast(esc)] where
    # meta = a | count << 26 | kind << 30 (a < 2^26, count <= 15, kind < 4)
    node_packed: jnp.ndarray     # [Nn, 8] f32
    # bundle_packed[b, j] = [v0.xyz, e1.xyz, e2.xyz, bitcast(prim), 0, 0]
    bundle_packed: jnp.ndarray   # [Nb, W, 12] f32


META_A_MASK = (1 << 26) - 1
META_COUNT_SHIFT = 26
META_KIND_SHIFT = 30


@dataclasses.dataclass
class _Tree:
    """Mutable decoded tree: parallel arrays (python lists for appends)."""
    bot: list
    top: list
    a: list
    b: list
    kind: list


def _decode_nodes(nodes: np.ndarray, leaf_kind: int) -> _Tree:
    """Structured DEVICE_BVH_NODE rows -> parallel arrays (vectorized)."""
    count_word = nodes["a"].astype(np.int64)
    is_leaf = (count_word & config.LEAF_FLAG) != 0
    a = np.where(is_leaf, nodes["b"].astype(np.int64),
                 count_word)                      # leaf: start | inner: left
    b = np.where(is_leaf, count_word & config.COUNT_MASK,
                 nodes["b"].astype(np.int64))     # leaf: count | inner: right
    kind = np.where(is_leaf, leaf_kind, KIND_INNER)
    return _Tree(
        bot=list(np.ascontiguousarray(nodes["bottom"], np.float32)),
        top=list(np.ascontiguousarray(nodes["top"], np.float32)),
        a=a.tolist(), b=b.tolist(), kind=kind.tolist())


def _split_oversized_leaves(t: _Tree, leaf_width: int) -> None:
    """Split leaves with count > leaf_width into balanced inner subtrees.

    The reference's no-SAH-improvement path can emit arbitrarily large
    leaves (bvh.cpp:212-218); the fixed-width bundle kernel needs
    count <= leaf_width.  Only oversized leaves are touched.
    """
    i = 0
    while i < len(t.kind):
        if t.kind[i] != KIND_INNER and t.b[i] > leaf_width:
            start, count, kind = t.a[i], t.b[i], t.kind[i]
            half = count // 2
            li = len(t.kind)
            for s, c in ((start, half), (start + half, count - half)):
                t.bot.append(t.bot[i]); t.top.append(t.top[i])
                t.a.append(s); t.b.append(c); t.kind.append(kind)
            t.a[i], t.b[i], t.kind[i] = li, li + 1, KIND_INNER
        i += 1


def _compute_escape_arrays(a: np.ndarray, b: np.ndarray, kind: np.ndarray,
                           esc: np.ndarray, root: int) -> None:
    """Thread one tree: esc[left] = right sibling, esc[right] = esc[parent]."""
    from radiance_tpu.bvh import native
    if native.compute_escape(a, b, kind, root, esc):
        return
    stack = [(root, -1)]
    while stack:
        i, e = stack.pop()
        esc[i] = e
        if kind[i] == KIND_INNER:
            stack.append((b[i], e))
            stack.append((a[i], b[i]))


def _bundle_triangles(t: _Tree, faces: np.ndarray, verts3: np.ndarray,
                      leaf_width: int, bundle_base: int):
    """Vectorized: tri-leaf (start,count) -> 8-wide pre-dereferenced bundles.

    Rewrites each tri leaf's `a` to its bundle index (bundle_base-relative).
    Returns (v0 [L,W,3], e1, e2, prim [L,W]).
    """
    kind = np.asarray(t.kind)
    leaf_ids = np.nonzero(kind == KIND_TRI_LEAF)[0]
    nl = len(leaf_ids)
    w = leaf_width
    if nl == 0:
        z = np.zeros((0, w, 3), np.float32)
        return z, z.copy(), z.copy(), np.zeros((0, w), np.int32)

    a = np.asarray(t.a)
    b = np.asarray(t.b)
    starts = a[leaf_ids]
    counts = b[leaf_ids]
    lane = np.arange(w)
    slot = starts[:, None] + lane[None, :]            # [L, W]
    valid = lane[None, :] < counts[:, None]
    slot = np.clip(slot, 0, max(len(faces) - 1, 0))

    f = faces[slot]                                    # structured gather
    i0 = f["idx0"].astype(np.int64)
    i1 = f["idx1"].astype(np.int64)
    i2 = f["idx2"].astype(np.int64)
    va = verts3[i0]
    vb = verts3[i1]
    vc = verts3[i2]
    v0 = np.where(valid[..., None], va, 0.0).astype(np.float32)
    e1 = np.where(valid[..., None], vb - va, 0.0).astype(np.float32)
    e2 = np.where(valid[..., None], vc - va, 0.0).astype(np.float32)
    prim = np.where(valid, f["primID"].astype(np.int64), -1).astype(np.int32)

    for j, ni in enumerate(leaf_ids):
        t.a[ni] = bundle_base + j
    return v0, e1, e2, prim


def _prepare_tlas_block(tlas_nodes: np.ndarray, leaf_width: int,
                        capacity: int):
    """Decode + split + thread the TLAS into a fixed-size packed block.

    The TLAS block is self-contained (its nodes never reference BLAS node
    indices; instance leaves reference instance slots), so padding it to a
    fixed capacity lets animated scenes refit per frame by rewriting only
    node_packed[:capacity] + the instance arrays.
    Returns (packed [capacity, 8] f32, n_rows).
    """
    t = _decode_nodes(tlas_nodes, KIND_INST_LEAF)
    _split_oversized_leaves(t, leaf_width)
    n = len(t.kind)
    if n > capacity:
        raise ValueError(f"TLAS block needs {n} rows > capacity {capacity}")
    a = np.asarray(t.a, np.int64)
    b = np.asarray(t.b, np.int64)
    kind = np.asarray(t.kind, np.int32)
    esc = np.full(n, -1, np.int32)
    _compute_escape_arrays(a.astype(np.int32), b.astype(np.int32), kind,
                           esc, 0)
    packed = np.zeros((capacity, 8), np.float32)
    packed[:n, 0:3] = np.asarray(t.bot, np.float32).reshape(-1, 3)
    packed[:n, 3:6] = np.asarray(t.top, np.float32).reshape(-1, 3)
    meta = (a.astype(np.uint32) & META_A_MASK) \
        | (np.where(kind != KIND_INNER, b, 0).astype(np.uint32)
           << META_COUNT_SHIFT) \
        | (kind.astype(np.uint32) << META_KIND_SHIFT)
    packed[:n, 6] = meta.view(np.float32)
    packed[:n, 7] = esc.view(np.float32)
    # padding rows: unreachable inert inner nodes with empty boxes
    if n < capacity:
        packed[n:, 0:3] = np.float32(np.finfo(np.float32).max)
        packed[n:, 3:6] = -np.float32(np.finfo(np.float32).max)
        packed[n:, 7] = np.full(capacity - n, -1, np.int32).view(np.float32)
    return packed, n


def _instance_arrays(device_instances: np.ndarray, blas_root_by_offset: dict):
    ni = len(device_instances)
    tf = np.ascontiguousarray(device_instances["transform"], np.float32)
    if ni:
        inv = np.linalg.inv(tf.astype(np.float64)).astype(np.float32)
        blas_root = np.array(
            [blas_root_by_offset[int(r["bottomAccelStructOffset"])]
             for r in device_instances], np.int32)
    else:
        inv = np.zeros((0, 4, 4), np.float32)
        blas_root = np.zeros(0, np.int32)
    return tf, inv, blas_root


def tlas_capacity_for(n_instances: int) -> int:
    """Worst-case padded TLAS rows: raw nodes (<= 2I-1) + oversized-leaf
    splits (< 2I) + root slack."""
    return 4 * max(n_instances, 1) + 8


@functools.partial(jax.jit, donate_argnums=(0, 1, 2),
                   static_argnames=("capacity",))
def _tlas_block_update(node_packed, node_min, node_max, packed,
                       capacity):
    return (node_packed.at[:capacity].set(packed),
            node_min.at[:capacity].set(packed[:, 0:3]),
            node_max.at[:capacity].set(packed[:, 3:6]))


def update_tlas(scene: DeviceScene,
                tlas_nodes: np.ndarray,
                device_instances: np.ndarray,
                blas_root_by_offset: dict,
                capacity: int,
                leaf_width: int = config.LEAF_WIDTH) -> DeviceScene:
    """Animated-transform refit: rebuild only the TLAS block + instances.

    The BLAS node rows, bundles, and their escape threading are untouched
    (they live at indices >= capacity); per-frame upload is
    capacity * 32 B + the instance arrays.
    """
    packed, _ = _prepare_tlas_block(tlas_nodes, leaf_width, capacity)
    tf, inv, blas_root = _instance_arrays(device_instances,
                                          blas_root_by_offset)
    # one donated dispatch instead of three eager full-array copies:
    # donation lets XLA update the TLAS block in place, so a refit
    # frame pays capacity*32B of upload, not a full copy of the node
    # arrays + 3 dispatch round trips.  The OLD scene's node arrays are
    # invalidated -- refit semantically mutates the device scene in
    # place (docstring).
    np_new, nmin_new, nmax_new = _tlas_block_update(
        scene.node_packed, scene.node_min, scene.node_max,
        jnp.asarray(packed), capacity)
    return scene.replace(
        node_packed=np_new,
        node_min=nmin_new,
        node_max=nmax_new,
        inst_transform=jnp.asarray(tf),
        inst_inv=jnp.asarray(inv),
        inst_id=jnp.asarray(device_instances["instanceID"].astype(np.int32)),
        inst_custom=jnp.asarray(
            device_instances["customInstanceID"].astype(np.int32)),
        inst_sbt=jnp.asarray(device_instances["SBTOffset"].astype(np.int32)),
        inst_blas_root=jnp.asarray(blas_root),
    )


def build_device_scene(tlas_nodes: np.ndarray,
                       device_instances: np.ndarray,
                       blas_by_offset: dict,
                       leaf_width: int = config.LEAF_WIDTH,
                       tlas_capacity: int = 0) -> DeviceScene:
    """Assemble the DeviceScene from parsed/built host arrays.

    tlas_nodes: DEVICE_BVH_NODE_DTYPE array
    device_instances: DEVICE_INSTANCE_DTYPE array (leaf order)
    blas_by_offset: {byteOffset: (nodes, faces, verts[V,>=3])}
    tlas_capacity: pad the TLAS block to this many rows (enables
      update_tlas refits); 0 = exact size.
    """
    tlas = _decode_nodes(tlas_nodes, KIND_INST_LEAF)
    _split_oversized_leaves(tlas, leaf_width)
    if tlas_capacity:
        if len(tlas.kind) > tlas_capacity:
            raise ValueError("tlas_capacity too small")
        while len(tlas.kind) < tlas_capacity:
            big = np.float32(np.finfo(np.float32).max)
            tlas.bot.append(np.full(3, big, np.float32))
            tlas.top.append(np.full(3, -big, np.float32))
            tlas.a.append(0)
            tlas.b.append(0)
            tlas.kind.append(KIND_INNER)

    all_v0, all_e1, all_e2, all_prim = [], [], [], []
    trees = [tlas]
    blas_root_by_offset = {}
    node_base = len(tlas.kind)
    bundle_base = 0
    for off in sorted(blas_by_offset.keys()):
        nodes, faces, verts = blas_by_offset[off]
        verts3 = np.ascontiguousarray(np.asarray(verts, np.float32)[:, :3])
        t = _decode_nodes(nodes, KIND_TRI_LEAF)
        _split_oversized_leaves(t, leaf_width)
        v0, e1, e2, prim = _bundle_triangles(t, faces, verts3, leaf_width,
                                             bundle_base)
        bundle_base += len(v0)
        # rebase inner children to global node indices
        kind_arr = np.asarray(t.kind)
        a_arr = np.asarray(t.a)
        b_arr = np.asarray(t.b)
        inner = kind_arr == KIND_INNER
        a_arr = np.where(inner, a_arr + node_base, a_arr)
        b_arr = np.where(inner, b_arr + node_base, b_arr)
        t.a = a_arr.tolist()
        t.b = b_arr.tolist()
        all_v0.append(v0); all_e1.append(e1); all_e2.append(e2)
        all_prim.append(prim)
        trees.append(t)
        blas_root_by_offset[off] = node_base
        node_base += len(t.kind)

    node_min = np.concatenate([np.asarray(t.bot, np.float32).reshape(-1, 3)
                               for t in trees])
    node_max = np.concatenate([np.asarray(t.top, np.float32).reshape(-1, 3)
                               for t in trees])
    node_a = np.concatenate([np.asarray(t.a, np.int64) for t in trees]).astype(np.int32)
    node_b = np.concatenate([np.asarray(t.b, np.int64) for t in trees]).astype(np.int32)
    node_kind = np.concatenate([np.asarray(t.kind, np.int32) for t in trees])

    node_esc = np.full(len(node_kind), -1, np.int32)
    _compute_escape_arrays(node_a, node_b, node_kind, node_esc, 0)
    for off in sorted(blas_by_offset.keys()):
        _compute_escape_arrays(node_a, node_b, node_kind, node_esc,
                               blas_root_by_offset[off])

    # --- instances ---
    ni = len(device_instances)
    tf = np.ascontiguousarray(device_instances["transform"], np.float32)
    if ni:
        inv = np.linalg.inv(tf.astype(np.float64)).astype(np.float32)
        blas_root = np.array(
            [blas_root_by_offset[int(r["bottomAccelStructOffset"])]
             for r in device_instances], np.int32)
    else:
        inv = np.zeros((0, 4, 4), np.float32)
        blas_root = np.zeros(0, np.int32)

    w = leaf_width

    def cat_or_empty(lst, shape, dtype=np.float32, fill=0):
        out = ([x for x in lst if len(x)] or
               [np.full((1,) + shape, fill, dtype)])
        return np.concatenate(out).astype(dtype)

    v0_np = cat_or_empty(all_v0, (w, 3))
    e1_np = cat_or_empty(all_e1, (w, 3))
    e2_np = cat_or_empty(all_e2, (w, 3))
    prim_np = cat_or_empty(all_prim, (w,), np.int32, -1)

    # hot-path packs (see DeviceScene docstring)
    assert int(node_a.max(initial=0)) < (1 << 26), "node/bundle index overflow"
    meta = (node_a.astype(np.uint32) & META_A_MASK) \
        | (np.where(node_kind != KIND_INNER, node_b, 0).astype(np.uint32)
           << META_COUNT_SHIFT) \
        | (node_kind.astype(np.uint32) << META_KIND_SHIFT)
    node_packed = np.zeros((len(node_kind), 8), np.float32)
    node_packed[:, 0:3] = node_min
    node_packed[:, 3:6] = node_max
    node_packed[:, 6] = meta.view(np.float32)
    node_packed[:, 7] = node_esc.astype(np.int32).view(np.float32)

    bundle_packed = np.zeros((len(prim_np), w, 12), np.float32)
    bundle_packed[:, :, 0:3] = v0_np
    bundle_packed[:, :, 3:6] = e1_np
    bundle_packed[:, :, 6:9] = e2_np
    bundle_packed[:, :, 9] = prim_np.astype(np.int32).view(np.float32)

    return DeviceScene(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        node_a=jnp.asarray(node_a),
        node_b=jnp.asarray(node_b),
        node_kind=jnp.asarray(node_kind),
        node_esc=jnp.asarray(node_esc),
        bundle_v0=jnp.asarray(v0_np),
        bundle_e1=jnp.asarray(e1_np),
        bundle_e2=jnp.asarray(e2_np),
        bundle_prim=jnp.asarray(prim_np),
        node_packed=jnp.asarray(node_packed),
        bundle_packed=jnp.asarray(bundle_packed),
        inst_transform=jnp.asarray(tf),
        inst_inv=jnp.asarray(inv),
        inst_id=jnp.asarray(device_instances["instanceID"].astype(np.int32)),
        inst_custom=jnp.asarray(device_instances["customInstanceID"].astype(np.int32)),
        inst_sbt=jnp.asarray(device_instances["SBTOffset"].astype(np.int32)),
        inst_blas_root=jnp.asarray(blas_root),
    )


def device_scene_from_instances(instances: Sequence[types.Instance]) -> DeviceScene:
    """Host-build path: RD-style instances -> DeviceScene (no blob round trip)."""
    from radiance_tpu.bvh import builder

    tlas_nodes, dev_inst, blas_offsets, _ = builder.build_tlas_arrays(list(instances))
    blas_by_offset = {
        off: (b.nodes, b.faces, b.vertices) for off, b in blas_offsets
    }
    return build_device_scene(tlas_nodes, dev_inst, blas_by_offset)


def device_scene_from_tlas_blob(blob: bytes) -> DeviceScene:
    """Cache-load path: serialized TLAS blob -> DeviceScene."""
    from radiance_tpu.bvh import serialize

    parsed = serialize.parse_tlas(blob)
    return build_device_scene(parsed.nodes, parsed.instances, parsed.blas)
