"""Two-level BVH traversal, vectorized over ray wavefronts.

Wavefront redesign of the reference's per-ray stack walk
(reference: radiance/shader/radiance.cl:41-192) as plain JAX that XLA
compiles for any backend.  Three structural choices drive the design,
all aimed at keeping per-ray state small and memory access coalesced:

1. **Threaded (stackless) BVH.** Every node carries a precomputed escape
   index, so a ray's traversal state is three int32 registers (current
   TLAS node, instance-leaf cursor, current BLAS node) instead of a
   [N, depth] stack that would cost a scatter per push.  The left-first
   threaded order visits nodes exactly like the reference's
   push-right/pop-left stack (radiance.cl:66-67, 136-137), so any-hit
   early-termination semantics match.

2. **Single-gather node visits + parked leaf phase.** Node data is packed
   into one 32-byte row (DeviceScene.node_packed) so a traversal step is
   one gather + a slab test.  Rays that reach a triangle leaf *park* and
   stop stepping; when every live ray is parked (or done), one vectorized
   phase intersects each ray's 8-wide pre-dereferenced triangle bundle
   (one 384-byte gather + batched Moller-Trumbore).  Inner-node stepping
   never touches triangle data, leaf intersection is never masked out.

3. **Bounded chunks.** Wavefronts larger than `chunk_size` are processed
   through `lax.map`, bounding per-dispatch memory and letting early
   chunks retire without waiting on the whole image's slowest ray.

Instance handling: the TLAS is walked with the world ray; entering an
instance leaf gathers the *precomputed* inverse transform (the reference
inverts the 4x4 per visit in-shader, radiance.cl:164-169) and rewrites the
object-space ray registers.  The traversal parameter t is invariant under
the affine instance map, so world/object t compare directly.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from radiance_tpu.core import struct

from radiance_tpu import config
from radiance_tpu.bvh.device import (
    DeviceScene, KIND_INNER, KIND_TRI_LEAF, META_A_MASK, META_COUNT_SHIFT,
    META_KIND_SHIFT)
from radiance_tpu.core import math as rmath
from radiance_tpu.ops.intersect import FLT_MAX, intersect_aabb, intersect_triangle


@struct.dataclass
class HitRecord:
    """Closest-hit result (reference: radiance.cl HitData, :8-18).

    t:    hit distance (FLT_MAX on miss); identical in world and object
          space because the instance transform is affine in the ray param.
    prim: primitiveIndex = primID of the hit triangle within its mesh
    slot: index into the DeviceScene instance arrays (NOT gl_InstanceID --
          fetch scene.inst_id[slot] for that); -1 on miss
    b1, b2: barycentrics of v1/v2 (w0 = 1 - b1 - b2, radiance.cl:244-246)
    """
    t: jnp.ndarray
    prim: jnp.ndarray
    slot: jnp.ndarray
    b1: jnp.ndarray
    b2: jnp.ndarray

    @property
    def hit(self):
        return self.t < FLT_MAX


@struct.dataclass
class AnyHitCandidates:
    """Batch of candidate hits handed to a custom any-hit program.

    The reference calls the user's callAnyHit once per candidate triangle
    inside BLAS traversal, letting it accept/reject the hit and stop the
    walk via the `cont` flag (reference: radiance.cl:90-102, dispatch
    shader.cl:574-583).  The wavefront equivalent batches one leaf
    bundle's candidates: arrays are [N, W] (W = leaf bundle width), with
    `valid` marking real in-window candidates.  A program returns
    (accept [N, W] bool, terminate [N, W] bool):
      accept=False  -> ignore the candidate (alpha-test semantics;
                       traversal continues as if it never hit)
      terminate     -> accepted candidates with terminate=True stop the
                       ray's traversal after this leaf (the reference's
                       anyShadow cont=false)
    """
    t: jnp.ndarray            # [N, W] candidate hit distance
    prim: jnp.ndarray         # [N, W] primitiveIndex
    b1: jnp.ndarray           # [N, W]
    b2: jnp.ndarray           # [N, W]
    valid: jnp.ndarray        # [N, W] bool -- in-window candidate mask
    slot: jnp.ndarray         # [N] instance slot (scene.inst_* index)
    sbt_offset: jnp.ndarray   # [N] instanceSBTOffset of that slot
    ray_origin: jnp.ndarray   # [N, 3] world-space ray
    ray_dir: jnp.ndarray      # [N, 3]


def _unpack_node(scene: DeviceScene, idx):
    """One packed gather -> (bmin, bmax, a, count, kind, esc)."""
    row = scene.node_packed[idx]                      # [N, 8] f32
    bmin = row[:, 0:3]
    bmax = row[:, 3:6]
    meta = jax.lax.bitcast_convert_type(row[:, 6], jnp.uint32)
    esc = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
    a = (meta & META_A_MASK).astype(jnp.int32)
    count = ((meta >> META_COUNT_SHIFT) & 0xF).astype(jnp.int32)
    kind = (meta >> META_KIND_SHIFT).astype(jnp.int32)
    return bmin, bmax, a, count, kind, esc


def _trace_chunk(scene: DeviceScene, origin, direction, tmin, tmax,
                 any_hit_terminate: bool, any_hit_program=None):
    n = origin.shape[0]
    f32, i32 = jnp.float32, jnp.int32
    w = scene.bundle_prim.shape[1]
    lanes = jnp.arange(w, dtype=i32)
    rows = jnp.arange(n)

    world_o = origin.astype(f32)
    world_d = direction.astype(f32)
    world_inv = 1.0 / world_d
    tmin = f32(tmin)
    tmax = f32(tmax)

    state = dict(
        tidx=jnp.zeros(n, i32),
        inst_j=jnp.full(n, -1, i32),
        bidx=jnp.full(n, -1, i32),
        parked_a=jnp.full(n, -1, i32),     # bundle index; -1 = not parked
        parked_count=jnp.zeros(n, i32),
        pending=jnp.zeros(n, i32),
        cur_o=world_o,
        cur_d=world_d,
        cur_inv=world_inv,
        t=jnp.full(n, FLT_MAX, f32),
        prim=jnp.full(n, -1, i32),
        slot=jnp.full(n, -1, i32),
        b1=jnp.zeros(n, f32),
        b2=jnp.zeros(n, f32),
        done=jnp.zeros(n, bool),
    )

    def walking(s):
        """Rays still stepping between leaf visits."""
        return ((~s["done"]) & (s["parked_a"] < 0)
                & ((s["bidx"] >= 0) | (s["inst_j"] >= 0) | (s["tidx"] >= 0)))

    def alive(s):
        return walking(s) | ((~s["done"]) & (s["parked_a"] >= 0))

    UNROLL = 4  # node steps per loop iteration (amortizes loop overhead)

    # ---------------- phase A: node stepping ----------------
    def step(s):
        act = (~s["done"]) & (s["parked_a"] < 0)
        in_blas = act & (s["bidx"] >= 0)
        in_leaf = act & (~in_blas) & (s["inst_j"] >= 0)
        in_tlas = act & (~in_blas) & (~in_leaf) & (s["tidx"] >= 0)

        clip = jnp.minimum(s["t"], tmax)

        # --- BLAS node visit (single packed gather) ---
        nb = jnp.where(in_blas, s["bidx"], 0)
        b_min, b_max, b_a, b_count, b_kind, b_esc = _unpack_node(scene, nb)
        b_inner = b_kind == KIND_INNER
        box_hit = intersect_aabb(s["cur_o"], s["cur_inv"], b_min, b_max,
                                 t_clip=clip)
        # tri leaf -> park (bundle index + count), pre-advance to escape
        is_tri = in_blas & (~b_inner)
        parked_a = jnp.where(is_tri, b_a, s["parked_a"])
        parked_count = jnp.where(is_tri, b_count, s["parked_count"])
        bidx = jnp.where(in_blas,
                         jnp.where(b_inner & box_hit, b_a, b_esc),
                         s["bidx"])

        # --- TLAS node fetch (shared by instance-leaf + tlas steps) ---
        tn = jnp.where(in_leaf | in_tlas, s["tidx"], 0)
        t_min_n, t_max_n, t_a, t_count, t_kind, t_esc = _unpack_node(scene, tn)

        # --- instance-leaf advance ---
        entering = in_leaf & (s["inst_j"] < t_count)
        exiting = in_leaf & (~entering)
        slot_idx = jnp.where(entering, t_a + s["inst_j"], 0)
        inv = scene.inst_inv[slot_idx]
        o_l = rmath.mat4_transform_point(inv, world_o)
        d_l = rmath.mat4_transform_dir(inv, world_d)
        em = entering[:, None]
        cur_o = jnp.where(em, o_l, s["cur_o"])
        cur_d = jnp.where(em, d_l, s["cur_d"])
        cur_inv = jnp.where(em, 1.0 / d_l, s["cur_inv"])
        pending = jnp.where(entering, slot_idx, s["pending"])
        bidx = jnp.where(entering, scene.inst_blas_root[slot_idx], bidx)
        inst_j = jnp.where(entering, s["inst_j"] + 1,
                           jnp.where(exiting, -1, s["inst_j"]))
        tidx = jnp.where(exiting, t_esc, s["tidx"])

        # --- TLAS step (world-ray AABB) ---
        t_inner = t_kind == KIND_INNER
        t_box = intersect_aabb(world_o, world_inv, t_min_n, t_max_n,
                               t_clip=clip)
        tidx = jnp.where(in_tlas & t_inner,
                         jnp.where(t_box, t_a, t_esc), tidx)
        inst_j = jnp.where(in_tlas & (~t_inner), 0, inst_j)

        return dict(s, tidx=tidx, inst_j=inst_j, bidx=bidx,
                    parked_a=parked_a, parked_count=parked_count,
                    pending=pending, cur_o=cur_o, cur_d=cur_d,
                    cur_inv=cur_inv)

    # ---------------- phase B: bundled leaf intersection ----------------
    def leaf_phase(s):
        parked = (~s["done"]) & (s["parked_a"] >= 0)
        bundle = jnp.where(parked, s["parked_a"], 0)
        rowdata = scene.bundle_packed[bundle]          # [N, W, 12]
        v0 = rowdata[:, :, 0:3]
        e1 = rowdata[:, :, 3:6]
        e2 = rowdata[:, :, 6:9]
        pid = jax.lax.bitcast_convert_type(rowdata[:, :, 9], jnp.int32)

        valid, tt, tb1, tb2 = intersect_triangle(
            s["cur_o"][:, None, :], s["cur_d"][:, None, :], v0, e1, e2)
        ok = (valid
              & (lanes[None, :] < s["parked_count"][:, None])
              & (tt > tmin) & (tt < tmax)
              & (tt < s["t"][:, None])
              & parked[:, None])
        if any_hit_program is not None:
            # custom any-hit: accept/ignore each candidate, optionally
            # terminate the ray (reference: radiance.cl:90-102)
            slot_idx = jnp.clip(s["pending"], 0, scene.inst_sbt.shape[0] - 1)
            cand = AnyHitCandidates(
                t=tt, prim=pid, b1=tb1, b2=tb2, valid=ok,
                slot=s["pending"],
                sbt_offset=scene.inst_sbt[slot_idx],
                ray_origin=world_o, ray_dir=world_d)
            accept, term = any_hit_program(cand)
            ok = ok & accept
            term_ray = jnp.any(ok & term, axis=1)
        else:
            term_ray = jnp.zeros(n, bool)
        tm = jnp.where(ok, tt, FLT_MAX)
        j = jnp.argmin(tm, axis=1)
        tj = tm[rows, j]
        improved = tj < s["t"]

        return dict(
            s,
            t=jnp.where(improved, tj, s["t"]),
            prim=jnp.where(improved, pid[rows, j], s["prim"]),
            slot=jnp.where(improved, s["pending"], s["slot"]),
            b1=jnp.where(improved, tb1[rows, j], s["b1"]),
            b2=jnp.where(improved, tb2[rows, j], s["b2"]),
            done=s["done"] | (improved & any_hit_terminate) | term_ray,
            parked_a=jnp.full(n, -1, i32),
        )

    def body(s):
        for _ in range(UNROLL):
            s = step(s)
        # flush parked rays through the (expensive) bundle phase only when
        # they pile up or nothing else can make progress -- lax.cond skips
        # the 384B/ray gather entirely on pure-traversal iterations
        n_walk = jnp.sum(walking(s))
        n_park = jnp.sum((~s["done"]) & (s["parked_a"] >= 0))
        flush = (n_walk == 0) | (n_park >= jnp.maximum(n_walk, 1))
        return jax.lax.cond(flush, leaf_phase, lambda x: x, s)

    out = jax.lax.while_loop(
        lambda ss: jnp.any(alive(ss)), body, state)
    return HitRecord(t=out["t"], prim=out["prim"], slot=out["slot"],
                     b1=out["b1"], b2=out["b2"])


def trace_rays(scene: DeviceScene,
               origin: jnp.ndarray,
               direction: jnp.ndarray,
               tmin,
               tmax,
               any_hit_terminate: bool = False,
               chunk_size: Optional[int] = None,
               any_hit_program=None) -> HitRecord:
    """Trace a wavefront of N rays against the two-level scene.

    origin/direction: [N, 3] float32 (direction need not be normalized; the
    reference's traceRay also accepts unnormalized directions).
    tmin/tmax: scalar accept window -- a hit is recorded iff
    tmin < t < tmax and t improves the current best (radiance.cl:90-91).
    any_hit_terminate: occlusion-query mode -- stop a ray at its first
    accepted hit (the reference's anyShadow cont=false, shader.cl:567-572).
    chunk_size: process rays in bounded chunks via lax.map (default: one
    chunk if N <= DEFAULT_RAY_CHUNK, else DEFAULT_RAY_CHUNK).
    any_hit_program: optional custom any-hit shader
    (AnyHitCandidates) -> (accept [N, W] bool, terminate [N, W] bool),
    evaluated per leaf visit (the reference's callAnyHit contract,
    radiance.cl:90-102); see AnyHitCandidates for semantics.  Unlike the
    reference (which evaluates candidates one at a time), termination
    granularity is one leaf bundle -- within a bundle every candidate is
    still offered.
    """
    n = origin.shape[0]
    chunk = chunk_size or config.DEFAULT_RAY_CHUNK
    if n <= chunk:
        return _trace_chunk(scene, origin, direction, tmin, tmax,
                            any_hit_terminate, any_hit_program)

    pad = (-n) % chunk
    if pad:
        # padded rays point nowhere cheap: reuse ray 0's data
        origin = jnp.concatenate([origin, origin[:pad]], axis=0)
        direction = jnp.concatenate([direction, direction[:pad]], axis=0)
    nc = (n + pad) // chunk

    def body(args):
        o, d = args
        return _trace_chunk(scene, o, d, tmin, tmax, any_hit_terminate,
                            any_hit_program)

    rec = jax.lax.map(body, (origin.reshape(nc, chunk, 3),
                             direction.reshape(nc, chunk, 3)))
    flat = jax.tree_util.tree_map(lambda x: x.reshape(-1, *x.shape[2:])[:n], rec)
    return flat
