"""Wavefront path-tracing engine: the TraceRays dispatch.

Replaces the reference's per-pixel megakernel (reference:
samples/shader.cl:175-305 raygen, radiance.cpp:242-267 TraceRays dispatch)
with a fully-jitted wavefront frame function:

  for each sample in batch (lax.fori_loop):
    generate rays for every pixel (PCG3D-jittered)
    for each bounce (lax.while_loop, exits when every path has died):
      trace the live rays through the stackless XLA walk
        (ops/traversal.py), dead lanes compacted out of the way
      SBT-dispatched shading (shaders may trace occlusion rays inline;
        empty dispatches skipped via lax.cond)
      accumulate color / update throughput exactly like shader.cl:233-260
    running-average into the accumulation image (shader.cl:262-281)
  tonemap + quantize (shader.cl:283-305)

Everything stays on device across frames: the accumulation buffer and the
sample counter live in device memory; the host only pulls the u8 image.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import jax
import jax.numpy as jnp

from radiance_tpu.api.sbt import ShaderBindingTable
from radiance_tpu.bvh.device import DeviceScene
from radiance_tpu.core import math as rmath
from radiance_tpu.engine.context import Payload, ShadeContext
from radiance_tpu.ops import compaction
from radiance_tpu.ops import tonemap as tonemap_ops
from radiance_tpu.ops import traversal
from radiance_tpu.ops.intersect import FLT_MAX

# Parking spot for lanes that must not trace: a ray starting here misses
# the scene root AABB on its first step, so the traversal while_loop
# retires it immediately.  XLA shapes are static, so a dead lane is not
# removed -- it is made to converge at once so it never extends a
# chunk's while_loop tail.
_PARK_ORIGIN = 1e30

def _masked_record(rec, alive):
    miss = ~alive
    return traversal.HitRecord(
        t=jnp.where(miss, FLT_MAX, rec.t),
        prim=jnp.where(miss, -1, rec.prim),
        slot=jnp.where(miss, -1, rec.slot),
        b1=jnp.where(miss, 0.0, rec.b1),
        b2=jnp.where(miss, 0.0, rec.b2))


def _traced_wavefront(scene, o, d, tmin, tmax, alive, **trace_kw):
    """Trace only the live rays of a wave (SURVEY 7: generate ->
    traverse -> shade -> compact) and report dead lanes as misses.

    Live rays are permuted to the front (grouped by
    compaction.coherence_key), dead lanes are parked behind them at
    _PARK_ORIGIN, and the HitRecord is scattered back to pixel order.
    Under chunked traversal (ops/traversal lax.map) trailing all-dead
    chunks retire in one iteration.  Sorting beats parking dead lanes in
    place on the H100 (PERF.md): parked lanes spread over every chunk,
    so every chunk's walk runs to its slowest live ray.
    """
    key = jnp.where(alive, compaction.coherence_key(o, d),
                    jnp.int32(2 ** 31 - 1))
    perm = jnp.argsort(key, stable=True).astype(jnp.int32)
    parked = ~alive[perm]
    o_c = jnp.where(parked[:, None], _PARK_ORIGIN, o[perm])
    d_c = jnp.where(parked[:, None], 1.0, d[perm])
    rec = traversal.trace_rays(scene, o_c, d_c, tmin, tmax, **trace_kw)
    rec = compaction.apply_perm(rec, compaction.invert_perm(perm))
    # parked lanes report a miss by construction; force the fields anyway
    return _masked_record(rec, alive)


def _sample_step(tracer, scene, resources, pixel_index, frame_id, b,
                 state, *, debug, hit_offset, miss_index,
                 primary=False):
    """One engine wave: closest-hit trace, SBT shading (shaders may
    trace occlusion rays inline), color/throughput/alive update --
    shader.cl:233-260's per-bounce body in wavefront form.  Shared by
    the frame function (frame_fn) and the per-wave sharded frame
    (parallel/sharding.staged_shard_frame).

    The primary wave has no dead lanes and arrives in coherent pixel
    order, so it traces as it is; bounce waves and the shadow rays
    their shaders trace are compacted (_traced_wavefront)."""
    sbt = tracer.sbt
    color, contribution, alive, o, d = state
    n = pixel_index.shape[0]

    def trace_occlusion(scene_, origin, direction, tmin, tmax,
                        resources=None, active=None):
        # custom any-hit programs (alpha test etc.) registered at the
        # shadow offset ride into the traversal; the canonical
        # terminate-on-first anyShadow compiles to the cheap flag
        prog = sbt.make_any_hit_program(tracer.shadow_hit_offset,
                                        resources)
        kw = dict(any_hit_terminate=(prog is None),
                  any_hit_program=prog)
        if active is None:
            rec = traversal.trace_rays(scene_, origin, direction,
                                       tmin, tmax, **kw)
        else:
            rec = _traced_wavefront(
                scene_, origin, direction, tmin, tmax, active,
                **kw)
        return rec.hit

    occl = functools.partial(trace_occlusion, scene,
                             resources=resources)
    # user shaders' closest-hit handle (sample2-style recursive traces)
    full = functools.partial(traversal.trace_rays, scene)
    hit_anyhit = sbt.make_any_hit_program(hit_offset, resources)

    if primary:
        hits = traversal.trace_rays(scene, o, d, tracer.tmin, tracer.tmax,
                                    any_hit_program=hit_anyhit)
    else:
        hits = _traced_wavefront(scene, o, d, tracer.tmin, tracer.tmax,
                                 alive, any_hit_program=hit_anyhit)
    ctx = _make_context(scene, hits, o, d, pixel_index, frame_id, b,
                        resources, debug, occl, full)
    payload = Payload(
        color=jnp.zeros((n, 3), jnp.float32),
        hit=jnp.zeros(n, bool),
        next_factor=jnp.ones((n, 3), jnp.float32),
        next_origin=o,
        next_dir=d,
    )
    payload = sbt.call_hit(hit_offset, ctx, payload,
                           alive & hits.hit)
    payload = sbt.call_miss(miss_index, ctx, payload,
                            alive & (~hits.hit))

    hit = payload.hit
    # accumulation logic of shader.cl:238-252
    add = alive & hit
    color = color + jnp.where(add[:, None],
                              contribution * payload.color, 0.0)
    # first-bounce miss paints the background
    bg = alive & (~hit) & (b == 0)
    color = jnp.where(bg[:, None], payload.color, color)
    contribution = jnp.where(add[:, None],
                             contribution * payload.next_factor,
                             contribution)
    alive = alive & hit
    return (color, contribution, alive,
            payload.next_origin, payload.next_dir)


def _sample_init(tracer, resources, pixel_index, frame_id,
                 total_samples0):
    """Fresh per-sample path state: PCG-seeded raygen + unit
    throughput (the reference's per-sample loop head,
    shader.cl:197-231)."""
    n = pixel_index.shape[0]
    rand_input = jnp.stack([
        jnp.broadcast_to(frame_id, (n,)).astype(jnp.uint32),
        jnp.broadcast_to(total_samples0, (n,)).astype(jnp.uint32),
        pixel_index.astype(jnp.uint32),
    ], axis=-1)
    origin, direction = tracer.ray_generator(resources, pixel_index,
                                             rand_input)
    return (jnp.zeros((n, 3), jnp.float32),
            jnp.ones((n, 3), jnp.float32),
            jnp.ones(n, bool), origin, direction)


def _finish_frame(tracer, batch, debug, accum, colors, total_samples):
    """Running-average + tonemap + quantize (shader.cl:262-305); the
    epilogue of every frame function."""
    f = total_samples.astype(jnp.float32)
    accum = (f * accum + colors) / (f + jnp.float32(batch))
    rgb = accum
    if not debug:
        rgb = tracer.tonemap(rgb)
    image = tonemap_ops.quantize_rgba8(rgb)
    return accum, image


def _make_context(scene: DeviceScene, hits: traversal.HitRecord,
                  origin, direction, pixel_index, frame_id, depth,
                  resources, debug, trace_occlusion, trace_full):
    n_inst = scene.inst_id.shape[0]
    slot = jnp.clip(hits.slot, 0, n_inst - 1)
    w0 = 1.0 - hits.b1 - hits.b2
    bary = jnp.stack([w0, hits.b1, hits.b2], axis=-1)
    # object-space hit point = inv(M) . o + t * inv(M) . d (the traversal
    # param is invariant under the affine instance map)
    if n_inst == 1:
        # static single-instance scene: skip the per-ray [N, 4, 4]
        # matrix gathers (wave-scale gathers are ~100 MB of traffic
        # per bounce for nothing -- every row is instance 0)
        inv = scene.inst_inv[0]
        transform = jnp.broadcast_to(scene.inst_transform[0],
                                     origin.shape[:1] + (4, 4))
        instance_id = jnp.broadcast_to(scene.inst_id[0], slot.shape)
        custom_id = jnp.broadcast_to(scene.inst_custom[0], slot.shape)
        sbt_offset = jnp.broadcast_to(scene.inst_sbt[0], slot.shape)
    else:
        inv = scene.inst_inv[slot]
        transform = scene.inst_transform[slot]
        instance_id = scene.inst_id[slot]
        custom_id = scene.inst_custom[slot]
        sbt_offset = scene.inst_sbt[slot]
    o_l = rmath.mat4_transform_point(inv, origin)
    d_l = rmath.mat4_transform_dir(inv, direction)
    hit_point = o_l + hits.t[:, None] * d_l
    return ShadeContext(
        hit=hits.hit,
        t=hits.t,
        prim=hits.prim,
        instance_id=instance_id,
        custom_id=custom_id,
        sbt_offset=sbt_offset,
        bary=bary,
        hit_point=hit_point,
        transform=transform,
        ray_origin=origin,
        ray_dir=direction,
        pixel_index=pixel_index,
        frame_id=frame_id,
        depth=depth,
        resources=resources,
        debug=debug,
        trace_occlusion=trace_occlusion,
        trace_rays=trace_full,
    )


@dataclasses.dataclass
class WavefrontPathTracer:
    """A configured raygen program (the analog of a compiled pipeline).

    ray_generator: (resources, pixel_index [N], rand_input [N,3] u32)
                   -> (origin [N,3], dir [N,3])
    sbt: ShaderBindingTable with registered shader callables
    hit_offset/miss_index/shadow_*: the traceRay group indices the raygen
      uses (the reference hardcodes 1/3 for primary and 2/4 for shadow in
      shader.cl:235 and :500; samples configure them here)
    tonemap: float rgb -> float rgb display transform
    tmin/tmax: traceRay accept window (shader.cl:236)
    """
    ray_generator: Callable
    sbt: ShaderBindingTable
    tonemap: Callable = tonemap_ops.tonemap_sample1
    hit_offset: int = 1
    miss_index: int = 3
    shadow_hit_offset: int = 2  # shadow-ray SBT offset (shader.cl:500)
    tmin: float = 0.001
    tmax: float = 1000.0

    def frame_fn(self, *, batch: int, depth: int, debug: int = 0,
                 hit_group_offset: int = 0, miss_group_offset: int = 0):
        """Build the jittable frame function for static (batch, depth, debug).

        Returns fn(scene, resources, accum [N,3] f32, total_samples u32,
                   pixel_index [N] i32) -> (accum', image_u8 [N,4])
        matching the reference's per-frame semantics: frameID starts at
        totalSamples and advances per sample (shader.cl:197-281).
        hit_group_offset/miss_group_offset: TraceRays group indices,
        added to the configured SBT hit offset / miss index.
        """
        effective_depth = 1 if debug else depth
        hit_offset = self.hit_offset + hit_group_offset
        miss_index = self.miss_index + miss_group_offset

        def one_sample(scene, resources, pixel_index, frame_id,
                       total_samples0):
            def bounce(b, st, primary=False):
                return _sample_step(self, scene, resources,
                                    pixel_index, frame_id, b, st,
                                    debug=debug, hit_offset=hit_offset,
                                    miss_index=miss_index, primary=primary)

            init = _sample_init(self, resources, pixel_index, frame_id,
                                total_samples0)
            if effective_depth < 1:
                return init[0]
            # the primary wave is unrolled out of the loop: it traces
            # uncompacted (see _sample_step)
            st1 = bounce(jnp.int32(0), init, primary=True)

            # bounce loop with early exit: when every path has died, the
            # remaining bounces are skipped entirely (the reference's
            # per-ray `if !hit break`, shader.cl:243-252, in bulk)
            def bounce_cond(bs):
                b, st = bs
                return (b < effective_depth) & jnp.any(st[2])

            def bounce_body(bs):
                b, st = bs
                return b + 1, bounce(b, st)

            _, (color, *_rest) = jax.lax.while_loop(
                bounce_cond, bounce_body, (jnp.int32(1), st1))
            return color

        def sample_sum(scene, resources, pixel_index, first_frame_id,
                       total_samples0):
            """Sum of sample colors for frame ids [first, first + batch)."""
            n = pixel_index.shape[0]

            def sample_body(s, acc):
                frame_id = first_frame_id + jnp.uint32(s)
                return acc + one_sample(scene, resources, pixel_index,
                                        frame_id, total_samples0)
            return jax.lax.fori_loop(
                0, batch, sample_body, jnp.zeros((n, 3), jnp.float32))

        def frame(scene, resources, accum, total_samples, pixel_index):
            colors = sample_sum(scene, resources, pixel_index,
                                total_samples, total_samples)
            # running average over sample ids (shader.cl:262-279): with
            # frameID starting at totalSamples, the batched form of the
            # reference's per-sample (f*scratch + c) / (f+1) update is
            # (totalSamples*scratch + sum(c)) / (totalSamples + batch);
            # totalSamples == 0 resets the scratch.
            return _finish_frame(self, batch, debug, accum, colors,
                                 total_samples)

        frame.sample_sum = sample_sum
        return frame

    @functools.lru_cache(maxsize=None)
    def _jitted(self, batch: int, depth: int, debug: int,
                hit_group_offset: int = 0, miss_group_offset: int = 0):
        return jax.jit(self.frame_fn(
            batch=batch, depth=depth, debug=debug,
            hit_group_offset=hit_group_offset,
            miss_group_offset=miss_group_offset))

    # Max samples executed per device dispatch: keeps single device
    # programs bounded (very long dispatches can trip runtime watchdogs),
    # with no semantic difference -- the running average composes exactly.
    max_batch_per_dispatch: int = 8

    def render(self, scene: DeviceScene, resources: Dict, accum,
               total_samples: int, width: int, height: int,
               *, batch: int, depth: int, debug: int = 0,
               hit_group_offset: int = 0, miss_group_offset: int = 0):
        """Run one frame: returns (accum', image u8 [H, W, 4]).

        The reference host loop updates totalSamples += batchSize between
        frames (sample1.cpp:479-490); callers own that counter."""
        n = width * height
        pixel_index = jnp.arange(n, dtype=jnp.int32)
        remaining = int(batch)
        ts = int(total_samples)
        image = None
        while remaining > 0:
            sub = min(remaining, self.max_batch_per_dispatch)
            fn = self._jitted(sub, int(depth), int(debug),
                              int(hit_group_offset),
                              int(miss_group_offset))
            accum, image = fn(scene, resources, accum, jnp.uint32(ts),
                              pixel_index)
            ts += sub
            remaining -= sub
        return accum, image.reshape(height, width, 4)

    def __hash__(self):  # let lru_cache key on object identity
        return id(self)

    def __eq__(self, other):
        return self is other
