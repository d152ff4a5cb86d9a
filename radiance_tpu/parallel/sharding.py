"""Multi-device scaling: pixel-tile data parallelism over a device mesh.

The reference is strictly single-device (SURVEY.md §2.2); this is the
scale-out the rebuild adds: rays are embarrassingly parallel, so the
natural mapping is sharding the pixel wavefront across devices with
`shard_map` -- the scene is replicated, each device traverses and shades
its own pixel rows with zero communication, and only image assembly
moves data between devices (an all-gather XLA inserts at the output).

Three modes:
  * pixel sharding (`shard_frame`): identical results to single-chip,
    throughput scales with chips
  * sample parallelism (`sample_parallel_frame`): every chip renders the
    full image with a different sample-seed offset; a `pmean` over the
    mesh merges them -- linear convergence-rate scaling for progressive
    rendering
  * 2D tiles x samples (`make_mesh2d` + `tile_sample_frame`): pixels
    sharded over the `px` axis, the sample sequence split over the `sp`
    axis with a psum along it -- composes both scalings
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from radiance_tpu.bvh.device import DeviceScene
from radiance_tpu.engine.pathtracer import WavefrontPathTracer


def _shard_map(f, mesh, in_specs, out_specs):
    # check_vma=False: the frame functions mix replicated and sharded
    # values in ways the varying-manual-axes checker cannot follow
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_mesh(n_devices: int = None, axis: str = "px") -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.array(devices[:n]), (axis,))


def shard_frame(tracer: WavefrontPathTracer, mesh: Mesh, *,
                batch: int, depth: int, debug: int = 0,
                axis: str = "px") -> Callable:
    """Pixel-sharded frame: accum/pixel_index split across the mesh,
    scene + resources replicated.  Returns
    fn(scene, resources, accum [N,3], total_samples, pixel_index [N])
      -> (accum', image_u8 [N,4])  with N divisible by mesh size.
    """
    frame = tracer.frame_fn(batch=batch, depth=depth, debug=debug)

    sharded = _shard_map(
        frame, mesh,
        in_specs=(P(), P(), P(axis), P(), P(axis)),
        out_specs=(P(axis), P(axis)))
    return jax.jit(sharded)


def sample_parallel_frame(tracer: WavefrontPathTracer, mesh: Mesh, *,
                          batch: int, depth: int, debug: int = 0,
                          axis: str = "px") -> Callable:
    """Sample-parallel frame: every device renders all pixels with its own
    slice of the sample sequence; results are averaged over the mesh.

    With D devices and per-device batch B, one call advances the running
    average by D*B samples; callers advance totalSamples by D*B.
    """
    n_dev = mesh.shape[axis]
    frame = tracer.frame_fn(batch=batch, depth=depth, debug=debug)

    def local(scene, resources, accum, total_samples, pixel_index):
        d = jax.lax.axis_index(axis).astype(jnp.uint32)
        # device d consumes sample ids [ts + d*B, ts + (d+1)*B)
        local_ts = total_samples + d * jnp.uint32(batch)
        local_sum = frame.sample_sum(scene, resources, pixel_index,
                                     local_ts, total_samples)
        total_sum = jax.lax.psum(local_sum, axis)
        # merge with the running average: old weight ts, new weight D*B
        ts_f = total_samples.astype(jnp.float32)
        w_new = jnp.float32(n_dev * batch)
        merged = (accum * ts_f + total_sum) / (ts_f + w_new)
        from radiance_tpu.ops import tonemap as tonemap_ops
        rgb = merged if debug else tracer.tonemap(merged)
        return merged, tonemap_ops.quantize_rgba8(rgb)

    sharded = _shard_map(
        local, mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P()))
    return jax.jit(sharded)


def make_mesh2d(n_px: int, n_sp: int, axes=("px", "sp")) -> Mesh:
    """[n_px, n_sp] device mesh: pixel tiles over the first axis,
    sample slices over the second (the psum runs along it)."""
    devices = jax.devices()
    assert n_px * n_sp <= len(devices)
    return Mesh(np.array(devices[:n_px * n_sp]).reshape(n_px, n_sp),
                axes)


def tile_sample_frame(tracer: WavefrontPathTracer, mesh: Mesh, *,
                      batch: int, depth: int, debug: int = 0,
                      px: str = "px", sp: str = "sp") -> Callable:
    """Pixels sharded over `px`, samples over `sp`: device (i, s)
    renders pixel tile i with sample ids
    [ts + s*batch, ts + (s+1)*batch); a psum over `sp` merges the
    sample sums, so one call advances every pixel by
    mesh.shape[sp] * batch samples.  Result matches a single-chip
    frame of batch' = n_sp * batch up to float reduction order.
    """
    n_sp = mesh.shape[sp]
    frame = tracer.frame_fn(batch=batch, depth=depth, debug=debug)

    def local(scene, resources, accum, total_samples, pixel_index):
        s = jax.lax.axis_index(sp).astype(jnp.uint32)
        local_ts = total_samples + s * jnp.uint32(batch)
        local_sum = frame.sample_sum(scene, resources, pixel_index,
                                     local_ts, total_samples)
        total_sum = jax.lax.psum(local_sum, sp)
        ts_f = total_samples.astype(jnp.float32)
        w_new = jnp.float32(n_sp * batch)
        merged = (accum * ts_f + total_sum) / (ts_f + w_new)
        from radiance_tpu.ops import tonemap as tonemap_ops
        rgb = merged if debug else tracer.tonemap(merged)
        return merged, tonemap_ops.quantize_rgba8(rgb)

    sharded = _shard_map(
        local, mesh,
        in_specs=(P(), P(), P(px), P(), P(px)),
        out_specs=(P(px), P(px)))
    return jax.jit(sharded)


def staged_shard_frame(tracer: WavefrontPathTracer, mesh: Mesh, *,
                       batch: int, depth: int, debug: int = 0,
                       axis: str = "px", hit_group_offset: int = 0,
                       miss_group_offset: int = 0) -> Callable:
    """Pixel-sharded frame in stages: every wave (init / primary /
    bounce / finish) is its own shard_mapped jit over the pixel axis,
    chained from the host, instead of putting the whole frame_fn under
    one shard_map (shard_frame).  Rays are embarrassingly parallel, so
    each wave shards with the scene replicated and no communication
    between devices; only the caller's image assembly gathers.

    Returns fn(scene, resources, accum [N,3], total_samples,
    pixel_index [N]) -> (accum', image u8 [N,4]), N divisible by the
    mesh size."""
    from radiance_tpu.engine import pathtracer as pt

    hit_offset = tracer.hit_offset + hit_group_offset
    miss_index = tracer.miss_index + miss_group_offset
    effective_depth = 1 if debug else depth

    def shmap(f, kind, out_spec):
        specs = {
            "init": (P(), P(axis), P(), P()),
            "step": (P(), P(), P(axis), P(), P(), P(axis)),
            "fin": (P(axis), P(axis), P()),
        }[kind]
        return jax.jit(_shard_map(f, mesh, specs, out_spec))

    def step(primary):
        return shmap(
            functools.partial(pt._sample_step, tracer, debug=debug,
                              hit_offset=hit_offset,
                              miss_index=miss_index, primary=primary),
            "step", P(axis))

    j_init = shmap(functools.partial(pt._sample_init, tracer),
                   "init", P(axis))
    j_prim = step(True)
    j_bounce = step(False)
    j_fin = shmap(functools.partial(pt._finish_frame, tracer,
                                    int(batch), int(debug)),
                  "fin", (P(axis), P(axis)))

    def fn(scene, resources, accum, total_samples, pixel_index):
        ts0 = jnp.uint32(total_samples)
        colors = jnp.zeros_like(accum)
        for s in range(int(batch)):
            fid = ts0 + jnp.uint32(s)
            state = j_init(resources, pixel_index, fid, ts0)
            if effective_depth >= 1:
                state = j_prim(scene, resources, pixel_index, fid,
                               jnp.int32(0), state)
                for b in range(1, effective_depth):
                    state = j_bounce(scene, resources, pixel_index,
                                     fid, jnp.int32(b), state)
            colors = colors + state[0]
        return j_fin(accum, colors, ts0)

    return fn


def render_sharded(tracer: WavefrontPathTracer, mesh: Mesh,
                   scene: DeviceScene, resources: Dict, accum,
                   total_samples: int, width: int, height: int, *,
                   batch: int, depth: int, debug: int = 0):
    """Convenience wrapper: pads the pixel wavefront to the mesh size,
    renders pixel-sharded, and reshapes the image."""
    n = width * height
    n_dev = mesh.shape[list(mesh.shape.keys())[0]]
    pad = (-n) % n_dev
    pixel_index = jnp.arange(n + pad, dtype=jnp.int32)
    if pad:
        accum = jnp.concatenate(
            [accum, jnp.zeros((pad, 3), jnp.float32)], axis=0)
    fn = shard_frame(tracer, mesh, batch=batch, depth=depth, debug=debug)
    accum2, image = fn(scene, resources, accum,
                       jnp.uint32(total_samples), pixel_index)
    return accum2[:n], image[:n].reshape(height, width, 4)
