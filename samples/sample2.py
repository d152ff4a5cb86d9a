"""Sample 2: textured multi-instance tracer with custom user shaders.

Port of the reference's sample2 (reference: samples/sample2.cpp +
samples/shader2.cl): one BLAS instanced 9 times in a 3x3 grid with
distinct customInstanceIDs, 3 hand-built materials selected by
instanceIndex % 3, two 1024^2 textures in an image array with live albedo
sampling, a rotating pinhole camera, Reinhard tonemapping, and a TLAS
file round-trip (TopAccelStructToFile / FileToTopAccelStruct).

The shader2 user shaders are defined *here* (not in the framework),
demonstrating custom shader authoring against the wavefront engine.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from radiance_tpu.api import accel, pipeline, platform
from radiance_tpu.api.sbt import ShaderBindingTable
from radiance_tpu.core import math as rmath
from radiance_tpu.core import types
from radiance_tpu.engine import programs
from radiance_tpu.engine import shaders as builtin_shaders
from radiance_tpu.engine.context import Payload
from radiance_tpu.scene import objmesh
from radiance_tpu.shading import pbr
from radiance_tpu.utils import image as image_io

AS_PATH = "/tmp/bvh-cache.bin"


# ---------------------------------------------------------------------------
# user shaders (ports of shader2.cl:199-394)
# ---------------------------------------------------------------------------

def material2(ctx, payload: Payload) -> Payload:
    """shader2.cl:207-378: flat attribute fetch (single mesh, no MeshInfo),
    matIndex = instanceIndex % 3, textured albedo, BRDF direct + GI."""
    res = ctx.resources
    n = ctx.ray_origin.shape[0]

    idx = res["index_data"]
    base = ctx.prim * 3
    i0 = idx[base]
    i1 = idx[base + 1]
    i2 = idx[base + 2]

    def fetch3(flat, i):
        b = i * 3
        return jnp.stack([flat[b], flat[b + 1], flat[b + 2]], axis=-1)

    nd = res["normal_data"]
    n0, n1, n2 = fetch3(nd, i0), fetch3(nd, i1), fetch3(nd, i2)
    uvd = res["uv_data"]
    uv0, uv1, uv2 = fetch3(uvd, i0)[:, :2], fetch3(uvd, i1)[:, :2], fetch3(uvd, i2)[:, :2]

    w = ctx.bary
    mat_index = jnp.mod(ctx.instance_id, 3)
    metallic = res["mat_metallic"][mat_index]
    roughness = jnp.clip(res["mat_roughness"][mat_index], 0.0, 1.0)

    # live texture albedo override (shader2.cl:255-265) -- layer 0
    uv = w[:, 0:1] * uv0 + w[:, 1:2] * uv1 + w[:, 2:3] * uv2
    from radiance_tpu.ops import texture as texture_ops
    sampler = res["sampler"]
    tex = texture_ops.sample_image_array(
        res["textures"], uv[:, 0], 1.0 - uv[:, 1], jnp.zeros(n),
        addressing=sampler.addressing, filter_mode=sampler.filter)
    albedo = tex[:, :3] / 255.0

    normal = w[:, 0:1] * n0 + w[:, 1:2] * n1 + w[:, 2:3] * n2
    nrm = rmath.normalize(normal, eps=1e-30)

    # origin = hitPoint + instance translation + N*1e-4 (shader2.cl:274;
    # instances are translation-only so transform-point is equivalent)
    origin = rmath.mat4_transform_point(ctx.transform, ctx.hit_point) + nrm * 1e-4
    cam = res["raw:camera"]
    v = rmath.normalize(cam[:3] - origin, eps=1e-30)
    l = rmath.normalize(-res["light_direction"][0, :3], eps=1e-30)
    l = jnp.broadcast_to(l, (n, 3))

    occluded = ctx.trace_occlusion(origin, l, 0.01, 1000.0,
                                   active=ctx.active)
    light_color = res["light_color"][0, :3]
    lo = pbr.brdf(l, v, nrm, metallic, roughness, albedo) * light_color
    color = jnp.where(occluded[:, None], 0.0, lo) + albedo * 0.05

    rand_input = jnp.stack([
        jnp.broadcast_to(ctx.frame_id, (n,)).astype(jnp.uint32),
        ctx.pixel_index.astype(jnp.uint32),
        jnp.broadcast_to(ctx.depth, (n,)).astype(jnp.uint32)], axis=-1)
    random = rmath.pcg3d(rand_input)
    next_dir, next_factor = pbr.sample_microfacet_brdf(
        v, nrm, albedo, metallic, roughness, random)

    if ctx.debug == 1:
        color = nrm / 2.0 + 0.5
    elif ctx.debug == 7:
        color = ctx.bary

    return payload.replace(color=color, hit=jnp.ones(n, bool),
                           next_origin=origin, next_dir=next_dir,
                           next_factor=next_factor)


def environment2(ctx, payload: Payload) -> Payload:
    n = ctx.ray_origin.shape[0]
    return payload.replace(
        color=jnp.broadcast_to(jnp.asarray([0.2, 0.2, 0.5], jnp.float32), (n, 3)),
        hit=jnp.zeros(n, bool))


def shadow2(ctx, payload: Payload) -> Payload:
    n = ctx.ray_origin.shape[0]
    return payload.replace(color=jnp.zeros((n, 3), jnp.float32),
                           hit=jnp.ones(n, bool))


def shadow_miss2(ctx, payload: Payload) -> Payload:
    n = ctx.ray_origin.shape[0]
    return payload.replace(color=jnp.ones((n, 3), jnp.float32),
                           hit=jnp.zeros(n, bool))


SHADERS = {
    "material": material2,
    "environment": environment2,
    "shadow": shadow2,
    "shadowMiss": shadow_miss2,
    "anyShadow": builtin_shaders.any_shadow,
}


# ---------------------------------------------------------------------------
# scene assembly (sample2.cpp:92-270)
# ---------------------------------------------------------------------------

def default_mesh():
    """A smooth torus standing in for the reference's monkey OBJ asset."""
    nu, nv = 48, 24
    r_maj, r_min = 0.32, 0.16
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    x = (r_maj + r_min * np.cos(vv)) * np.cos(uu)
    y = r_min * np.sin(vv)
    z = (r_maj + r_min * np.cos(vv)) * np.sin(uu)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu / (2 * np.pi), vv / (2 * np.pi), 0 * uu],
                   -1).reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            tris += [(a, b, c), (a, c, d)]
    tris = np.asarray(tris, np.uint32)
    normals = objmesh.smooth_normals(verts, tris)
    return verts, tris, normals, uvs


def checker_texture(size, c0, c1, tiles=8):
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((xx * tiles // size) + (yy * tiles // size)) % 2 == 0
    img = np.where(mask[..., None], np.asarray(c0, np.uint8),
                   np.asarray(c1, np.uint8))
    return np.concatenate([img, np.full((size, size, 1), 255, np.uint8)], -1)


def get_instance_list(blas):
    """9 instances, 3x3 grid, distinct customInstanceIDs
    (sample2.cpp:404-505)."""
    instances = []
    k = 0
    for dx in (0.0, 1.0, -1.0):
        for dy in (0.0, -1.0, -2.0):
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = [dx, dy, 0.0]
            instances.append(types.Instance(
                transform=m, sbt_offset=0,
                custom_instance_id=10 + 30 * k, bottom_accel_struct=blas))
            k += 1
    return instances


def render_sample2(size=512, batch=4, depth=1, frames=1, obj=None,
                   load_cache=False, out=None, tex_dim=1024):
    """Build and run the full sample2 pipeline; returns the u8 image
    [H, W, 4].  Kept callable so tests can drive the exact frame loop
    (golden-image parity, tests/test_golden_samples.py)."""
    plt = platform.Platform.GetPlatform()
    extent = (size, size)
    n = extent[0] * extent[1]

    if obj:
        verts, tris, normals, uvs = objmesh.load_obj(obj)
    else:
        verts, tris, normals, uvs = default_mesh()

    # AS build + file round trip (sample2.cpp:124-137)
    if load_cache and os.path.exists(AS_PATH):
        tlas = accel.FileToTopAccelStruct(AS_PATH)
    else:
        blas = accel.BuildAccelStruct(types.Mesh(verts, tris), verbose=True)
        tlas = accel.BuildAccelStruct(get_instance_list(blas), verbose=True)
        accel.TopAccelStructToFile(tlas, AS_PATH)

    # buffers
    rtprop = types.RayTraceProperties(0, batch, depth, 0)
    rd_rtprop = platform.CreateBuffer(plt, 16)
    platform.WriteBuffer(plt, rd_rtprop, 16, rtprop.to_numpy())
    rd_image = platform.CreateImage(plt, *extent)
    rd_scratch = platform.CreateBuffer(plt, n * 16)
    rd_extent = platform.CreateBuffer(plt, 8)
    platform.WriteBuffer(plt, rd_extent, 8, np.asarray(extent, np.uint32))
    cam = np.asarray([0.0, -1.0, -10.0, 3.14], np.float32)
    rd_cam = platform.CreateBuffer(plt, 16)
    platform.WriteBuffer(plt, rd_cam, 16, cam)

    # textures: two generated checkers (blue-ish / pink-ish), with
    # the reference's upload/readback sanity dump (sample2.cpp:178-184)
    td = tex_dim
    tex_arr = platform.CreateImageArray(plt, td, td, 2)
    platform.WriteImage(plt, tex_arr, td, td, 0,
                        checker_texture(td, (40, 80, 220), (200, 220, 255)))
    platform.WriteImage(plt, tex_arr, td, td, 1,
                        checker_texture(td, (230, 80, 180), (255, 230, 245)))
    image_io.write_image("/tmp/blue.jpg", platform.ReadImage(plt, tex_arr, td, td, 0))
    image_io.write_image("/tmp/pink.jpg", platform.ReadImage(plt, tex_arr, td, td, 1))
    rd_sampler = platform.CreateSampler(plt, 2, 1)  # repeat, linear

    def flat_buffer(arr):
        arr = np.ascontiguousarray(arr)
        buf = platform.CreateBuffer(plt, arr.nbytes)
        platform.WriteBuffer(plt, buf, arr.nbytes, arr)
        return buf

    rd_vertex = flat_buffer(verts)
    rd_normal = flat_buffer(normals)
    rd_uv = flat_buffer(uvs)
    rd_index = flat_buffer(tris)

    mats = [types.Material(albedo=(1, 1, 0, 1), metallic=0.0, roughness=0.3),
            types.Material(albedo=(0, 1, 1, 1), metallic=0.95, roughness=0.1),
            types.Material(albedo=(1, 0, 1, 1), metallic=0.0, roughness=0.9)]
    mats_np = np.concatenate([m.to_numpy().reshape(1) for m in mats])
    rd_mats = flat_buffer(mats_np)

    props = types.SceneProperties(lights=[types.DirLight(
        direction=(0.2, -1.0, 0.5, 0.0), color=(2.0, 2.0, 2.0, 1.0))])
    rd_props = platform.CreateBuffer(plt, types.SCENE_PROPERTIES_DTYPE.itemsize)
    platform.WriteBuffer(plt, rd_props, rd_props.size, props.to_numpy())

    program = programs.sample2_program(shader_registry=SHADERS)
    shader = pipeline.CreateShaderModule(plt, program)
    pl = pipeline.CreatePipeline({"maxRayRecursionDepth": 1, "layout": [],
                                  "modules": [shader]})
    desc = pipeline.CreateDescriptorSet([
        rd_rtprop, rd_scratch, rd_image, rd_extent, rd_cam,
        rd_vertex, rd_normal, rd_uv, rd_index, rd_mats, rd_props,
        tex_arr, rd_sampler, tlas])
    pipeline.BindPipeline(plt, pl)
    pipeline.BindDescriptorSet(plt, desc)

    for frame in range(frames):
        pipeline.TraceRays(plt, 0, 0, 0, *extent)
        rt = np.frombuffer(platform.ReadBuffer(plt, rd_rtprop, 16),
                           dtype=types.RAY_TRACE_PROPERTIES_DTYPE).copy()
        rt["totalSamples"] += rt["batchSize"]
        platform.WriteBuffer(plt, rd_rtprop, 16, rt)

    img = platform.ReadBuffer(plt, rd_image, rd_image.size).reshape(
        extent[1], extent[0], 4)
    out = out or "/tmp/sample2_output.png"
    image_io.write_image(out, img)
    print(f"sample2 wrote {out} (totalSamples="
          f"{int(rt['totalSamples'][0])})")
    return img


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--obj", type=str, default=None)
    ap.add_argument("--load-cache", action="store_true",
                    help="FileToTopAccelStruct path (LOAD_FROM_FILE)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    render_sample2(size=args.size, batch=args.batch, depth=args.depth,
                   frames=args.frames, obj=args.obj,
                   load_cache=args.load_cache, out=args.out)


if __name__ == "__main__":
    main()
