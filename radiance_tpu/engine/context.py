"""Shading context: the wavefront equivalent of HitData/SceneData.

The reference passes per-ray HitData + a SceneData struct of raw device
pointers into user shaders (reference: radiance/shader/radiance.cl:8-29,
samples/shader.cl:14-30).  Here a ShadeContext carries the same
information as batched arrays plus the bound scene resources, and the
attribute-fetch helpers (reference: samples/shader.cl:308-480) are batched
gathers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import jax.numpy as jnp
from radiance_tpu.core import struct

from radiance_tpu.core import math as rmath
from radiance_tpu.ops import texture as texture_ops


@struct.dataclass
class Payload:
    """The user-payload contract of the reference megakernels
    (reference: samples/shader.cl:4-12)."""
    color: jnp.ndarray        # [N, 3]
    hit: jnp.ndarray          # [N] bool, set by shaders
    next_factor: jnp.ndarray  # [N, 3]
    next_origin: jnp.ndarray  # [N, 3]
    next_dir: jnp.ndarray     # [N, 3]


@struct.dataclass
class ShadeContext:
    """Batched HitData + ray + frame info handed to shaders.

    Fields mirror radiance.cl's HitData (:8-18): instance_id is
    gl_InstanceID (creation order), custom_id is
    gl_InstanceCustomIndexEXT, sbt_offset the instance SBT offset,
    transform the object-to-world matrix of the hit instance.
    """
    hit: jnp.ndarray            # [N] bool -- traversal found a hit
    t: jnp.ndarray              # [N]
    prim: jnp.ndarray           # [N] i32 primitiveIndex within the mesh
    instance_id: jnp.ndarray    # [N] i32
    custom_id: jnp.ndarray      # [N] i32
    sbt_offset: jnp.ndarray     # [N] i32
    bary: jnp.ndarray           # [N, 3] (w, b1, b2) like radiance.cl:244-246
    hit_point: jnp.ndarray      # [N, 3] object-space hit point
    transform: jnp.ndarray      # [N, 4, 4] object->world
    ray_origin: jnp.ndarray     # [N, 3] world
    ray_dir: jnp.ndarray        # [N, 3] world
    pixel_index: jnp.ndarray    # [N] i32 (get_global_id analog)
    frame_id: jnp.ndarray       # [] or [N] u32
    depth: jnp.ndarray          # [] i32 current bounce
    # [N] bool dispatch mask: which lanes this shader invocation is live
    # for (set by the SBT dispatch); shaders pass it to trace_occlusion
    # so dead lanes retire instantly instead of tracing real geometry
    active: Optional[jnp.ndarray] = None
    # non-pytree static payload:
    resources: Any = struct.field(pytree_node=True, default=None)
    debug: int = struct.field(pytree_node=False, default=0)
    # occlusion-trace handle: (origin [N,3], dir [N,3], tmin, tmax) -> [N] bool
    trace_occlusion: Optional[Callable] = struct.field(pytree_node=False, default=None)
    # full recursive trace handle for custom shaders (closest-hit semantics)
    trace_rays: Optional[Callable] = struct.field(pytree_node=False, default=None)


# ----------------------------------------------------------------------------
# Attribute fetch helpers (reference: samples/shader.cl:308-480).
# `res` is a dict of bound scene arrays:
#   mesh_vertex_offset/index_offset/uv_offset/normal_offset/material_index [M]
#   vertex_data/uv_data/normal_data: flat [*] f32 (element offsets, stride 3)
#   index_data: flat [*] u32
#   mat_*: material SoA
#   textures: [T, H, W, 4] u8; sampler: (addressing, filter) static tuple
# ----------------------------------------------------------------------------

def get_indices(ctx: ShadeContext, res: Dict) -> jnp.ndarray:
    """Triangle vertex indices [N, 3] (reference: shader.cl:308-320)."""
    mesh = jnp.clip(ctx.instance_id, 0, res["mesh_index_offset"].shape[0] - 1)
    io = res["mesh_index_offset"][mesh]
    base = io + ctx.prim * 3
    idx = res["index_data"]
    return jnp.stack([idx[base], idx[base + 1], idx[base + 2]], axis=-1).astype(jnp.int32)


def _fetch3(flat: jnp.ndarray, offset: jnp.ndarray, indices: jnp.ndarray) -> jnp.ndarray:
    """Gather 3 consecutive floats at offset + index*3 for each of 3 verts.
    Returns [N, 3(vert), 3(xyz)]."""
    base = offset[:, None] + indices * 3  # [N, 3]
    return jnp.stack([flat[base], flat[base + 1], flat[base + 2]], axis=-1)


def get_uv(ctx: ShadeContext, res: Dict) -> jnp.ndarray:
    """Barycentric-interpolated UV [N, 2] (reference: shader.cl:322-336).

    UVs are stored with stride 3 (vec3 in the loader, sceneBuilder.cpp:84).
    """
    mesh = jnp.clip(ctx.instance_id, 0, res["mesh_uv_offset"].shape[0] - 1)
    uo = res["mesh_uv_offset"][mesh]
    i = get_indices(ctx, res)
    v = _fetch3(res["uv_data"], uo, i)  # [N, 3, 3]; only xy used
    w = ctx.bary[:, :, None]
    uv = (v * w).sum(axis=1)
    return uv[:, :2]


def get_face_normal(ctx: ShadeContext, res: Dict) -> jnp.ndarray:
    """World-space interpolated normal [N, 3] (reference: shader.cl:338-367)."""
    mesh = jnp.clip(ctx.instance_id, 0, res["mesh_normal_offset"].shape[0] - 1)
    no = res["mesh_normal_offset"][mesh]
    i = get_indices(ctx, res)
    n = _fetch3(res["normal_data"], no, i)  # [N, 3, 3]
    normal = (n * ctx.bary[:, :, None]).sum(axis=1)
    world = rmath.mat4_transform_dir(ctx.transform, normal)
    return rmath.normalize(world, eps=1e-30)


def get_material_index(ctx: ShadeContext, res: Dict) -> jnp.ndarray:
    mesh = jnp.clip(ctx.instance_id, 0, res["mesh_material_index"].shape[0] - 1)
    return res["mesh_material_index"][mesh]


def _sample_tex(res: Dict, tex_idx: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """read_imageui(imageArray, sampler, {u, 1-v, layer}) (shader.cl:378-379)."""
    sampler = res["sampler"]
    return texture_ops.sample_image_array(
        res["textures"], uv[:, 0], 1.0 - uv[:, 1],
        jnp.clip(tex_idx, 0, None),
        addressing=sampler.addressing, filter_mode=sampler.filter)


def get_mat_normal(ctx: ShadeContext, res: Dict, face_normal: jnp.ndarray) -> jnp.ndarray:
    """Normal-mapped shading normal (reference: shader.cl:369-395)."""
    mat = get_material_index(ctx, res)
    tex_idx = res["mat_normal_tex"][mat]
    if res.get("textures") is None:
        return face_normal
    uv = get_uv(ctx, res)
    tex = _sample_tex(res, tex_idx, uv)  # [N, 4] 0..255
    local = rmath.normalize(
        jnp.clip(tex[:, :3] / 255.0, 0.0, 1.0) * 2.0 - 1.0, eps=1e-30)
    mapped = rmath.normalize(
        rmath.transform_local_dir(face_normal, local), eps=1e-30)
    return jnp.where((tex_idx != -1)[:, None], mapped, face_normal)


def get_material_prop(ctx: ShadeContext, res: Dict) -> jnp.ndarray:
    """[N, 4] = (metallic, roughness, transmission, ior)
    (reference: shader.cl:397-430)."""
    mat = get_material_index(ctx, res)
    metallic = res["mat_metallic"][mat]
    roughness = jnp.clip(res["mat_roughness"][mat], 0.0, 1.0)
    transmission = jnp.clip(res["mat_transmission"][mat], 0.0, 1.0)
    ior = jnp.clip(res["mat_ior"][mat], 0.0, 10.0)
    if res.get("textures") is not None:
        uv = get_uv(ctx, res)
        mt = res["mat_metallic_tex"][mat]
        rt = res["mat_roughness_tex"][mat]
        mtex = _sample_tex(res, mt, uv)
        rtex = _sample_tex(res, rt, uv)
        # glTF metallicRoughness packing: metallic = B, roughness = G
        # (shader.cl:412, :422)
        metallic = jnp.where(mt != -1, jnp.clip(mtex[:, 2] / 255.0, 0.0, 1.0), metallic)
        roughness = jnp.where(rt != -1, jnp.clip(rtex[:, 1] / 255.0, 0.05, 1.0), roughness)
    return jnp.stack([metallic, roughness, transmission, ior], axis=-1)


def get_albedo(ctx: ShadeContext, res: Dict) -> jnp.ndarray:
    """[N, 3] base color (reference: shader.cl:432-451)."""
    mat = get_material_index(ctx, res)
    albedo = res["mat_albedo"][mat][:, :3]
    if res.get("textures") is not None:
        at = res["mat_albedo_tex"][mat]
        uv = get_uv(ctx, res)
        tex = _sample_tex(res, at, uv)
        albedo = jnp.where((at != -1)[:, None],
                           jnp.clip(tex[:, :3] / 255.0, 0.0, 1.0), albedo)
    return albedo


def get_hit_position(ctx: ShadeContext, n: jnp.ndarray) -> jnp.ndarray:
    """World hit position nudged along n (reference: shader.cl:453-468)."""
    world = rmath.mat4_transform_point(ctx.transform, ctx.hit_point)
    return world + n * 1e-5


def get_light_direction(res: Dict) -> jnp.ndarray:
    """Direction *towards* light 0 (reference: shader.cl:470-475)."""
    return rmath.normalize(-res["light_direction"][0, :3], eps=1e-30)


def get_view_direction(ctx: ShadeContext) -> jnp.ndarray:
    """normalize(-ray direction) (reference: shader.cl:477-480)."""
    return rmath.normalize(-ctx.ray_dir, eps=1e-30)
