"""Pipeline objects + TraceRays dispatch (RD:: C3 component parity).

Reference: radiance/src/radiance.cpp:142-267.  The reference compiles
OpenCL source and extracts the kernel named "raygen" (:152-179); here a
ShaderModule is a RaygenProgram -- a WavefrontPathTracer plus a descriptor
layout that tells TraceRays how to interpret the positionally-bound
buffers (the reference encodes that knowledge in the shader's parameter
list, samples/shader.cl:175-190).

TraceRays(platform, raygen, miss, hit, W, H) honors the reference's
contract: it consumes the bound pipeline + descriptor set, runs one frame
(batchSize samples x depth bounces), writes the u8 image and float scratch
buffers, and leaves RTProp.totalSamples for the host loop to advance
(sample1.cpp:479-490).  Unlike the reference (which ignores the three
group indices, radiance.cpp:242-248), the raygen index selects the SBT
raygen record when several are registered.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from radiance_tpu import config
from radiance_tpu.api import accel as accel_mod
from radiance_tpu.api.platform import Buffer, Image, ImageArray, Platform
from radiance_tpu.core import types
from radiance_tpu.engine.pathtracer import WavefrontPathTracer
from radiance_tpu.scene.bindings import Sampler
from radiance_tpu.shading import camera as camera_mod

# Descriptor type tags (reference: radiance.h:21-29)
ACCEL_STRUCT_TYPE = "accel_struct"
IMAGE_TYPE = "image"
IMAGE_ARRAY_TYPE = "image_array"
IMAGE_SAMPLER_TYPE = "sampler"
BUFFER_TYPE = "buffer"
TEX_ARRAY_TYPE = "tex_array"


@dataclasses.dataclass
class RaygenProgram:
    """A 'shader module': wavefront tracer + descriptor interpretation.

    descriptor_semantics: names, one per bound descriptor, drawn from
      rtprop, image_scratch, image, camera, scene_props, mesh_info,
      vertex, index, uv, normal, material, tex_array, sampler, top_as,
      extent, raw:<name> (opaque extra buffer exposed to shaders as
      res["raw:<name>"] float32 array).
    """
    tracer: WavefrontPathTracer
    descriptor_semantics: List[str]
    name: str = "raygen"


@dataclasses.dataclass
class Pipeline:
    """reference: PipelineCreateInfo (radiance.h:71-80)."""
    max_ray_recursion_depth: int
    layout: List[str]
    modules: List[RaygenProgram]
    groups: List[Any] = dataclasses.field(default_factory=list)


def CreateShaderModule(platform: Platform, code, size: int = 0,
                       name: str = "raygen") -> RaygenProgram:
    """The reference compiles OpenCL source here (radiance.cpp:152-179);
    shader programs are Python in this framework, so `code` must already be
    a RaygenProgram."""
    if isinstance(code, RaygenProgram):
        return code
    raise TypeError(
        "CreateShaderModule expects a RaygenProgram (see "
        "radiance_tpu.engine.programs); runtime OpenCL-source compilation "
        "does not exist here.")


def CreatePipeline(info: Dict or Pipeline) -> Pipeline:
    """Identity passthrough like the reference (radiance.cpp:142-145)."""
    if isinstance(info, Pipeline):
        return info
    return Pipeline(
        max_ray_recursion_depth=info.get("maxRayRecursionDepth", 1),
        layout=info.get("layout", []),
        modules=info.get("modules", []),
        groups=info.get("groups", []))


def CreateDescriptorSet(handles: Sequence[Any]) -> List[Any]:
    """reference: radiance.cpp:147-149 (identity)."""
    return list(handles)


def CreatePipelineLayout(descriptor_types: Sequence[str]) -> List[str]:
    """reference: radiance.cpp:181-184 (identity)."""
    return list(descriptor_types)


def BindPipeline(platform: Platform, pipeline: Pipeline) -> None:
    """reference: radiance.cpp:226-229."""
    platform.active_pipeline = pipeline


def BindDescriptorSet(platform: Platform, descriptor_set: Sequence[Any]) -> None:
    """reference: radiance.cpp:231-240 (sets kernel args positionally)."""
    platform.bound_descriptor_set = list(descriptor_set)


# ---------------------------------------------------------------------------
# Descriptor parsing
# ---------------------------------------------------------------------------

def _parse_struct(buf: Buffer, dtype: np.dtype):
    return np.frombuffer(buf.read(), dtype=dtype, count=max(buf.size // dtype.itemsize, 1))


def _mesh_info_resources(buf: Buffer) -> Dict[str, jnp.ndarray]:
    def parse(host):
        arr = np.frombuffer(host.tobytes(), dtype=types.MESH_INFO_DTYPE)
        return {
            "mesh_vertex_offset": jnp.asarray(arr["vertexOffset"].astype(np.int32)),
            "mesh_index_offset": jnp.asarray(arr["indexOffset"].astype(np.int32)),
            "mesh_uv_offset": jnp.asarray(arr["uvOffset"].astype(np.int32)),
            "mesh_normal_offset": jnp.asarray(arr["normalOffset"].astype(np.int32)),
            "mesh_material_index": jnp.asarray(arr["materialIndex"].astype(np.int32)),
        }
    return buf.device("mesh_info", parse)


def _material_resources(buf: Buffer) -> Dict[str, jnp.ndarray]:
    def parse(host):
        arr = np.frombuffer(host.tobytes(), dtype=types.MATERIAL_DTYPE)
        return {
            "mat_albedo": jnp.asarray(np.ascontiguousarray(arr["albedo"])),
            "mat_metallic": jnp.asarray(np.ascontiguousarray(arr["metallic"])),
            "mat_roughness": jnp.asarray(np.ascontiguousarray(arr["roughness"])),
            "mat_transmission": jnp.asarray(np.ascontiguousarray(arr["transmission"])),
            "mat_ior": jnp.asarray(np.ascontiguousarray(arr["ior"])),
            "mat_albedo_tex": jnp.asarray(np.ascontiguousarray(arr["albedoTexIdx"])),
            "mat_metallic_tex": jnp.asarray(np.ascontiguousarray(arr["metallicTexIdx"])),
            "mat_roughness_tex": jnp.asarray(np.ascontiguousarray(arr["roughnessTexIdx"])),
            "mat_normal_tex": jnp.asarray(np.ascontiguousarray(arr["normalTexIdx"])),
        }
    return buf.device("material", parse)


def _scene_props_resources(buf: Buffer) -> Dict[str, jnp.ndarray]:
    def parse(host):
        arr = np.frombuffer(host.tobytes(), dtype=types.SCENE_PROPERTIES_DTYPE)[0]
        return {
            "light_direction": jnp.asarray(np.ascontiguousarray(arr["lights"]["direction"])),
            "light_color": jnp.asarray(np.ascontiguousarray(arr["lights"]["color"])),
            "light_count": jnp.asarray(np.int32(arr["lightCount"][0])),
        }
    return buf.device("scene_props", parse)


def _flat_f32(buf: Buffer, key: str) -> jnp.ndarray:
    return buf.device(key, lambda host: jnp.asarray(
        np.frombuffer(host.tobytes(), np.float32)))


def _flat_i32(buf: Buffer, key: str) -> jnp.ndarray:
    return buf.device(key, lambda host: jnp.asarray(
        np.frombuffer(host.tobytes(), np.uint32).astype(np.int32)))


def build_resources(program: RaygenProgram,
                    descriptor_set: Sequence[Any]) -> Dict[str, Any]:
    """Interpret positional descriptors into the shader resource dict."""
    res: Dict[str, Any] = {"textures": None, "sampler": Sampler()}
    handles = dict(zip(program.descriptor_semantics, descriptor_set))

    for sem, handle in handles.items():
        if sem in ("rtprop", "image_scratch", "image", "top_as"):
            continue  # handled by TraceRays itself
        elif sem == "camera":
            cam = _parse_struct(handle, types.PHYSICAL_CAMERA_DTYPE)[0]
            res["camera"] = camera_mod.camera_params(cam)
        elif sem == "scene_props":
            res.update(_scene_props_resources(handle))
        elif sem == "mesh_info":
            res.update(_mesh_info_resources(handle))
        elif sem == "material":
            res.update(_material_resources(handle))
        elif sem == "vertex":
            res["vertex_data"] = _flat_f32(handle, "vertex")
        elif sem == "uv":
            res["uv_data"] = _flat_f32(handle, "uv")
        elif sem == "normal":
            res["normal_data"] = _flat_f32(handle, "normal")
        elif sem == "index":
            res["index_data"] = _flat_i32(handle, "index")
        elif sem == "tex_array":
            res["textures"] = handle.device() if isinstance(handle, ImageArray) else handle
        elif sem == "sampler":
            res["sampler"] = handle
        elif sem == "extent":
            ext = np.frombuffer(handle.read(), np.uint32)
            res["extent"] = (int(ext[0]), int(ext[1]))
        elif sem.startswith("raw:"):
            res[sem] = _flat_f32(handle, sem)
        else:
            raise ValueError(f"unknown descriptor semantic {sem!r}")
    return res


def TraceRays(platform: Platform,
              raygen_group_index: int,
              miss_group_index: int,
              hit_group_index: int,
              width: int,
              height: int) -> None:
    """Dispatch one frame (reference: radiance.cpp:242-267).

    Reads RTProp from the bound descriptor set, renders batchSize samples
    at depth bounces, writes the image (u8) and accumulation scratch
    buffers.  totalSamples is left untouched for the host loop.

    Unlike the reference, which accepts but ignores the three group
    indices (radiance.cpp:242-248), they are real here:
      raygen_group_index selects pipeline.modules[i] (the reference can
        only ever run modules[0], radiance.cpp:238);
      hit_group_index / miss_group_index are added to the raygen
        program's configured SBT hit offset / miss index (Vulkan-style
        additive record offsets), so (0, 0, 0) reproduces the
        reference's sample behavior exactly.
    """
    pipeline: Pipeline = platform.active_pipeline
    if not (0 <= raygen_group_index < len(pipeline.modules)):
        raise IndexError(
            f"raygen group index {raygen_group_index} out of range for "
            f"pipeline with {len(pipeline.modules)} module(s)")
    program = pipeline.modules[raygen_group_index]
    ds = platform.bound_descriptor_set
    handles = dict(zip(program.descriptor_semantics, ds))

    rtprop = _parse_struct(handles["rtprop"], types.RAY_TRACE_PROPERTIES_DTYPE)[0]
    batch = int(rtprop["batchSize"])
    depth = int(rtprop["depth"])
    debug = int(rtprop["debug"])
    total_samples = int(rtprop["totalSamples"])

    top = handles["top_as"]
    scene = top.device_scene() if hasattr(top, "device_scene") else top

    res = build_resources(program, ds)

    n = width * height
    scratch_buf: Buffer = handles["image_scratch"]
    if scratch_buf.device_dirty and scratch_buf.device_value is not None:
        accum = scratch_buf.device_value
    else:
        accum = scratch_buf.device(
            "accum", lambda host: jnp.asarray(
                np.frombuffer(host.tobytes(), np.float32).reshape(n, 4)[:, :3]))

    accum, image = program.tracer.render(
        scene, res, accum, total_samples, width, height,
        batch=batch, depth=depth, debug=debug,
        hit_group_offset=hit_group_index, miss_group_offset=miss_group_index)

    def accum_to_host(a):
        out = np.zeros((n, 4), np.float32)
        out[:, :3] = a
        return out

    scratch_buf.set_device_value(accum, to_host=accum_to_host, key="accum")
    image_buf: Buffer = handles["image"]
    image_buf.set_device_value(image, to_host=lambda im: np.asarray(im))
