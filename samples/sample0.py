"""Sample 0: minimal primary-ray render of a hardcoded triangle scene.

Realization of the reference's API design sketch (reference:
samples/sample0.cpp, never compiled there) and its stale bring-up driver
(radiance/src/main.cpp directGen/triangleHit): a hardcoded triangle,
flat-color closest-hit and miss shaders, one primary ray per pixel,
512x512 PNG out.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from radiance_tpu.api import accel
from radiance_tpu.api.sbt import ShaderBindingTable
from radiance_tpu.core import types
from radiance_tpu.engine.context import Payload
from radiance_tpu.engine.pathtracer import WavefrontPathTracer
from radiance_tpu.utils import image as image_io


def triangle_hit(ctx, payload: Payload):
    """Barycentric-colored closest hit (main.cpp triangleHit analog)."""
    n = ctx.ray_origin.shape[0]
    return payload.replace(color=ctx.bary, hit=jnp.ones(n, bool))


def miss_black(ctx, payload: Payload):
    n = ctx.ray_origin.shape[0]
    return payload.replace(
        color=jnp.broadcast_to(jnp.asarray([0.1, 0.1, 0.1], jnp.float32), (n, 3)),
        hit=jnp.zeros(n, bool))


def direct_gen(resources, pixel_index, rand_input):
    """Pinhole rays straight down -z (main.cpp directGen analog)."""
    w, h = resources["extent"]
    x = (pixel_index % w).astype(jnp.float32)
    y = (pixel_index // w).astype(jnp.float32)
    fx = (x + 0.5) / w - 0.5
    fy = 0.5 - (y + 0.5) / h
    d = jnp.stack([fx, fy, jnp.full_like(fx, -1.0)], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 2.0], jnp.float32), d.shape)
    return o, d


def main(size=512, out=None):
    verts = np.asarray([[-0.8, -0.6, 0.0], [0.8, -0.6, 0.0], [0.0, 0.9, 0.0]],
                       np.float32)
    tris = np.asarray([[0, 1, 2]], np.uint32)
    blas = accel.BuildAccelStruct(types.Mesh(verts, tris))
    tlas = accel.BuildAccelStruct([types.Instance(
        np.eye(4, dtype=np.float32), 0, 0, blas)])

    sbt = ShaderBindingTable.from_json([
        {"raygen": "raygen", "closestHit": "", "anyHit": "", "miss": ""},
        {"raygen": "", "closestHit": "triangleHit", "anyHit": "", "miss": ""},
        {"raygen": "", "closestHit": "", "anyHit": "", "miss": ""},
        {"raygen": "", "closestHit": "", "anyHit": "", "miss": "missBlack"},
    ], {"triangleHit": triangle_hit, "missBlack": miss_black})

    tracer = WavefrontPathTracer(
        ray_generator=direct_gen, sbt=sbt, tonemap=lambda x: x,
        hit_offset=1, miss_index=3)

    res = {"extent": (size, size), "sampler": None}
    accum = jnp.zeros((size * size, 3), jnp.float32)
    accum, image = tracer.render(tlas.device_scene(), res, accum, 0,
                                 size, size, batch=1, depth=1)
    out = out or "/tmp/sample0_output.png"
    image_io.write_image(out, np.asarray(image))
    print(f"sample0 wrote {out}")
    return np.asarray(image)


if __name__ == "__main__":
    main()
