"""Seeded benchmark scenes shared by bench.py, chip_smoke.py and the tests.

* "city": 1000 clusters of jittered triangles spread over a 100-unit
  cube (seed 7).  Spatially coherent like a real scene, open (most
  primary rays escape), one instance.
* "interior": the closed reference-shaped hall of
  scene.procedural.interior_hall (every primary ray hits).

Everything is regenerated from the seed: no asset is downloaded and
nothing is cached on disk.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np

N_TRIS = 1_000_000
WIDTH, HEIGHT = 1920, 1080
SCENE_KINDS = ("city", "interior")


def city_geometry(n_tris: int = N_TRIS, seed: int = 7,
                  n_clusters: int = 1000):
    """(verts [3T, 3] f32, tris [T, 3] u32) of the seeded city; fewer
    clusters give a small scene the full scene's hit rate."""
    rng = np.random.default_rng(seed)
    per = n_tris // n_clusters
    centers = rng.uniform(-50, 50, size=(n_clusters, 3)).astype(np.float32)
    verts_all = []
    for c in centers:
        local = rng.uniform(-1.5, 1.5, size=(per, 3)).astype(np.float32)
        offs = rng.normal(scale=0.08, size=(per, 3, 3)).astype(np.float32)
        verts_all.append((c + local)[:, None, :] + offs)
    verts = np.concatenate(verts_all).reshape(-1, 3)
    tris = np.arange(len(verts), dtype=np.uint32).reshape(-1, 3)
    return verts, tris


def scene_geometry(kind: str, n_tris: int = N_TRIS):
    """(verts, tris) for a named bench scene."""
    if kind == "city":
        return city_geometry(n_tris)
    if kind == "interior":
        from radiance_tpu.scene.procedural import interior_hall
        verts, tris, _meta = interior_hall(n_tris)
        return verts, tris
    raise ValueError(f"unknown scene {kind!r}; choose one of {SCENE_KINDS}")


def build_scene(verts, tris):
    """Single-instance TLAS over one mesh.  Returns (DeviceScene, info)
    with info = {"build_s", "native", "nodes", "device_bytes"}."""
    import jax
    from radiance_tpu.api import accel
    from radiance_tpu.bvh import native
    from radiance_tpu.core import types

    t0 = time.perf_counter()
    blas = accel.BuildBottomAccelStruct(types.Mesh(verts, tris))
    inst = types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)
    scene = accel.BuildTopAccelStruct([inst]).device_scene()
    jax.block_until_ready(scene)
    info = {
        "build_s": time.perf_counter() - t0,
        "native": native.available(),
        "nodes": int(len(blas.nodes)),
        "device_bytes": int(sum(x.nbytes for x in
                                jax.tree_util.tree_leaves(scene))),
    }
    return scene, info


def camera_rays(kind: str = "city", w: int = WIDTH, h: int = HEIGHT,
                tile: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Primary rays of the bench camera in tile order (tile x tile
    screen blocks are contiguous).  Returns (o [N,3], d [N,3]) f32."""
    n = w * h
    px = np.arange(n, dtype=np.int64) % w
    py = np.arange(n, dtype=np.int64) // w
    blk = (py // tile) * (-(-w // tile)) + (px // tile)
    order = np.argsort(blk * tile * tile + (py % tile) * tile
                       + (px % tile), kind="stable")
    xs = px[order] / w - 0.5
    ys = py[order] / h - 0.5
    o = np.zeros((n, 3), np.float32)
    if kind == "interior":
        o[:, 1] = 6.0
        o[:, 2] = 46.0
    else:
        o[:, 2] = 140.0
    d = np.stack([xs * 1.2, ys * 0.7, np.full(n, -1.0)], axis=-1)
    d = d.astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def light_vec(kind: str = "city") -> np.ndarray:
    """Unit to-light direction (the interior's points up through the
    ceiling window openings)."""
    v = np.array([0.15, 1.0, 0.05] if kind == "interior"
                 else [0.5, 1.5, 1.0], np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)


def engine_setup(verts, tris, width: int, height: int, *,
                 f_stop: float = 0.0, focal_length: float = 0.035,
                 focal_distance: float = 80.0):
    """(WavefrontPathTracer, resource bindings) for a bench mesh seen
    by the bench camera: one grey GGX material, face normals, one
    directional light."""
    from radiance_tpu.api.sbt import ShaderBindingTable
    from radiance_tpu.core import types
    from radiance_tpu.engine import shaders
    from radiance_tpu.engine.pathtracer import WavefrontPathTracer
    from radiance_tpu.scene import bindings
    from radiance_tpu.shading import camera

    sbt = ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                       shaders.SHADER_REGISTRY)
    tracer = WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen, sbt=sbt)
    cam = types.PhysicalCamera(
        width_pixel=float(width), height_pixel=float(height),
        focal_length=focal_length, sensor_width=0.05,
        focal_distance=focal_distance, f_stop=f_stop,
        x=0.0, y=0.0, z=140.0, wx=0.0, wy=0.0, wz=0.0)
    tris = tris.astype(np.uint32)
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-9)
    normals = np.repeat(fn, 3, axis=0).astype(np.float32)
    uvs = np.zeros_like(verts)
    mats = [types.Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=0.6)]
    props = types.SceneProperties(lights=[types.DirLight(
        direction=(0.26726124, 0.8017837, 0.5345225, 0.0),
        color=(3.0, 3.0, 3.0, 1.0))])
    res = bindings.make_scene_bindings(
        [types.MeshInfo()], verts, tris, uvs, normals, mats, props)
    res["camera"] = camera.camera_params(cam)
    return tracer, res
