#!/usr/bin/env python
"""Benchmark modes of the wavefront path tracer on one GPU.

    python bench.py              # 3-wave traversal: primary, bounce, shadow
    python bench.py --engine     # WavefrontPathTracer.render, 1080p b4 d4
    python bench.py --shard1     # engine frame under shard_map, 1 device
    python bench.py --sweep      # resolution sweep, BVH builds, apertures
    python bench.py --animated   # rigid TLAS refit + deforming LBVH frames

Scenes are the seeded ones of radiance_tpu.scene.bench_scenes
(RADIANCE_BENCH_SCENE=city|interior, default city, 1M triangles), built
fresh on every run (the native SAH builder takes seconds).  Every mode
prints ONE JSON line naming the device (platform, device_kind, device
count) and the card (nvidia-smi name and power limit); times are taken
to block_until_ready.  Without a GPU the script exits non-zero and
measures nothing.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from radiance_tpu.scene import bench_scenes as bs

WIDTH, HEIGHT = bs.WIDTH, bs.HEIGHT
FLT_MAX = np.float32(3.4028235e38)


def scene_kind() -> str:
    return os.environ.get("RADIANCE_BENCH_SCENE", "city")


def device_fields() -> dict:
    """The device every result was measured on; exits without a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform!r}; "
              f"nothing was measured", file=sys.stderr)
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in card.split(",", 1))
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": name,
            "power_limit": power}


def emit(record: dict, dev: dict) -> None:
    print(json.dumps({**record, **dev}), flush=True)


def build(kind=None):
    verts, tris = bs.scene_geometry(kind or scene_kind())
    scene, info = bs.build_scene(verts, tris)
    print(f"# built {len(tris)}-tri {kind or scene_kind()} BVH in "
          f"{info['build_s']:.1f}s (native={info['native']})",
          file=sys.stderr)
    return scene, verts, tris, info


def timed(fn, iters=3):
    """Warm once, then the median of `iters` runs of fn() (which must
    block until its results are ready)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def run_waves(dev):
    """Primary + mirror bounce + shadow wave over every pixel through
    the XLA walk."""
    import jax
    import jax.numpy as jnp
    from radiance_tpu.core import math as rmath
    from radiance_tpu.ops import traversal

    kind = scene_kind()
    scene, _, _, info = build(kind)
    n = WIDTH * HEIGHT
    o, d = (jnp.asarray(x) for x in bs.camera_rays(kind))
    light = jnp.broadcast_to(jnp.asarray(bs.light_vec(kind)), (n, 3))

    @jax.jit
    def waves(scn, o, d, light):
        t1 = traversal.trace_rays(scn, o, d, 1e-3, 1e4).t
        hit = t1 < FLT_MAX
        hit_p = o + jnp.where(hit, t1, 0.0)[:, None] * d
        nrm = rmath.normalize(o - hit_p, eps=1e-6)
        d2 = rmath.reflect(-d, nrm)
        o2 = jnp.where(hit[:, None], hit_p + nrm * 1e-3, o)
        t2 = traversal.trace_rays(scn, o2, d2, 1e-3, 1e4).t
        t3 = traversal.trace_rays(scn, o2, light, 1e-3, 1e4,
                                  any_hit_terminate=True).t
        return t1, t2, t3

    dt = timed(lambda: jax.block_until_ready(waves(scene, o, d, light)))
    emit({"metric": "traversal_mrays_per_sec_1Mtri_1080p",
          "value": 3 * n / dt / 1e6, "unit": "Mrays/s",
          "ms_per_3_waves": dt * 1e3, "scene": kind,
          "build_s": info["build_s"]}, dev)


def run_engine(dev):
    """WavefrontPathTracer.render at 1080p, batch 4, depth 4."""
    import jax
    import jax.numpy as jnp

    batch, depth = 4, 4
    scene, verts, tris, _ = build("city")
    tracer, res = bs.engine_setup(verts, tris, WIDTH, HEIGHT)
    n = WIDTH * HEIGHT
    state = {"accum": jnp.zeros((n, 3), jnp.float32), "ts": 0}

    def frame():
        state["accum"], img = tracer.render(
            scene, res, state["accum"], state["ts"], WIDTH, HEIGHT,
            batch=batch, depth=depth)
        jax.block_until_ready((state["accum"], img))
        state["ts"] += batch

    t0 = time.perf_counter()
    frame()
    compile_s = time.perf_counter() - t0
    dt = timed(frame)
    emit({"metric": "engine_ms_per_frame_1Mtri_1080p", "value": dt * 1e3,
          "unit": "ms", "batch": batch, "depth": depth,
          "compile_plus_first_frame_s": compile_s,
          "accum_mean": float(jnp.mean(state["accum"]))}, dev)


def run_shard1(dev):
    """The engine frame under shard_map on a 1-device mesh against the
    unsharded frame: the cost of the sharding wrapper itself."""
    import jax
    import jax.numpy as jnp
    from radiance_tpu.parallel.sharding import (make_mesh, shard_frame,
                                                staged_shard_frame)

    batch, depth = 2, 2
    w = h = int(os.environ.get("RADIANCE_SHARD1_RES", "1024"))
    scene, verts, tris, _ = build("city")
    tracer, res = bs.engine_setup(verts, tris, w, h)
    n = w * h
    mesh = make_mesh(1)
    acc0 = jnp.zeros((n, 3), jnp.float32)
    pix = jnp.arange(n, dtype=jnp.int32)
    out = {}
    for name, make in (("shard_frame", shard_frame),
                       ("staged_shard_frame", staged_shard_frame)):
        fn = make(tracer, mesh, batch=batch, depth=depth)
        out[name] = timed(lambda: jax.block_until_ready(
            fn(scene, res, acc0, jnp.uint32(0), pix)))
    dt_u = timed(lambda: jax.block_until_ready(tracer.render(
        scene, res, acc0, 0, w, h, batch=batch, depth=depth)))
    emit({"metric": "shard1_ms_per_frame", "value": out["shard_frame"] * 1e3,
          "unit": "ms", "staged_ms_per_frame":
          out["staged_shard_frame"] * 1e3,
          "unsharded_ms_per_frame": dt_u * 1e3, "res": w, "batch": batch,
          "depth": depth}, dev)


def run_sweep(dev):
    """Resolution sweep of the primary wave (sample1.cpp:331-342's
    list, trimmed), fresh SAH builds of both bench scenes
    (sample1.cpp:344-360), and the aperture / focal-length bank
    (sample1.cpp:286-316) on the engine."""
    import jax
    import jax.numpy as jnp
    from radiance_tpu.core import types
    from radiance_tpu.ops import traversal
    from radiance_tpu.shading import camera

    scene, verts, tris, _ = build("city")
    trace = jax.jit(lambda s, o, d: traversal.trace_rays(
        s, o, d, 1e-3, 1e4).t)
    res_rows = []
    for w, h in ((512, 512), (1024, 1024), (1920, 1080), (2048, 2048)):
        o, d = (jnp.asarray(x) for x in bs.camera_rays("city", w, h))
        dt = timed(lambda: jax.block_until_ready(trace(scene, o, d)))
        res_rows.append({"w": w, "h": h, "mrays": w * h / dt / 1e6,
                         "ms": dt * 1e3})
    build_rows = []
    for kind in bs.SCENE_KINDS:
        _, _, t, info = build(kind)
        build_rows.append({"scene": kind, "tris": int(len(t)),
                           "build_s": info["build_s"],
                           "nodes": info["nodes"]})
    w = h = 512
    tracer, res = bs.engine_setup(verts, tris, w, h)
    acc0 = jnp.zeros((w * h, 3), jnp.float32)
    cam_rows = []
    for f_stop, focal in ((1.4, 0.036), (2.8, 0.05), (8.0, 0.15)):
        res["camera"] = camera.camera_params(types.PhysicalCamera(
            width_pixel=float(w), height_pixel=float(h),
            focal_length=focal, sensor_width=0.05, focal_distance=80.0,
            f_stop=f_stop, x=0.0, y=0.0, z=140.0, wx=0.0, wy=0.0, wz=0.0))
        dt = timed(lambda: jax.block_until_ready(tracer.render(
            scene, res, acc0, 0, w, h, batch=1, depth=2)), iters=1)
        cam_rows.append({"f_stop": f_stop, "focal_mm": focal * 1e3,
                         "ms": dt * 1e3})
    emit({"metric": "sweep_1Mtri", "resolution_sweep": res_rows,
          "bvh_builds": build_rows, "aperture_sweep": cam_rows}, dev)


def run_animated(dev):
    """Rigid motion: 64-instance TLAS refit per frame plus a primary
    wave.  Deforming mesh: in-jit LBVH rebuild plus trace per frame
    against a host SAH rebuild of the same frame."""
    import jax
    import jax.numpy as jnp
    from radiance_tpu.api import accel
    from radiance_tpu.bvh import lbvh
    from radiance_tpu.core import types
    from radiance_tpu.ops import traversal

    rng = np.random.default_rng(11)
    blases = []
    for _ in range(8):
        v, t = bs.city_geometry(bs.N_TRIS // 64, seed=int(rng.integers(1e6)),
                                n_clusters=40)
        blases.append(accel.BuildBottomAccelStruct(
            types.Mesh(v * 0.12, t)))
    instances = []
    for i in range(64):
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = rng.uniform(-44, 44, 3)
        instances.append(types.Instance(tf, 0, i, blases[i // 8]))
    tlas = accel.BuildTopAccelStruct(instances)
    base_tf = np.stack([i.transform for i in instances])

    def frame_tf(k):
        ang = 0.05 * (k + 1)
        rot = np.eye(4, dtype=np.float32)
        rot[0, 0] = rot[2, 2] = np.cos(ang)
        rot[0, 2], rot[2, 0] = np.sin(ang), -np.sin(ang)
        return np.einsum("ij,njk->nik", rot, base_tf)

    w = h = int(os.environ.get("RADIANCE_ANIM_RES", "512"))
    o, d = (jnp.asarray(x) for x in bs.camera_rays("city", w, h))
    trace = jax.jit(lambda s, o_, d_: traversal.trace_rays(
        s, o_, d_, 1e-3, 1e4).t)
    k = [0]

    def rigid():
        k[0] += 1
        jax.block_until_ready(trace(tlas.refit(frame_tf(k[0])), o, d))

    dt_r = timed(rigid, iters=6)

    n_tris = int(os.environ.get("RADIANCE_ANIM_TRIS", "64000"))
    centers = rng.uniform(-20, 20, (n_tris, 3)).astype(np.float32)
    verts0 = (centers[:, None] + rng.normal(scale=0.25, size=(
        n_tris, 3, 3)).astype(np.float32)).reshape(-1, 3)
    tris = np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3)
    phase = jnp.asarray(rng.uniform(0, 6.28, verts0.shape).astype(
        np.float32))
    o2 = o * 0.3

    @jax.jit
    def lbvh_frame(vbase, step):
        v = vbase + 0.3 * jnp.sin(phase + 0.3 * step)
        return traversal.trace_rays(lbvh.lbvh_scene(v, jnp.asarray(tris)),
                                    o2, d, 1e-3, 1e4).t

    v_dev = jnp.asarray(verts0)
    dt_l = timed(lambda: jax.block_until_ready(
        lbvh_frame(v_dev, jnp.float32(6.0))), iters=6)
    vk = np.asarray(v_dev + 0.3 * jnp.sin(phase + 0.3 * 6.0))
    t0 = time.perf_counter()
    sah = accel.BuildTopAccelStruct([types.Instance(
        np.eye(4, dtype=np.float32), 0, 0, accel.BuildBottomAccelStruct(
            types.Mesh(vk, tris.astype(np.uint32))))]).device_scene()
    t_sah = np.asarray(jax.block_until_ready(trace(sah, o2, d)))
    dt_s = time.perf_counter() - t0
    t_lb = np.asarray(lbvh_frame(v_dev, jnp.float32(6.0)))
    mismatch = float(np.mean((t_lb < FLT_MAX) != (t_sah < FLT_MAX)))
    emit({"metric": "animated_tlas",
          "rigid_refit_ms_per_frame": dt_r * 1e3, "rigid_instances": 64,
          "lbvh_ms_per_frame": dt_l * 1e3,
          "sah_rebuild_plus_trace_ms": dt_s * 1e3,
          "hit_mismatch_frac": mismatch, "res": w, "tris": n_tris}, dev)


MODES = {"--engine": run_engine, "--shard1": run_shard1,
         "--sweep": run_sweep, "--animated": run_animated}


def main(argv):
    modes = [a for a in argv if a in MODES]
    unknown = [a for a in argv if a not in MODES]
    if unknown or len(modes) > 1:
        what = (f"unknown mode {' '.join(unknown)}" if unknown
                else "one mode at a time")
        print(f"bench.py: {what}; usage: bench.py [{'|'.join(MODES)}]",
              file=sys.stderr)
        return 2
    dev = device_fields()
    (MODES[modes[0]] if modes else run_waves)(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
