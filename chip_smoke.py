#!/usr/bin/env python
"""Chip smoke: drive the wavefront path tracer's main path once on a GPU.

    python chip_smoke.py            # one card: phases (a)-(e)
    python chip_smoke.py --multi    # four cards: sharded frames only

Phases, each printing its own lines:
  (a) card      nvidia-smi name and power limit, JAX device kind
  (b) scene     seeded 1M-triangle city, SAH build time, device bytes
  (c) traverse  1080p primary, shadow and GGX-bounce waves through the
                XLA walk against chunked brute force on the card
  (d) engine    Cornell frame at 64^2 against the NumPy frame oracle
  (e) frame     WavefrontPathTracer.render at 1080p, batch 4, depth 4
  (f) --multi   pixel sharding and sample parallelism on a 4-card mesh
                against the one-card frame

The last line of stdout is one JSON object naming the device.  The
script refuses to run without a GPU, and any failed gate exits non-zero
before that line is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

# oracle gates (the round-5 exactness gate: both sides are f32, so
# disagreements come only from grazing rays and operation order)
HIT_AGREE_MIN = 0.999
T_REL_P99_MAX = 1e-4
PRIM_MATCH_MIN = 0.999
ORACLE_RAYS = 4096
# engine vs frame oracle: tests/test_golden.py's bounds
RMSE_ONE_BOUNCE = 2.0
RMSE_GI = 3.0


class GateError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit, read by a child that does not
    import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{dev.platform!r} ({dev.device_kind}); nothing "
                         f"was measured")
    return dev


# ------------------------------------------------------------- oracle


def brute_force(o, d, v0, e1, e2, tmin, tmax, chunk=8192):
    """Closest hit of every ray over the whole triangle soup, chunked
    over triangles under lax.scan.  Returns (t [N], tri [N])."""
    import jax
    import jax.numpy as jnp
    from radiance_tpu.ops.intersect import FLT_MAX, intersect_triangle_soup

    n_tri = v0.shape[0]
    chunk = min(chunk, n_tri)
    pad = (-n_tri) % chunk
    # zero triangles have det == 0 and never hit
    tri = [jnp.concatenate([x, jnp.zeros((pad, 3), x.dtype)])
           .reshape(-1, chunk, 3) for x in (v0, e1, e2)]
    base = jnp.arange(tri[0].shape[0], dtype=jnp.int32) * chunk

    def body(carry, xs):
        t_best, i_best = carry
        cv0, ce1, ce2, b = xs
        t, idx, _, _ = intersect_triangle_soup(o, d, cv0, ce1, ce2,
                                               tmin, tmax)
        better = t < t_best
        return (jnp.where(better, t, t_best),
                jnp.where(better, idx + b, i_best)), None

    n = o.shape[0]
    init = (jnp.full(n, FLT_MAX, jnp.float32), jnp.full(n, -1, jnp.int32))
    with jax.default_matmul_precision("highest"):
        (t, i), _ = jax.lax.scan(body, init, (*tri, base))
    return t, i


def compare(t_got, prim_got, t_ref, prim_ref) -> dict:
    """Hit/miss agreement, p99 relative t error and primID match on the
    shared hits of two closest-hit records (host arrays)."""
    fmax = np.float32(3.4e38)
    hg, hr = t_got < fmax, t_ref < fmax
    both = hg & hr
    if both.any():
        rel = (np.abs(t_got[both] - t_ref[both])
               / np.maximum(np.abs(t_ref[both]), 1e-6))
        t_p99 = float(np.quantile(rel, 0.99))
        prim = float(np.mean(prim_got[both] == prim_ref[both]))
    else:
        t_p99, prim = 0.0, 1.0
    return {"rays": int(len(t_got)), "hit_frac": float(hr.mean()),
            "hit_agree": float(np.mean(hg == hr)), "t_rel_p99": t_p99,
            "prim_match": prim}


def gate_failures(stats: dict, any_hit: bool = False) -> list:
    fails = []
    if stats["hit_agree"] < HIT_AGREE_MIN:
        fails.append(f"hit agreement {stats['hit_agree']:.5f} < "
                     f"{HIT_AGREE_MIN}")
    if not any_hit:
        if stats["t_rel_p99"] > T_REL_P99_MAX:
            fails.append(f"t rel p99 {stats['t_rel_p99']:.3e} > "
                         f"{T_REL_P99_MAX}")
        if stats["prim_match"] < PRIM_MATCH_MIN:
            fails.append(f"primID match {stats['prim_match']:.5f} < "
                         f"{PRIM_MATCH_MIN}")
    return fails


def oracle_subset(n: int, live: np.ndarray, k: int = ORACLE_RAYS):
    """Spread-out indices: k over all lanes plus k over the live ones."""
    idx = np.linspace(0, n - 1, k).astype(np.int64)
    live_idx = np.nonzero(live)[0]
    if len(live_idx):
        idx = np.concatenate([idx, live_idx[np.linspace(
            0, len(live_idx) - 1, k).astype(np.int64)]])
    return np.unique(idx)


# ------------------------------------------------------------- phases


def phase_scene(n_tris: int):
    from radiance_tpu.scene import bench_scenes
    verts, tris = bench_scenes.city_geometry(n_tris)
    scene, info = bench_scenes.build_scene(verts, tris)
    log(f"[b] scene city tris={len(tris)} nodes={info['nodes']} "
        f"build_s={info['build_s']:.3f} (set-up) "
        f"builder={'native C++ SAH' if info['native'] else 'NumPy SAH'} "
        f"device_bytes={info['device_bytes']}")
    return scene, verts, tris


def _waves(scene, verts, tris, w, h, kind):
    """Device arrays of the three waves: primary camera rays, shadow
    rays from the primary hits toward the light, and GGX-sampled bounce
    rays off the primary hits.  Lanes whose primary missed keep the
    camera ray, so every lane is a real ray."""
    import jax
    import jax.numpy as jnp
    from radiance_tpu.core import math as rmath
    from radiance_tpu.ops import traversal
    from radiance_tpu.scene import bench_scenes
    from radiance_tpu.shading import pbr

    o, d = (jnp.asarray(x) for x in bench_scenes.camera_rays(kind, w, h))
    tv = verts[tris.astype(np.int64)]
    fn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    fn = jnp.asarray((fn / np.maximum(np.linalg.norm(
        fn, axis=-1, keepdims=True), 1e-20)).astype(np.float32))
    light = jnp.asarray(bench_scenes.light_vec(kind))

    @jax.jit
    def primary(scn, o, d):
        return traversal.trace_rays(scn, o, d, 1e-3, 1e4)

    @jax.jit
    def secondary(o, d, t, prim):
        hit = t < 3e38
        n = fn[jnp.clip(prim, 0)]
        n = jnp.where(rmath.dot(n, d, keepdims=True) > 0, -n, n)
        p = o + jnp.where(hit, t, 0.0)[:, None] * d + n * 1e-3
        o2 = jnp.where(hit[:, None], p, o)
        idx = jnp.arange(o.shape[0], dtype=jnp.uint32)
        rnd = rmath.pcg3d(jnp.stack([idx, idx * 0 + 7, idx * 0 + 1], -1))
        nn = o.shape[0]
        l_b, _ = pbr.sample_microfacet_brdf(
            -d, n, jnp.full((nn, 3), 0.7, jnp.float32),
            jnp.zeros(nn, jnp.float32), jnp.full(nn, 0.6, jnp.float32),
            rnd)
        d_b = jnp.where(hit[:, None], rmath.normalize(l_b, 1e-30), d)
        d_s = jnp.broadcast_to(light, o.shape)
        return o2, d_s, d_b, hit

    rec = primary(scene, o, d)
    o2, d_s, d_b, hit = secondary(o, d, rec.t, rec.prim)
    return {"primary": (o, d, rec), "shadow": (o2, d_s),
            "bounce": (o2, d_b), "live": hit}


def phase_traversal(scene, verts, tris, w, h, k=ORACLE_RAYS, kind="city"):
    """(c): the three waves through traversal.trace_rays under jit,
    a spread-out subset of each against brute force on the device.
    kind names the bench camera and light (bench_scenes)."""
    import jax
    import jax.numpy as jnp
    from radiance_tpu.ops import traversal

    t0 = time.perf_counter()
    waves = _waves(scene, verts, tris, w, h, kind)
    closest = jax.jit(lambda s, o, d: traversal.trace_rays(
        s, o, d, 1e-3, 1e4))
    occl = jax.jit(lambda s, o, d: traversal.trace_rays(
        s, o, d, 1e-3, 1e4, any_hit_terminate=True))
    tv = verts[tris.astype(np.int64)].astype(np.float32)
    v0 = jnp.asarray(tv[:, 0])
    e1 = jnp.asarray(tv[:, 1] - tv[:, 0])
    e2 = jnp.asarray(tv[:, 2] - tv[:, 0])
    bf = jax.jit(lambda o, d: brute_force(o, d, v0, e1, e2, 1e-3, 1e4))
    live = np.asarray(waves["live"])
    sub = jnp.asarray(oracle_subset(w * h, live, k))
    results = {}
    fails = []
    for name in ("primary", "shadow", "bounce"):
        if name == "primary":
            o, d, rec = waves["primary"]
        else:
            o, d = waves[name]
            rec = (occl if name == "shadow" else closest)(scene, o, d)
        rec = jax.block_until_ready(rec)
        t_ref, i_ref = bf(o[sub], d[sub])
        t_got = np.asarray(rec.t)[np.asarray(sub)]
        prim_got = np.asarray(rec.prim)[np.asarray(sub)]
        # primID of the city soup is the triangle index
        st = compare(t_got, prim_got, np.asarray(t_ref), np.asarray(i_ref))
        st["wave_rays"] = int(w * h)
        results[name] = st
        f = gate_failures(st, any_hit=(name == "shadow"))
        fails += [f"{name}: {x}" for x in f]
        log(f"[c] traverse {name:7s} rays={w * h} oracle_rays={st['rays']} "
            f"hit_frac={st['hit_frac']:.4f} hit_agree={st['hit_agree']:.5f} "
            f"t_rel_p99={st['t_rel_p99']:.3e} prim={st['prim_match']:.5f} "
            f"{'FAIL' if f else 'ok'}")
    log(f"[c] traverse wall_s={time.perf_counter() - t0:.2f} "
        f"(compile included)")
    if fails:
        raise GateError("; ".join(fails))
    return results


def phase_engine(size: int = 64):
    """(d): Cornell frames at size^2 against the NumPy frame oracle."""
    import jax.numpy as jnp
    from radiance_tpu.api.sbt import ShaderBindingTable
    from radiance_tpu.core import types
    from radiance_tpu.engine import shaders
    from radiance_tpu.engine.frame_oracle import oracle_render
    from radiance_tpu.engine.pathtracer import WavefrontPathTracer
    from radiance_tpu.scene import procedural
    from radiance_tpu.shading import camera

    cornell = procedural.cornell_box()
    sbt = ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                       shaders.SHADER_REGISTRY)
    tracer = WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen, sbt=sbt)
    cam = types.PhysicalCamera(
        width_pixel=float(size), height_pixel=float(size),
        focal_length=0.035, sensor_width=0.05, focal_distance=8.0,
        f_stop=0.0, x=0.0, y=0.0, z=4.0, wx=0.0, wy=0.0, wz=0.0)
    cam_d = {k: np.float32(getattr(cam, k)) for k in (
        "width_pixel", "height_pixel", "focal_length", "sensor_width",
        "focal_distance", "f_stop", "x", "y", "z", "wx", "wy", "wz")}
    res = dict(cornell.resources)
    res["camera"] = camera.camera_params(cam)
    scene = cornell.device_scene()
    out = {}
    fails = []
    for depth, bound, lsb in ((1, RMSE_ONE_BOUNCE, 8), (2, RMSE_GI, 12)):
        accum = jnp.zeros((size * size, 3), jnp.float32)
        _, image = tracer.render(scene, res, accum, 0, size, size,
                                 batch=2, depth=depth)
        img = np.asarray(image)[..., :3].astype(np.int32)
        with np.errstate(all="ignore"):    # miss lanes carry FLT_MAX
            ref = oracle_render(cornell.resources, cam_d, batch=2,
                                depth=depth, W=size, H=size).astype(np.int32)
        diff = (img - ref).astype(np.float64)
        rmse = float(np.sqrt(np.mean(diff ** 2)))
        bad = float((np.abs(diff) > lsb).mean())
        ok = rmse < bound and bad < 0.01 * depth
        out[depth] = {"rmse": rmse, "frac_bad": bad}
        if not ok:
            fails.append(f"depth {depth}: rmse {rmse:.3f} (bound {bound}), "
                         f"frac>|{lsb}| {bad:.4f}")
        log(f"[d] engine cornell {size}x{size} batch=2 depth={depth} "
            f"rmse={rmse:.4f} bound={bound} frac_bad={bad:.5f} "
            f"{'ok' if ok else 'FAIL'}")
    if fails:
        raise GateError("engine vs frame oracle: " + "; ".join(fails))
    return out


def time_frames(tracer, scene, res, w, h, *, batch, depth, frames=3):
    """Compile-and-run once, then time `frames` progressive frames to
    block_until_ready.  Returns (compile_s, [frame_s], accum)."""
    import jax
    import jax.numpy as jnp

    accum = jnp.zeros((w * h, 3), jnp.float32)
    t0 = time.perf_counter()
    accum, image = tracer.render(scene, res, accum, 0, w, h,
                                 batch=batch, depth=depth)
    jax.block_until_ready((accum, image))
    compile_s = time.perf_counter() - t0
    times = []
    ts = batch
    for _ in range(frames):
        t0 = time.perf_counter()
        accum, image = tracer.render(scene, res, accum, ts, w, h,
                                     batch=batch, depth=depth)
        jax.block_until_ready((accum, image))
        times.append(time.perf_counter() - t0)
        ts += batch
    return compile_s, times, accum


def check_accum(accum, what: str):
    a = np.asarray(accum)
    if not np.isfinite(a).all():
        raise GateError(f"{what}: accumulation has non-finite values")
    if not a.std() > 0:
        raise GateError(f"{what}: accumulation is constant")
    return a


def phase_frame(scene, verts, tris, w, h, batch=4, depth=4, frames=3):
    """(e): the full-size frame through WavefrontPathTracer.render."""
    import jax
    from radiance_tpu.scene import bench_scenes

    tracer, res = bench_scenes.engine_setup(verts, tris, w, h)
    compile_s, times, accum = time_frames(tracer, scene, res, w, h,
                                          batch=batch, depth=depth,
                                          frames=frames)
    a = check_accum(accum, "frame")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"[e] frame city {w}x{h} batch={batch} depth={depth} "
        f"compile_plus_first_frame_s={compile_s:.2f} (set-up) "
        f"frame_ms_median={1e3 * float(np.median(times)):.1f} "
        f"frame_ms={[round(1e3 * t, 1) for t in times]} "
        f"peak_bytes_in_use={peak} accum_finite=True accum_nonconstant=True "
        f"accum_mean={a.mean():.6f} accum_std={a.std():.6f}")
    return {"compile_s": compile_s, "frame_s": times, "peak": peak}


def phase_multi(scene, verts, tris, w, h, batch=1, depth=4, n_dev=4):
    """(f): pixel sharding (whole frame and per wave) and sample parallelism
    on an n_dev mesh against one-card frames."""
    import jax
    import jax.numpy as jnp
    from radiance_tpu.parallel import sharding
    from radiance_tpu.scene import bench_scenes

    if len(jax.devices()) < n_dev:
        raise GateError(f"--multi needs {n_dev} devices, found "
                        f"{len(jax.devices())}")
    tracer, res = bench_scenes.engine_setup(verts, tris, w, h)
    n = w * h
    mesh = sharding.make_mesh(n_dev)
    pix = jnp.arange(n, dtype=jnp.int32)
    acc0 = jnp.zeros((n, 3), jnp.float32)

    def timed(fn):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, first, time.perf_counter() - t0

    (one, _), c1, t1 = timed(lambda: tracer.render(
        scene, res, acc0, 0, w, h, batch=batch, depth=depth))
    one = check_accum(one, "one-card frame")
    log(f"[f] one-card {w}x{h} batch={batch} depth={depth} "
        f"first_s={c1:.2f} frame_ms={1e3 * t1:.1f}")
    fails = []
    for name, make in (("shard_frame", sharding.shard_frame),
                       ("staged_shard_frame", sharding.staged_shard_frame)):
        fn = make(tracer, mesh, batch=batch, depth=depth)
        (acc, _img), c, t = timed(lambda: fn(scene, res, acc0,
                                             jnp.uint32(0), pix))
        a = check_accum(acc, name)
        diff = np.abs(a - one)
        px_diff = float((diff.max(axis=-1) > 1e-3).mean())
        log(f"[f] {name} devices={n_dev} first_s={c:.2f} "
            f"frame_ms={1e3 * t:.1f} max_abs_diff={diff.max():.3e} "
            f"frac_pixels_diff_gt_1e-3={px_diff:.2e}")
        if px_diff > 1e-3:
            fails.append(f"{name}: {px_diff:.2e} of pixels differ")
    (ref4, _), _, _ = timed(lambda: tracer.render(
        scene, res, acc0, 0, w, h, batch=n_dev * batch, depth=depth))
    ref4 = check_accum(ref4, f"one-card batch {n_dev * batch}")
    fn = sharding.sample_parallel_frame(tracer, mesh, batch=batch,
                                        depth=depth)
    (acc, _img), c, t = timed(lambda: fn(scene, res, acc0, jnp.uint32(0),
                                         pix))
    a = check_accum(acc, "sample_parallel_frame")
    rmse = float(np.sqrt(np.mean((a - ref4) ** 2)))
    rel = rmse / float(np.sqrt(np.mean(ref4 ** 2)))
    log(f"[f] sample_parallel_frame devices={n_dev} first_s={c:.2f} "
        f"frame_ms={1e3 * t:.1f} rmse_vs_one_card_batch{n_dev * batch}="
        f"{rmse:.3e} relative={rel:.3e}")
    if rel > 1e-3:
        fails.append(f"sample_parallel_frame: relative rmse {rel:.3e}")
    if fails:
        raise GateError("; ".join(fails))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded frames")
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)

    dev = require_gpu()
    card = card_line()
    import jax
    log(f"[a] card {card}")
    log(f"[a] jax device_kind={dev.device_kind} platform={dev.platform} "
        f"count={len(jax.devices())} jax={jax.__version__}")
    t_all = time.perf_counter()
    scene, verts, tris = phase_scene(args.tris)
    w, h = args.width, args.height
    if args.multi:
        phase_multi(scene, verts, tris, w, h)
    else:
        phase_traversal(scene, verts, tris, w, h)
        phase_engine(64)
        phase_frame(scene, verts, tris, w, h)
    log(f"[z] wall_s={time.perf_counter() - t_all:.1f}")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
