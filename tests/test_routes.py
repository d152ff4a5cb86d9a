"""Wave tracing in the engine, the traced path's arithmetic, and
compile-cache placement.

Every wave traces through the XLA walk.  The primary wave traces as it
is; bounce and shadow waves sort their live rays to the front and park
the dead ones (_traced_wavefront), which must not change any live ray's
hit.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radiance_tpu.api.sbt import ShaderBindingTable
from radiance_tpu.core import types
from radiance_tpu.engine import pathtracer, shaders
from radiance_tpu.engine.pathtracer import WavefrontPathTracer
from radiance_tpu.ops import compaction, traversal
from radiance_tpu.ops.intersect import FLT_MAX
from radiance_tpu.scene import procedural
from radiance_tpu.shading import camera

from test_traversal import gen_rays
from test_walk_oracle import scene_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tracer():
    sbt = ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                       shaders.SHADER_REGISTRY)
    return WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen, sbt=sbt)


def _cornell_frame_inputs(size):
    cornell = procedural.cornell_box()
    res = dict(cornell.resources)
    res["camera"] = camera.camera_params(types.PhysicalCamera(
        width_pixel=float(size), height_pixel=float(size),
        focal_length=0.035, sensor_width=0.05, focal_distance=8.0,
        f_stop=0.0, z=4.0))
    return cornell.device_scene(), res


@pytest.mark.parametrize("live", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("scene", ["random", "tlas2", "tlas9"])
def test_compacted_wave_matches_plain_trace(scene, live):
    """Sorting live rays to the front returns the plain walk's record on
    live lanes and a miss on dead ones, for single- and multi-instance
    scenes, with no lane, some or all of them alive."""
    _, ds, _ = scene_bundle(scene)
    rng = np.random.default_rng(4)
    o, d = (jnp.asarray(x) for x in gen_rays(rng, 300, spread=10.0))
    alive = jnp.asarray(rng.uniform(size=300) < live)
    plain = traversal.trace_rays(ds, o, d, 1e-3, 1e3)
    got = jax.jit(lambda o, d, a: pathtracer._traced_wavefront(
        ds, o, d, 1e-3, 1e3, a))(o, d, alive)
    am = np.asarray(alive)
    for f in ("t", "prim", "slot", "b1", "b2"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[am],
                                      np.asarray(getattr(plain, f))[am],
                                      err_msg=f)
    assert np.all(np.asarray(got.t)[~am] == FLT_MAX)
    assert np.all(np.asarray(got.slot)[~am] == -1)


def test_primary_wave_skips_compaction_without_changing_the_step():
    """With every lane alive (the primary wave), tracing uncompacted and
    tracing through the sort give the same engine step."""
    n = 12 * 12
    scene, res = _cornell_frame_inputs(12)
    tracer = _tracer()
    pix = jnp.arange(n, dtype=jnp.int32)
    fid = jnp.uint32(0)
    init = pathtracer._sample_init(tracer, res, pix, fid, fid)
    steps = [jax.jit(lambda st, p=p: pathtracer._sample_step(
        tracer, scene, res, pix, fid, jnp.int32(0), st, debug=0,
        hit_offset=tracer.hit_offset, miss_index=tracer.miss_index,
        primary=p))(init) for p in (True, False)]
    for a, b in zip(*steps):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tracer_has_no_route_options():
    """One engine path: the tracer takes no scheduler or dead-lane
    option, and naming one is an error."""
    fields = {f.name for f in dataclasses.fields(WavefrontPathTracer)}
    assert not fields & {"scheduler", "dead_lanes"}
    with pytest.raises(TypeError):
        dataclasses.replace(_tracer(), dead_lanes="park")


def test_coherence_key_groups_octants():
    o = jnp.zeros((4, 3), jnp.float32)
    d = jnp.asarray(np.array([
        [1, 1, 1], [-1, 1, 1], [1, -1, 1], [1, 1, -1]], np.float32))
    k = np.asarray(compaction.coherence_key(o, d))
    assert len(set(k >> 28)) == 4  # four distinct octants
    assert (k >= 0).all()          # no int32 overflow


def test_no_f32_dot_on_the_traced_path():
    """The walk and the engine frame compute with explicit multiply-adds,
    so TF32 cannot enter an intersection test or a transform: no
    dot_general in either jaxpr."""
    _, ds, _ = scene_bundle("tlas2")
    o, d = (jnp.asarray(x) for x in gen_rays(np.random.default_rng(0),
                                             8, spread=4.0))
    jaxpr = str(jax.make_jaxpr(lambda o, d: traversal.trace_rays(
        ds, o, d, 1e-3, 1e3))(o, d))
    assert "dot_general" not in jaxpr
    n = 16
    scene, res = _cornell_frame_inputs(4)
    frame = _tracer().frame_fn(batch=1, depth=2)
    jaxpr = str(jax.make_jaxpr(frame)(
        scene, res, jnp.zeros((n, 3), jnp.float32),
        jnp.uint32(0), jnp.arange(n, dtype=jnp.int32)))
    assert "dot_general" not in jaxpr


# ------------------------------------------------------- compile cache

_CACHE_PROBE = r"""
import sys
sys.path.insert(0, {repo!r})
import radiance_tpu, jax, jax.numpy as jnp
print(radiance_tpu.COMPILE_CACHE_DIR)
print(jax.config.jax_compilation_cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(7.0)).block_until_ready()
"""


def _probe(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c",
                          _CACHE_PROBE.format(repo=REPO)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split("\n")[:2]


def test_compile_cache_follows_env(tmp_path):
    cache = tmp_path / "cache"
    ours, jax_dir = _probe(cache, tmp_path)
    assert ours == jax_dir == str(cache)
    assert any(cache.iterdir()), "no compiled entry landed in the cache"


def test_compile_cache_default_is_fixed_repo_dir(tmp_path):
    ours, jax_dir = _probe(None, tmp_path)
    want = os.path.join(REPO, ".bench_cache", "xla_cache")
    assert ours == jax_dir == want
