"""End-to-end wavefront path tracer tests (sample1 capability parity)."""

import numpy as np
import jax.numpy as jnp
import pytest

from radiance_tpu.api.sbt import ShaderBindingTable
from radiance_tpu.core import types
from radiance_tpu.engine import shaders
from radiance_tpu.engine.pathtracer import WavefrontPathTracer
from radiance_tpu.ops import tonemap
from radiance_tpu.scene import procedural
from radiance_tpu.shading import camera


W = H = 64


@pytest.fixture(scope="module")
def cornell():
    return procedural.cornell_box()


@pytest.fixture(scope="module")
def tracer():
    sbt = ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                       shaders.SHADER_REGISTRY)
    return WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen, sbt=sbt)


def make_resources(cornell, debug=0):
    cam = types.PhysicalCamera(
        width_pixel=float(W), height_pixel=float(H),
        focal_length=0.035, sensor_width=0.05,
        focal_distance=8.0, f_stop=0.0,
        x=0.0, y=0.0, z=4.0, wx=0.0, wy=0.0, wz=0.0)
    res = dict(cornell.resources)
    res["camera"] = camera.camera_params(cam)
    return res


def render(tracer, cornell, *, batch=1, depth=2, debug=0, total_samples=0,
           accum=None):
    res = make_resources(cornell)
    if accum is None:
        accum = jnp.zeros((W * H, 3), jnp.float32)
    return tracer.render(cornell.device_scene(), res, accum, total_samples,
                         W, H, batch=batch, depth=depth, debug=debug)


def test_frame_renders(tracer, cornell):
    accum, image = render(tracer, cornell, batch=1, depth=2)
    image = np.asarray(image)
    assert image.shape == (H, W, 4) and image.dtype == np.uint8
    assert (image[..., 3] == 255).all()
    # background color where rays exit the open side: ACES+gamma of (.2,.2,.5)
    bg = np.asarray(tonemap.quantize_rgba8(
        tonemap.tonemap_sample1(jnp.asarray([[0.2, 0.2, 0.5]]))))[0]
    corner = image[0, 0]  # top-left: above/behind the box opening... may hit ceiling
    # at least some pixels show background and some show geometry
    flat = image[..., :3].reshape(-1, 3)
    n_bg = (flat == bg[:3]).all(-1).sum()
    assert n_bg < flat.shape[0]  # not everything background
    # center of image hits the back wall (non-background)
    assert not (image[H // 2, W // 2, :3] == bg[:3]).all()
    # image is not constant
    assert flat.std(axis=0).max() > 5


def test_debug_normals(tracer, cornell):
    accum, image = render(tracer, cornell, batch=1, depth=1, debug=1)
    image = np.asarray(image)
    # center hits the back wall: normal +z -> color ~ (0.5, 0.5, 1.0) * 255
    c = image[H // 2, W // 2, :3].astype(float) / 255.0
    np.testing.assert_allclose(c, [0.5, 0.5, 1.0], atol=0.03)
    # left edge center hits red wall (normal +x): ~(1.0, 0.5, 0.5)
    l = image[H // 2, 1, :3].astype(float) / 255.0
    np.testing.assert_allclose(l, [1.0, 0.5, 0.5], atol=0.03)
    # floor pixels (bottom center): normal +y -> (0.5, 1.0, 0.5)
    f = image[H - 2, W // 2, :3].astype(float) / 255.0
    np.testing.assert_allclose(f, [0.5, 1.0, 0.5], atol=0.03)


def test_debug_albedo(tracer, cornell):
    accum, image = render(tracer, cornell, batch=1, depth=1, debug=8)
    image = np.asarray(image)
    # left wall red albedo
    l = image[H // 2, 1, :3].astype(float) / 255.0
    np.testing.assert_allclose(l, [0.65, 0.05, 0.05], atol=0.03)
    r = image[H // 2, W - 2, :3].astype(float) / 255.0
    np.testing.assert_allclose(r, [0.12, 0.45, 0.15], atol=0.03)


def test_progressive_accumulation(tracer, cornell):
    # frame 1: totalSamples=0 resets scratch; frame 2 averages into it
    accum1, img1 = render(tracer, cornell, batch=2, depth=2, total_samples=0)
    accum2, img2 = render(tracer, cornell, batch=2, depth=2, total_samples=2,
                          accum=accum1)
    a1, a2 = np.asarray(accum1), np.asarray(accum2)
    assert not np.allclose(a1, a2)  # new samples changed the average
    # averaging shrinks changes: |a2 - a1| <= |sample contribution|
    # deterministic: re-render frame 1 identically
    accum1b, img1b = render(tracer, cornell, batch=2, depth=2, total_samples=0)
    np.testing.assert_array_equal(a1, np.asarray(accum1b))
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img1b))


def test_direct_light_shadowing(tracer, cornell):
    """The region behind the tall box (relative to the light) is dimmer."""
    accum, image = render(tracer, cornell, batch=4, depth=1)
    image = np.asarray(image).astype(float)
    # light comes from (0.3, -1, 0.4) direction => floor lit from above
    # floor far from boxes should be brighter than ambient-only areas
    lum = image[..., :3].mean(-1)
    assert lum.std() > 4  # meaningful shading variation


@pytest.mark.slow
def test_convergence_more_samples_less_noise(tracer, cornell):
    accum4, _ = render(tracer, cornell, batch=4, depth=3)
    accum16, _ = render(tracer, cornell, batch=16, depth=3)
    # local pixel variance in flat regions decreases with samples
    a4 = np.asarray(accum4).reshape(H, W, 3)
    a16 = np.asarray(accum16).reshape(H, W, 3)
    patch4 = a4[H // 2 - 4:H // 2 + 4, W // 2 - 4:W // 2 + 4]
    patch16 = a16[H // 2 - 4:H // 2 + 4, W // 2 - 4:W // 2 + 4]
    assert patch16.std() <= patch4.std() * 1.2  # generally less noisy


@pytest.mark.slow
def test_debug_modes_11_17(tracer, cornell):
    """BRDF-term probes (reference: shader.cl:663-714): each mode renders,
    is deterministic, differs from the lit render, and geometry pixels
    stay in a sane display range."""
    _, lit = render(tracer, cornell, batch=1, depth=1, debug=0)
    lit = np.asarray(lit)
    for d in range(11, 18):
        _, img = render(tracer, cornell, batch=1, depth=1, debug=d)
        img = np.asarray(img)
        assert img.shape == (H, W, 4)
        assert not np.array_equal(img, lit), f"debug {d} identical to lit"
        _, img2 = render(tracer, cornell, batch=1, depth=1, debug=d)
        np.testing.assert_array_equal(img, np.asarray(img2))
    # mode 13 (GGX D, clamped) and 12 (Fresnel) differ from each other
    _, d12 = render(tracer, cornell, batch=1, depth=1, debug=12)
    _, d13 = render(tracer, cornell, batch=1, depth=1, debug=13)
    assert not np.array_equal(np.asarray(d12), np.asarray(d13))


def test_make_context_single_instance_elides_gathers():
    """The ninst==1 static branch must produce the same context fields
    as the general gather path."""
    import jax.numpy as jnp
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_traversal import single_instance_scene as _single_instance_scene
    from radiance_tpu.engine import pathtracer
    from radiance_tpu.ops import traversal

    ds = _single_instance_scene(n_tris=64, seed=1)
    n = 32
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    d = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    hits = traversal.trace_rays(ds, o, d, 1e-3, 1e3)
    ctx = pathtracer._make_context(
        ds, hits, o, d, jnp.arange(n, dtype=jnp.int32),
        jnp.uint32(0), 0, {}, 0, None, None)
    # reference fields via the explicit gather math
    slot = jnp.clip(hits.slot, 0, ds.inst_id.shape[0] - 1)
    from radiance_tpu.core import math as rmath
    inv = ds.inst_inv[slot]
    o_l = rmath.mat4_transform_point(inv, o)
    d_l = rmath.mat4_transform_dir(inv, d)
    hp = o_l + hits.t[:, None] * d_l
    fin = np.isfinite(np.asarray(hp))
    np.testing.assert_allclose(np.asarray(ctx.hit_point)[fin],
                               np.asarray(hp)[fin], rtol=1e-6)
    assert ctx.instance_id.shape == (n,)
    np.testing.assert_array_equal(np.asarray(ctx.instance_id),
                                  np.asarray(ds.inst_id[slot]))
    np.testing.assert_array_equal(np.asarray(ctx.sbt_offset),
                                  np.asarray(ds.inst_sbt[slot]))


def test_progressive_frames_compose(tracer, cornell):
    """A batch larger than max_batch_per_dispatch is split over
    dispatches that compose exactly like progressive frames: a batch-4
    render in dispatches of 2 samples is the pair of batch-2 frames at
    totalSamples 0 and 2 (the seeds include totalSamples, as in the
    reference, so it is not the single batch-4 dispatch)."""
    import dataclasses
    a2, _ = render(tracer, cornell, batch=2, depth=2)
    a22, img22 = render(tracer, cornell, batch=2, depth=2,
                        total_samples=2, accum=a2)
    split = dataclasses.replace(tracer, max_batch_per_dispatch=2)
    a_sp, img_sp = render(split, cornell, batch=4, depth=2)
    np.testing.assert_array_equal(np.asarray(a_sp), np.asarray(a22))
    np.testing.assert_array_equal(np.asarray(img_sp), np.asarray(img22))
    a4, _ = render(tracer, cornell, batch=4, depth=2)
    assert not np.allclose(np.asarray(a4), np.asarray(a22))
