"""Golden-image parity: the wavefront engine vs the independent NumPy
oracle of the reference frame loop (engine/frame_oracle.py; reference:
samples/shader.cl:175-305)."""

import numpy as np
import jax.numpy as jnp
import pytest

from radiance_tpu.api.sbt import ShaderBindingTable
from radiance_tpu.core import types
from radiance_tpu.engine import shaders
from radiance_tpu.engine.pathtracer import WavefrontPathTracer
from radiance_tpu.scene import procedural
from radiance_tpu.shading import camera

from radiance_tpu.engine.frame_oracle import oracle_render

W = H = 32


# ------------------------------------------------------------ tests


@pytest.fixture(scope="module")
def cornell():
    return procedural.cornell_box()


@pytest.fixture(scope="module")
def tracer():
    sbt = ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                       shaders.SHADER_REGISTRY)
    return WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen, sbt=sbt)


def _cam_dict():
    return dict(width_pixel=np.float32(W), height_pixel=np.float32(H),
                focal_length=np.float32(0.035),
                sensor_width=np.float32(0.05),
                focal_distance=np.float32(8.0), f_stop=np.float32(0.0),
                x=np.float32(0.0), y=np.float32(0.0), z=np.float32(4.0),
                wx=np.float32(0.0), wy=np.float32(0.0),
                wz=np.float32(0.0))


def _engine_render(tracer, cornell, batch, depth):
    cd = _cam_dict()
    cam = types.PhysicalCamera(
        width_pixel=float(W), height_pixel=float(H),
        focal_length=0.035, sensor_width=0.05, focal_distance=8.0,
        f_stop=0.0, x=0.0, y=0.0, z=4.0, wx=0.0, wy=0.0, wz=0.0)
    res = dict(cornell.resources)
    res["camera"] = camera.camera_params(cam)
    accum = jnp.zeros((W * H, 3), jnp.float32)
    _, image = tracer.render(cornell.device_scene(), res, accum, 0,
                             W, H, batch=batch, depth=depth)
    return np.asarray(image)[..., :3], cd


def test_golden_rmse_one_bounce(tracer, cornell):
    """batch=2, depth=1: direct light + shadows, deterministic modulo
    the shared PCG jitter."""
    img, cd = _engine_render(tracer, cornell, batch=2, depth=1)
    ref = oracle_render(cornell.resources, cd, batch=2, depth=1)
    diff = img.astype(np.int32) - ref.astype(np.int32)
    rmse = float(np.sqrt(np.mean(diff.astype(np.float64) ** 2)))
    frac_bad = float((np.abs(diff) > 8).mean())
    assert rmse < 2.0, f"RMSE {rmse:.2f} (frac>|8| {frac_bad:.4f})"
    assert frac_bad < 0.01


def test_golden_rmse_gi(tracer, cornell):
    """batch=2, depth=2: adds one GGX-importance-sampled GI bounce;
    both sides take identical sampling branches (bit-exact PCG3D)."""
    img, cd = _engine_render(tracer, cornell, batch=2, depth=2)
    ref = oracle_render(cornell.resources, cd, batch=2, depth=2)
    diff = img.astype(np.int32) - ref.astype(np.int32)
    rmse = float(np.sqrt(np.mean(diff.astype(np.float64) ** 2)))
    frac_bad = float((np.abs(diff) > 12).mean())
    assert rmse < 3.0, f"RMSE {rmse:.2f} (frac>|12| {frac_bad:.4f})"
    assert frac_bad < 0.02
