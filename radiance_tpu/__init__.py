"""radiance_tpu: a JAX/XLA ray tracing framework.

A from-scratch rebuild of the capabilities of the OpenCL "Radiance" framework
(Vulkan-RT-style API: TLAS/BLAS acceleration structures, SBT shader dispatch,
TraceRays) as a wavefront path tracer compiled by XLA.

Public API mirrors the reference's `RD::` namespace (reference:
/root/reference/radiance/include/radiance.h) while the implementation is
wavefront-first: SoA ray/scene arrays, vectorized two-level BVH traversal
under `jax.jit`, and device-resident progressive accumulation.
"""

import os as _os

import jax as _jax


def _repo_cache_dir() -> str:
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".bench_cache", "xla_cache")


def _configure_compile_cache() -> str:
    """Persistent XLA compilation cache: JAX_COMPILATION_CACHE_DIR when
    set (JAX reads it itself; nothing else is configured), otherwise a
    fixed directory in the checkout.  The path is part of the cache
    key, so it must not move between runs."""
    # cache anything that took >= 2 s to compile (the default 1 s would
    # also cache hundreds of tiny test programs)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = _repo_cache_dir()
    _os.makedirs(path, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", path)
    return path


COMPILE_CACHE_DIR = _configure_compile_cache()

from radiance_tpu import config
from radiance_tpu.core import math as rmath
from radiance_tpu.core import types

__version__ = "0.1.0"

# Re-export the RD-style platform API lazily to keep import light.
def __getattr__(name):
    import importlib

    _api_names = {
        "Platform", "CreateBuffer", "CreateImage", "CreateImageArray",
        "CreateSampler", "ReadBuffer", "WriteBuffer", "ReadImage",
        "WriteImage",
    }
    _pipeline_names = {
        "CreateShaderModule", "CreatePipeline", "CreateDescriptorSet",
        "CreatePipelineLayout", "BindPipeline", "BindDescriptorSet",
        "TraceRays",
    }
    _as_names = {
        "BuildAccelStruct", "TopAccelStructToFile", "FileToTopAccelStruct",
    }
    if name in _api_names:
        return getattr(importlib.import_module("radiance_tpu.api.platform"), name)
    if name in _pipeline_names:
        return getattr(importlib.import_module("radiance_tpu.api.pipeline"), name)
    if name in _as_names:
        return getattr(importlib.import_module("radiance_tpu.api.accel"), name)
    raise AttributeError(f"module 'radiance_tpu' has no attribute {name!r}")
