"""Texture image-array sampling.

Equivalent of the reference's OpenCL image2d_array + sampler
(reference: radiance.cpp:96-131 CreateImageArray/CreateSampler;
shader2.cl:255-265 read_imageui usage): a [T, H, W, 4] uint8 array sampled
with normalized coordinates, OpenCL addressing modes (clamp-to-edge,
clamp-to-border, repeat, mirrored-repeat) and nearest/linear filtering.

Returns float32 texel values in [0, 255] (the shaders divide by 255
themselves, shader2.cl:262-264).  Linear filtering of uint8 images is
undefined in OpenCL -- the reference requests it anyway
(sceneBuilder.cpp:42); we implement true bilinear as the superset.
"""

from __future__ import annotations

import jax.numpy as jnp

from radiance_tpu import config


def _address(coord, size, mode: int):
    """Apply an addressing mode to unnormalized pixel coords.

    coord: [...] float pixel-space coordinate; size: int dimension.
    Returns (index [...] int32, in_range [...] bool) -- in_range is False
    only for CLAMP (border) mode's out-of-range reads.
    """
    size_f = jnp.float32(size)
    if mode == config.ADDRESS_REPEAT:
        coord = coord - jnp.floor(coord / size_f) * size_f
        idx = jnp.clip(coord.astype(jnp.int32), 0, size - 1)
        return idx, jnp.ones_like(idx, bool)
    if mode == config.ADDRESS_MIRRORED_REPEAT:
        period = 2.0 * size_f
        m = coord - jnp.floor(coord / period) * period
        m = jnp.where(m >= size_f, period - m - 1.0, m)
        idx = jnp.clip(m.astype(jnp.int32), 0, size - 1)
        return idx, jnp.ones_like(idx, bool)
    if mode == config.ADDRESS_CLAMP:
        idx = coord.astype(jnp.int32)
        ok = (coord >= 0) & (coord < size_f)
        return jnp.clip(idx, 0, size - 1), ok
    # CLAMP_TO_EDGE (default)
    idx = jnp.clip(coord, 0.0, size_f - 1.0).astype(jnp.int32)
    return idx, jnp.ones_like(idx, bool)


def sample_image_array(tex: jnp.ndarray, u, v, layer,
                       addressing: int = config.ADDRESS_REPEAT,
                       filter_mode: int = config.FILTER_LINEAR) -> jnp.ndarray:
    """Sample a [T, H, W, C] uint8 image array with normalized coords.

    u/v: [...] normalized coordinates; layer: [...] int/float layer index
    (nearest layer, per OpenCL image arrays).
    Returns [..., C] float32 in [0, 255].
    """
    t, h, w = tex.shape[0], tex.shape[1], tex.shape[2]
    layer_idx = jnp.clip(jnp.round(jnp.asarray(layer, jnp.float32)).astype(jnp.int32), 0, t - 1)
    texf = tex.astype(jnp.float32)

    if filter_mode == config.FILTER_NEAREST:
        xi, okx = _address(u * w, w, addressing)
        yi, oky = _address(v * h, h, addressing)
        texel = texf[layer_idx, yi, xi]
        return jnp.where((okx & oky)[..., None], texel, 0.0)

    # bilinear: sample at u*w - 0.5 per OpenCL linear filtering rules
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]

    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, okx = _address(x0f + dx, w, addressing)
            yi, oky = _address(y0f + dy, h, addressing)
            texel = texf[layer_idx, yi, xi]
            texel = jnp.where((okx & oky)[..., None], texel, 0.0)
            wgt = (fx if dx else (1.0 - fx)) * (fy if dy else (1.0 - fy))
            out = out + wgt * texel
    return out


def read_imageui(tex, sampler: tuple, coord):
    """OpenCL-shaped entry: coord [..., 4] = (u, v, layer, _); sampler =
    (addressing, filter).  Reference usage: shader2.cl:260-261."""
    addressing, filter_mode = sampler
    return sample_image_array(tex, coord[..., 0], coord[..., 1], coord[..., 2],
                              addressing=addressing, filter_mode=filter_mode)
