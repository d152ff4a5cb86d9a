"""Golden-image parity for sample0 and sample2 against independent
NumPy oracles (completing the sample0/1/2 triple; sample1-shaped
coverage lives in test_golden.py).

- sample0: one hardcoded triangle, bary-color closest hit, grey miss,
  identity tonemap (reference: radiance/src/main.cpp directGen /
  triangleHit; samples/sample0.cpp sketch).
- sample2: 9 translated instances of one BLAS, instanceIndex%3
  materials, bilinear-repeat texture albedo, shader2 BRDF direct
  light + shadow occlusion, Reinhard + gamma 0.4545 (reference:
  samples/sample2.cpp + samples/shader2.cl).

Both oracles trace brute-force Moller-Trumbore over every world
triangle (no BVH) and re-implement the shading/tonemap math straight
from the reference semantics, sharing the bit-exact PCG3D and BRDF
helpers of test_golden.
"""
import pytest

import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, os.pardir, "samples"))

from radiance_tpu.engine.frame_oracle import (
    F32, OracleScene, cross, dot, microfacet_brdf, normalize, pcg3d)


# ---------------------------------------------------------- sample0


def test_golden_sample0(tmp_path):
    import sample0

    size = 48
    img = sample0.main(size=size, out=str(tmp_path / "s0.png"))[..., :3]

    n = size * size
    pix = np.arange(n, dtype=np.int64)
    x = (pix % size).astype(np.float32)
    y = (pix // size).astype(np.float32)
    fx = (x + F32(0.5)) / F32(size) - F32(0.5)
    fy = F32(0.5) - (y + F32(0.5)) / F32(size)
    d = normalize(np.stack([fx, fy, np.full(n, -1.0, np.float32)], -1))
    o = np.tile(np.asarray([0.0, 0.0, 2.0], np.float32), (n, 1))

    v0 = np.asarray([-0.8, -0.6, 0.0], np.float32)
    e1 = np.asarray([0.8, -0.6, 0.0], np.float32) - v0
    e2 = np.asarray([0.0, 0.9, 0.0], np.float32) - v0
    pv = cross(d, e2[None])
    det = dot(e1[None], pv)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / det
    sv = o - v0
    b1 = inv * dot(sv, pv)
    qv = cross(sv, e1[None])
    b2 = inv * dot(d, qv)
    t = inv * dot(e2[None], qv)
    hit = ((det != 0) & (b1 >= 0) & (b1 <= 1) & (b2 >= 0)
           & (b1 + b2 <= 1) & (t > 1e-3) & (t < 1e4))

    color = np.where(hit[:, None],
                     np.stack([1.0 - b1 - b2, b1, b2], -1),
                     np.full((n, 3), 0.1, np.float32))
    ref = np.clip(np.floor(color * 255.0), 0, 255).astype(np.uint8)
    ref = ref.reshape(size, size, 3)

    diff = img.astype(np.int32) - ref.astype(np.int32)
    rmse = float(np.sqrt(np.mean(diff.astype(np.float64) ** 2)))
    assert rmse < 1.0, f"sample0 RMSE {rmse:.3f}"
    assert (np.abs(diff) > 1).mean() < 0.002


# ---------------------------------------------------------- sample2


def _bilinear_repeat(tex, u, v):
    """NumPy mirror of ops/texture.sample_image_array (bilinear +
    REPEAT addressing), layer fixed at 0 like material2."""
    h, w = tex.shape[0], tex.shape[1]
    texf = tex.astype(np.float32)
    x = u * np.float32(w) - np.float32(0.5)
    y = v * np.float32(h) - np.float32(0.5)
    x0f = np.floor(x)
    y0f = np.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]

    def address(coord, sz):
        szf = np.float32(sz)
        c = coord - np.floor(coord / szf) * szf
        return np.clip(c.astype(np.int32), 0, sz - 1)

    out = np.zeros(x.shape + (tex.shape[-1],), np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = address(x0f + dx, w)
            yi = address(y0f + dy, h)
            wgt = (fx if dx else (1.0 - fx)) * (fy if dy else (1.0 - fy))
            out = out + wgt * texf[yi, xi]
    return out


class _Sample2Oracle:
    def __init__(self, size, tex_dim):
        import sample2

        verts, tris, normals, uvs = sample2.default_mesh()
        tri_v, tri_n, tri_uv, tri_inst = [], [], [], []
        k = 0
        for dx in (0.0, 1.0, -1.0):
            for dy in (0.0, -1.0, -2.0):
                off = np.asarray([dx, dy, 0.0], np.float32)
                tri_v.append(verts[np.asarray(tris, np.int64)] + off)
                tri_n.append(normals[np.asarray(tris, np.int64)])
                tri_uv.append(uvs[np.asarray(tris, np.int64)][..., :2])
                tri_inst.append(np.full(len(tris), k, np.int64))
                k += 1
        self.v = np.concatenate(tri_v).astype(np.float32)   # [F,3,3]
        self.n = np.concatenate(tri_n).astype(np.float32)
        self.uv = np.concatenate(tri_uv).astype(np.float32)
        self.inst = np.concatenate(tri_inst)
        self.tex = sample2.checker_texture(
            tex_dim, (40, 80, 220), (200, 220, 255))        # layer 0
        self.metallic = np.asarray([0.0, 0.95, 0.0], np.float32)
        self.roughness = np.asarray([0.3, 0.1, 0.9], np.float32)
        self.light_dir = normalize(
            np.asarray([[0.2, -1.0, 0.5]], np.float32))[0]
        self.light_color = np.asarray([2.0, 2.0, 2.0], np.float32)
        self.size = size
        # brute-force tracer reuse: borrow OracleScene.trace via duck
        # typing (it only reads self.v)
        self.trace = OracleScene.trace.__get__(self)
        self.occluded = OracleScene.occluded.__get__(self)

    def render(self, batch):
        size = self.size
        n = size * size
        pix = np.arange(n, dtype=np.uint32)
        cam = np.asarray([0.0, -1.0, -10.0, 3.14], np.float32)
        acc = np.zeros((n, 3), np.float32)

        for s in range(batch):
            frame_id = np.uint32(s)
            rnd = pcg3d(np.stack([np.full(n, frame_id, np.uint32),
                                  np.zeros(n, np.uint32), pix], -1))
            xi = (pix % size).astype(np.float32)
            yi = (pix // size).astype(np.float32)
            fx = (xi + rnd[:, 0]) / F32(size) - F32(0.5)
            fy = F32(0.5) - (yi + rnd[:, 1]) / F32(size)
            d = normalize(np.stack(
                [fx, fy, np.full(n, -2.0, np.float32)], -1))
            th = cam[3]
            c0 = np.asarray([np.cos(th), 0.0, -np.sin(th)], np.float32)
            c1 = np.asarray([0.0, 1.0, 0.0], np.float32)
            c2 = np.asarray([np.sin(th), 0.0, np.cos(th)], np.float32)
            d = (d[:, 0:1] * c0 + d[:, 1:2] * c1 + d[:, 2:3] * c2
                 ).astype(np.float32)
            o = np.tile(cam[:3], (n, 1))

            t, face, b1, b2 = self.trace(o, d, tmin=0.01, tmax=1000.0)
            hit = face >= 0
            fc = np.maximum(face, 0)
            w0 = (1.0 - b1 - b2).astype(np.float32)
            nrm = normalize(self.n[fc, 0] * w0[:, None]
                            + self.n[fc, 1] * b1[:, None]
                            + self.n[fc, 2] * b2[:, None], 1e-30)
            uv = (self.uv[fc, 0] * w0[:, None]
                  + self.uv[fc, 1] * b1[:, None]
                  + self.uv[fc, 2] * b2[:, None]).astype(np.float32)
            albedo = _bilinear_repeat(self.tex, uv[:, 0],
                                      1.0 - uv[:, 1])[:, :3] / 255.0
            mat = self.inst[fc] % 3
            metallic = self.metallic[mat]
            # shader2 brdf floors roughness at 0.05 (pbr.brdf)
            roughness = np.maximum(
                np.clip(self.roughness[mat], 0.0, 1.0), 0.05)

            hp = (o + t[:, None] * d).astype(np.float32)
            origin = hp + nrm * np.float32(1e-4)
            v = normalize(cam[None, :3] - origin, 1e-30)
            l = np.tile(-self.light_dir, (n, 1))
            occ = self.occluded(origin, l, 0.01, 1000.0)
            lo = microfacet_brdf(l, v, nrm, albedo, metallic,
                                 roughness) * self.light_color
            color = np.where(occ[:, None], 0.0, lo) + albedo * 0.05
            color = np.where(hit[:, None], color,
                             np.asarray([0.2, 0.2, 0.5], np.float32))
            acc = acc + color

        acc = acc / np.float32(batch)
        # Reinhard + gamma 0.4545 + quantize (tonemap_sample2)
        rgb = np.power(acc / (1.0 + acc), 0.4545, dtype=np.float32)
        img = np.clip(np.floor(rgb * 255.0), 0, 255).astype(np.uint8)
        return img.reshape(size, size, 3)


@pytest.mark.slow
def test_golden_sample2(tmp_path):
    import sample2

    size, batch, tex_dim = 32, 2, 64
    img = sample2.render_sample2(
        size=size, batch=batch, depth=1, frames=1,
        out=str(tmp_path / "s2.png"), tex_dim=tex_dim)[..., :3]
    ref = _Sample2Oracle(size, tex_dim).render(batch)

    diff = img.astype(np.int32) - ref.astype(np.int32)
    rmse = float(np.sqrt(np.mean(diff.astype(np.float64) ** 2)))
    frac_bad = float((np.abs(diff) > 8).mean())
    assert rmse < 3.0, f"sample2 RMSE {rmse:.2f} (frac>|8| {frac_bad:.4f})"
    assert frac_bad < 0.02
