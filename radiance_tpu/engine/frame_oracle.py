"""Independent NumPy oracle of the reference frame loop.

generateRay -> traceRay -> material/environment -> accumulate ->
ACES+gamma, re-implemented straight from the reference semantics in
float32 NumPy (reference: samples/shader.cl:175-305): PCG3D-jittered
pinhole rays, brute-force Moller-Trumbore over every world triangle (no
BVH -- traversal independence), the sample1 material shader (direct
light + shadow ray + GGX importance-sampled GI with the same split-branch
layout), the running-average accumulation, and the ACES + gamma-0.7
quantization.  Bit-exact PCG3D means the engine and the oracle take
identical sampling branches, so images agree to float-drift tolerances.
Used by tests/test_golden.py and chip_smoke.py.
"""

import numpy as np

W = H = 32  # default frame size
PI = np.float32(3.14159265359)
F32 = np.float32


def pcg3d(v):
    v = v.astype(np.uint32) * np.uint32(1664525) + np.uint32(1013904223)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x ^= x >> np.uint32(16)
    y ^= y >> np.uint32(16)
    z ^= z >> np.uint32(16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    out = np.stack([x, y, z], -1)
    return out.astype(np.float32) / np.float32(0xFFFFFFFF)


def normalize(v, eps=0.0):
    n = np.sqrt(np.maximum(np.sum(v * v, -1, keepdims=True), F32(eps)))
    return (v / np.maximum(n, 1e-37)).astype(np.float32)


def dot(a, b, keepdims=False):
    return np.sum(a * b, -1, keepdims=keepdims).astype(np.float32)


def cross(a, b):
    return np.cross(a, b).astype(np.float32)


def local_frame(n):
    some = np.zeros_like(n)
    some[..., 0] = 1.0
    dd = dot(some, n)
    deft = np.zeros_like(n)
    deft[..., 1] = 1.0
    crossed = cross(some, n)
    use = (1.0 - np.abs(dd)) > 1e-6
    tangent = np.where(use[..., None], normalize(crossed, 1e-30), deft)
    bitangent = cross(n, tangent)
    return tangent.astype(np.float32), bitangent.astype(np.float32)


def transform_local(n, local):
    t, b = local_frame(n)
    return (local[..., 0:1] * t + local[..., 1:2] * b
            + local[..., 2:3] * n).astype(np.float32)


def f_schlick(cos_t, metallic, albedo):
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    p = np.power(np.maximum(1.0 - cos_t, 0.0), 5.0, dtype=np.float32)
    return (f0 + (1.0 - f0) * p[..., None]).astype(np.float32)


def d_ggx(nh, r):
    a = r * r
    a2 = a * a
    den = nh * nh * (a2 - 1.0) + 1.0
    return (a2 / (PI * den * den)).astype(np.float32)


def lambda_ggx(x, y, z, a):
    cos2 = z * z
    sin2 = np.maximum(0.0, 1.0 - cos2)
    with np.errstate(divide="ignore", invalid="ignore"):
        tan2 = sin2 / cos2
    st = np.sqrt(sin2)
    safe = np.where(st == 0.0, 1.0, st)
    cp = np.where(st == 0.0, 1.0, np.clip(x / safe, -1.0, 1.0))
    sp = np.where(st == 0.0, 0.0, np.clip(y / safe, -1.0, 1.0))
    a2 = (cp * a) ** 2 + (sp * a) ** 2
    lam = (np.sqrt(1.0 + a2 * tan2) - 1.0) / 2.0
    return np.where(np.isinf(tan2), 0.0, lam).astype(np.float32)


def g_pbrt(wo, wi, n, r):
    t, b = local_frame(n)
    ox, oy, oz = dot(wo, t), dot(wo, b), dot(wo, n)
    ix, iy, iz = dot(wi, t), dot(wi, b), dot(wi, n)
    g = 1.0 / (1.0 + lambda_ggx(ix, iy, iz, r)
               + lambda_ggx(ox, oy, oz, r))
    return np.where((iz < 0.0) | (oz < 0.0), 0.0, g).astype(np.float32)


def microfacet_brdf(l, v, n, albedo, metallic, roughness):
    h = normalize(v + l, 1e-30)
    nv = np.clip(dot(n, v), 0.0, 1.0)
    nl = np.clip(dot(n, l), 0.0, 1.0)
    nh = np.clip(dot(n, h), 0.0, 1.0)
    vh = np.clip(dot(v, h), 0.0, 1.0)
    f = f_schlick(vh, metallic, albedo)
    d = d_ggx(nh, roughness)
    g = g_pbrt(v, l, n, roughness)
    spec = f * (d * g / np.maximum(4.0 * nv * nl, 0.001))[..., None]
    notspec = (1.0 - f) * (1.0 - metallic[..., None])
    diff = notspec * (albedo / PI)
    return ((diff + spec) * nl[..., None]).astype(np.float32)


def diffuse_dir(n, rx, ry):
    theta = np.arccos(np.sqrt(ry))
    phi = 2.0 * PI * rx
    st, ct = np.sin(theta), np.cos(theta)
    local = np.stack([st * np.cos(phi), st * np.sin(phi), ct],
                     -1).astype(np.float32)
    return transform_local(n, local)


def ggx_half(n, r, rx, ry):
    a = r * r
    theta = np.arccos(np.sqrt((1.0 - ry) / (1.0 + (a * a - 1.0) * ry)))
    phi = 2.0 * PI * rx
    st, ct = np.sin(theta), np.cos(theta)
    local = np.stack([st * np.cos(phi), st * np.sin(phi), ct],
                     -1).astype(np.float32)
    return transform_local(n, local)


def reflect(vin, n):
    return (-vin + 2.0 * dot(vin, n, True) * n).astype(np.float32)


def sample_brdf(v, n, albedo, metallic, roughness, rnd):
    """Mirror of pbr.sample_microfacet_brdf_transm at transmission=0
    (the cornell materials): rz >= 0.5 -> specular else diffuse."""
    rx, ry, rz = rnd[..., 0], rnd[..., 1], rnd[..., 2]
    l_d = diffuse_dir(n, rx, ry)
    h_d = normalize(v + l_d, 1e-30)
    f_d = f_schlick(np.clip(dot(v, h_d), 0, 1), metallic, albedo)
    fac_d = ((1.0 - f_d) * (1.0 - metallic[..., None]) * albedo * 2.0)

    h_s = ggx_half(n, roughness, rx, ry)
    l_s = reflect(v, h_s)
    nv = np.clip(dot(n, v), 0, 1)
    nh = np.clip(dot(n, h_s), 0, 1)
    vh = np.clip(dot(v, h_s), 0, 1)
    g = g_pbrt(v, l_s, n, roughness)
    f_s = f_schlick(vh, metallic, albedo)
    fac_s = f_s * (g * vh / np.maximum(nh * nv, 0.001))[..., None] * 2.0

    spec = (rz >= 0.5)[..., None]
    return (np.where(spec, l_s, l_d).astype(np.float32),
            np.where(spec, fac_s, fac_d).astype(np.float32))


class OracleScene:
    """World triangles + per-face mesh/material info from the host
    resources (identity instances)."""

    def __init__(self, res):
        v = np.asarray(res["vertex_data"], np.float32)
        idx = np.asarray(res["index_data"], np.int64)
        nrm = np.asarray(res["normal_data"], np.float32)
        io = np.asarray(res["mesh_index_offset"], np.int64)
        vo = np.asarray(res["mesh_vertex_offset"], np.int64) \
            if "mesh_vertex_offset" in res else None
        no = np.asarray(res["mesh_normal_offset"], np.int64)
        nm = len(io)
        tri_v, tri_n, tri_mesh = [], [], []
        for m in range(nm):
            end = io[m + 1] if m + 1 < nm else len(idx)
            ids = idx[io[m]:end].reshape(-1, 3)
            base = no[m]
            for t in ids:
                tri_v.append([v[3 * t[k] + base:3 * t[k] + base + 3]
                              for k in range(3)])
                tri_n.append([nrm[3 * t[k] + base:3 * t[k] + base + 3]
                              for k in range(3)])
                tri_mesh.append(m)
        self.v = np.asarray(tri_v, np.float32)        # [F, 3, 3]
        self.n = np.asarray(tri_n, np.float32)
        self.mesh = np.asarray(tri_mesh, np.int64)
        self.mat = np.asarray(res["mesh_material_index"], np.int64)
        self.albedo = np.asarray(res["mat_albedo"], np.float32)[:, :3]
        self.metallic = np.asarray(res["mat_metallic"], np.float32)
        self.roughness = np.asarray(res["mat_roughness"], np.float32)
        self.light_dir = np.asarray(res["light_direction"],
                                    np.float32)[0, :3]
        self.light_color = np.asarray(res["light_color"],
                                      np.float32)[0, :3]

    def trace(self, o, d, tmin=1e-3, tmax=1000.0):
        """Brute-force closest hit: o, d [N, 3].  Returns (t, face,
        b1, b2); face -1 on miss."""
        v0 = self.v[:, 0]
        e1 = self.v[:, 1] - self.v[:, 0]
        e2 = self.v[:, 2] - self.v[:, 0]
        N, F = len(o), len(v0)
        t_best = np.full(N, np.float32(3.4028235e38))
        f_best = np.full(N, -1, np.int64)
        b1_best = np.zeros(N, np.float32)
        b2_best = np.zeros(N, np.float32)
        for f in range(F):
            pv = cross(d, e2[f])
            det = dot(e1[f][None], pv)
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / det
            sv = o - v0[f]
            b1 = inv * dot(sv, pv)
            qv = cross(sv, e1[f][None])
            b2 = inv * dot(d, qv)
            t = inv * dot(e2[f][None], qv)
            with np.errstate(over="ignore", invalid="ignore"):
                ok = ((det != 0.0) & (b1 >= 0) & (b1 <= 1) & (b2 >= 0)
                      & (b1 + b2 <= 1) & (t > tmin) & (t < tmax)
                      & (t < t_best))
            t_best = np.where(ok, t, t_best).astype(np.float32)
            f_best = np.where(ok, f, f_best)
            b1_best = np.where(ok, b1, b1_best).astype(np.float32)
            b2_best = np.where(ok, b2, b2_best).astype(np.float32)
        return t_best, f_best, b1_best, b2_best

    def occluded(self, o, d, tmin=1e-3, tmax=1000.0):
        t, f, _, _ = self.trace(o, d, tmin, tmax)
        return f >= 0


def oracle_render(res, cam, batch, depth, total_samples=0, W=W, H=H):
    """The reference frame loop (shader.cl:175-305) over a W x H image
    with a pinhole camera dict `cam`; returns u8 RGB [H, W, 3]."""
    sc = OracleScene(res)
    n = W * H
    pix = np.arange(n, dtype=np.uint32)
    scratch = np.zeros((n, 3), np.float32)
    l_dir = normalize(-sc.light_dir[None])[0]

    for s in range(batch):
        frame_id = np.uint32(total_samples + s)
        rnd = pcg3d(np.stack([np.full(n, frame_id, np.uint32),
                              np.full(n, total_samples, np.uint32),
                              pix], -1))
        xi = (pix % W).astype(np.float32)
        yi = (pix // W).astype(np.float32)
        fx = (xi + rnd[:, 0]) / F32(W) - F32(0.5)
        fy = F32(0.5) - (yi + rnd[:, 1]) / F32(H)
        aspect = F32(H) / F32(W)
        d = np.stack([fx * cam["sensor_width"],
                      fy * cam["sensor_width"] * aspect,
                      np.full(n, -cam["focal_length"], np.float32)],
                     -1).astype(np.float32)
        d = normalize(d)
        o = np.tile(np.asarray([cam["x"], cam["y"], cam["z"]],
                               np.float32), (n, 1))

        color = np.zeros((n, 3), np.float32)
        contrib = np.ones((n, 3), np.float32)
        alive = np.ones(n, bool)
        for b in range(depth):
            t, face, b1, b2 = sc.trace(o, d)
            hit = face >= 0
            # shading for hit lanes
            fc = np.maximum(face, 0)
            w0 = 1.0 - b1 - b2
            nrm = (sc.n[fc, 0] * w0[:, None] + sc.n[fc, 1] * b1[:, None]
                   + sc.n[fc, 2] * b2[:, None])
            nrm = normalize(nrm, 1e-30)
            hit_pos = (o + t[:, None] * d
                       + nrm * np.float32(1e-5)).astype(np.float32)
            mat = sc.mat[sc.mesh[fc]]
            albedo = sc.albedo[mat]
            metallic = sc.metallic[mat]
            roughness = np.clip(sc.roughness[mat], 0.0, 1.0)
            v = normalize(-d, 1e-30)
            l = np.tile(l_dir, (n, 1))
            occ = sc.occluded(hit_pos, l, 1e-3, 1000.0)
            direct = microfacet_brdf(l, v, nrm, albedo, metallic,
                                     roughness) * sc.light_color
            c = np.where(occ[:, None], 0.0, direct) + albedo * 0.1
            gi_rnd = pcg3d(np.stack([np.full(n, frame_id, np.uint32),
                                     pix,
                                     np.full(n, b, np.uint32)], -1))
            nd, nf = sample_brdf(v, nrm, albedo, metallic, roughness,
                                 gi_rnd)
            below = dot(nd, nrm) < 0.0
            hit_pos_out = np.where(
                below[:, None],
                (o + t[:, None] * d - nrm * np.float32(1e-5)
                 ).astype(np.float32), hit_pos)

            add = alive & hit
            color = color + np.where(add[:, None], contrib * c, 0.0)
            bg = alive & (~hit) & (b == 0)
            color = np.where(bg[:, None],
                             np.asarray([0.2, 0.2, 0.5], np.float32),
                             color)
            contrib = np.where(add[:, None], contrib * nf, contrib)
            alive = alive & hit
            o = np.where(add[:, None], hit_pos_out, o).astype(np.float32)
            d = np.where(add[:, None], nd, d).astype(np.float32)
            if not alive.any():
                break
        f = np.float32(total_samples + s)
        scratch = ((f * scratch + color) / (f + 1.0)).astype(np.float32)

    # ACES + gamma 0.7 + quantize (tonemap.py mirrors shader.cl)
    x = scratch * 0.6
    aces = np.clip((x * (2.51 * x + 0.03))
                   / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    rgb = np.power(np.maximum(aces, 0.0), 0.7, dtype=np.float32)
    img = np.clip(np.floor(rgb * 255.0), 0, 255).astype(np.uint8)
    return img.reshape(H, W, 3)
