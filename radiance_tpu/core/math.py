"""Core math: RNG, linear algebra, tangent frames.

Equivalent of the reference's device math library
(reference: radiance/shader/math.cl).  Everything is written as batched
`jnp` functions operating on `[..., 3]` / `[..., 4, 4]` arrays so they
vectorize over ray wavefronts; no per-element Python control flow.

The PCG3D hash matches the reference bit-for-bit (math.cl:10-23) so renders
can reproduce the reference's sampling sequence exactly.
"""

from __future__ import annotations

import jax.numpy as jnp


# -----------------------------------------------------------------------------
# RNG: PCG3D (Jarzynski & Olano, JCGT 2020).  Reference: math.cl:10-23.
# -----------------------------------------------------------------------------

def pcg3d(v) -> jnp.ndarray:
    """Stateless 3D hash.  v: uint32 array [..., 3] -> float32 [..., 3] in [0,1].

    Bit-exact with the reference: multiply-add, cross-feedback, xorshift,
    cross-feedback, then divide by 0xffffffff as float32.
    """
    v = jnp.asarray(v, dtype=jnp.uint32)
    v = v * jnp.uint32(1664525) + jnp.uint32(1013904223)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    out = jnp.stack([x, y, z], axis=-1)
    return out.astype(jnp.float32) / jnp.float32(0xFFFFFFFF)


# -----------------------------------------------------------------------------
# Vector helpers
# -----------------------------------------------------------------------------

def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def normalize(v, eps: float = 0.0):
    n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


# -----------------------------------------------------------------------------
# 4x4 matrices, row-major (as in the reference's mat4x4 = float16, math.cl:4)
# -----------------------------------------------------------------------------

# These are written as explicit broadcasted multiply-adds rather than einsum:
# einsum lowers to a matrix unit at the backend's default precision (TF32 or
# bf16 on some accelerators), which is both wasteful for 4x4 shapes and lossy
# for geometry.  The sum-over-last-axis form stays in full float32.

def mat4_vec4(m, v):
    """[..., 4, 4] @ [..., 4] -> [..., 4].  Reference: math.cl:25-31."""
    return jnp.sum(m * v[..., None, :], axis=-1)


def mat4_mat4(a, b):
    """Row-major matmul.  Reference: math.cl:33-54."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def mat4_transform_point(m, p):
    """Apply [...,4,4] to [...,3] point (w=1), returning [...,3]."""
    return jnp.sum(m[..., :3, :3] * p[..., None, :], axis=-1) + m[..., :3, 3]


def mat4_transform_dir(m, d):
    """Apply [...,4,4] to [...,3] direction (w=0), returning [...,3]."""
    return jnp.sum(m[..., :3, :3] * d[..., None, :], axis=-1)


def mat4_inverse(m):
    """General 4x4 inverse by cofactor expansion (reference: math.cl:56-183).

    Returns the inverse; a singular matrix yields inf/nan entries (the
    reference returns false and leaves the output undefined -- callers in the
    reference never check).  Uses jnp.linalg.inv-free formulation to stay
    in plain float32 elementwise arithmetic.
    """
    m = jnp.asarray(m)
    # unpack row-major entries
    a = m[..., 0, 0]; b = m[..., 0, 1]; c = m[..., 0, 2]; d = m[..., 0, 3]
    e = m[..., 1, 0]; f = m[..., 1, 1]; g = m[..., 1, 2]; h = m[..., 1, 3]
    i = m[..., 2, 0]; j = m[..., 2, 1]; k = m[..., 2, 2]; l = m[..., 2, 3]
    mm = m[..., 3, 0]; n = m[..., 3, 1]; o = m[..., 3, 2]; p = m[..., 3, 3]

    kp_lo = k * p - l * o
    jp_ln = j * p - l * n
    jo_kn = j * o - k * n
    ip_lm = i * p - l * mm
    io_km = i * o - k * mm
    in_jm = i * n - j * mm

    c00 = f * kp_lo - g * jp_ln + h * jo_kn
    c01 = -(e * kp_lo - g * ip_lm + h * io_km)
    c02 = e * jp_ln - f * ip_lm + h * in_jm
    c03 = -(e * jo_kn - f * io_km + g * in_jm)

    det = a * c00 + b * c01 + c * c02 + d * c03
    inv_det = 1.0 / det

    gp_ho = g * p - h * o
    fp_hn = f * p - h * n
    fo_gn = f * o - g * n
    ep_hm = e * p - h * mm
    eo_gm = e * o - g * mm
    en_fm = e * n - f * mm

    gl_hk = g * l - h * k
    fl_hj = f * l - h * j
    fk_gj = f * k - g * j
    el_hi = e * l - h * i
    ek_gi = e * k - g * i
    ej_fi = e * j - f * i

    c10 = -(b * kp_lo - c * jp_ln + d * jo_kn)
    c11 = a * kp_lo - c * ip_lm + d * io_km
    c12 = -(a * jp_ln - b * ip_lm + d * in_jm)
    c13 = a * jo_kn - b * io_km + c * in_jm

    c20 = b * gp_ho - c * fp_hn + d * fo_gn
    c21 = -(a * gp_ho - c * ep_hm + d * eo_gm)
    c22 = a * fp_hn - b * ep_hm + d * en_fm
    c23 = -(a * fo_gn - b * eo_gm + c * en_fm)

    c30 = -(b * gl_hk - c * fl_hj + d * fk_gj)
    c31 = a * gl_hk - c * el_hi + d * ek_gi
    c32 = -(a * fl_hj - b * el_hi + d * ej_fi)
    c33 = a * fk_gj - b * ek_gi + c * ej_fi

    inv = jnp.stack([
        jnp.stack([c00, c10, c20, c30], axis=-1),
        jnp.stack([c01, c11, c21, c31], axis=-1),
        jnp.stack([c02, c12, c22, c32], axis=-1),
        jnp.stack([c03, c13, c23, c33], axis=-1),
    ], axis=-2)
    return inv * inv_det[..., None, None]


def euler_x(theta):
    """Rotation about X (reference: math.cl:185-206).  theta: [...] scalar."""
    theta = jnp.asarray(theta)
    c, s = jnp.cos(theta), jnp.sin(theta)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    rows = [
        [one, zero, zero, zero],
        [zero, c, -s, zero],
        [zero, s, c, zero],
        [zero, zero, zero, one],
    ]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def euler_y(theta):
    """Rotation about Y (reference: math.cl:208-229)."""
    theta = jnp.asarray(theta)
    c, s = jnp.cos(theta), jnp.sin(theta)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    rows = [
        [c, zero, s, zero],
        [zero, one, zero, zero],
        [-s, zero, c, zero],
        [zero, zero, zero, one],
    ]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def euler_z(theta):
    """Rotation about Z (reference: math.cl:231-252)."""
    theta = jnp.asarray(theta)
    c, s = jnp.cos(theta), jnp.sin(theta)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    rows = [
        [c, -s, zero, zero],
        [s, c, zero, zero],
        [zero, zero, one, zero],
        [zero, zero, zero, one],
    ]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def normal_space(normal):
    """Build a tangent frame matrix from a normal (reference: math.cl:269-298).

    Columns are (tangent, bitangent, normal): transforming a local vector
    (x, y, z) yields x*T + y*B + z*N, matching the reference's layout where
    column 0 is the tangent, column 1 the bitangent, column 2 the normal.
    normal: [..., 3] -> [..., 4, 4].
    """
    normal = jnp.asarray(normal)
    some_vec = jnp.zeros_like(normal).at[..., 0].set(1.0)
    dd = dot(some_vec, normal)
    default_tangent = jnp.zeros_like(normal).at[..., 1].set(1.0)
    crossed = cross(some_vec, normal)
    use_cross = (1.0 - jnp.abs(dd)) > 1e-6
    tangent = jnp.where(use_cross[..., None], normalize(crossed, eps=1e-30), default_tangent)
    bitangent = cross(normal, tangent)

    batch = normal.shape[:-1]
    out = jnp.zeros(batch + (4, 4), dtype=normal.dtype)
    out = out.at[..., :3, 0].set(tangent)
    out = out.at[..., :3, 1].set(bitangent)
    out = out.at[..., :3, 2].set(normal)
    out = out.at[..., 3, 3].set(1.0)
    return out


def transform_local_dir(normal, local_dir):
    """normal_space(normal) applied to a local [..., 3] direction -> [..., 3].

    Fused form avoiding materializing the 4x4 matrix in the hot path.
    """
    normal = jnp.asarray(normal)
    some_vec = jnp.zeros_like(normal).at[..., 0].set(1.0)
    dd = dot(some_vec, normal)
    default_tangent = jnp.zeros_like(normal).at[..., 1].set(1.0)
    crossed = cross(some_vec, normal)
    use_cross = (1.0 - jnp.abs(dd)) > 1e-6
    tangent = jnp.where(use_cross[..., None], normalize(crossed, eps=1e-30), default_tangent)
    bitangent = cross(normal, tangent)
    return (
        local_dir[..., 0:1] * tangent
        + local_dir[..., 1:2] * bitangent
        + local_dir[..., 2:3] * normal
    )


def reflect(v_in, n):
    """Reflect *towards-viewer* vector about normal (reference: pbr.cl:171-174).

    Note the reference's convention: returns -in + 2*dot(in, N)*N, i.e. `in`
    points away from the surface.
    """
    return -v_in + 2.0 * dot(v_in, n, keepdims=True) * n


def refract(v, h, eta):
    """Refraction used by the transmission sampler (reference: pbr.cl:176-186).

    eta: [...] relative IOR.  Falls back to (cos*H - V)/eta on TIR, matching
    the reference.
    """
    eta = jnp.asarray(eta)[..., None]
    cos_i = dot(h, v, keepdims=True)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = sin2_i / (eta * eta)
    tir = (1.0 - sin2_t) < 0.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    refr = -v / eta + (cos_i / eta - cos_t) * h
    fallback = (cos_i * h - v) / eta
    return jnp.where(tir, fallback, refr)
