"""The XLA walk (ops/traversal.trace_rays) against brute force.

Every scene kind and ray population the engine produces, in closest-hit
and any-hit mode, checked against `intersect_triangle_soup` over the
world-space triangle soup: grazing rays far from the origin, leaves at
the bundle-width cap, 2- and 9-instance TLAS under rotation and scale,
parked dead lanes, tile-coherent camera waves, GGX-scattered bounce
waves and degenerate rays (zero directions, axis-parallel rays lying on
box planes).  Both sides are float32 Moller-Trumbore with the same edge
vectors, so single-instance scenes must agree exactly; instanced ones
differ only by the world/object transform's rounding.
"""

import functools
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radiance_tpu.api import accel
from radiance_tpu.core import types
from radiance_tpu.engine import pathtracer
from radiance_tpu.ops import traversal
from radiance_tpu.ops.intersect import FLT_MAX, intersect_triangle_soup
from radiance_tpu.scene import bench_scenes

from test_bvh import random_mesh
from test_traversal import gen_rays, world_soup

TMIN, TMAX = 1e-3, 1e4
N_RAYS = 384


# ------------------------------------------------------------- scenes


def _identity(blas, i=0):
    return types.Instance(np.eye(4, dtype=np.float32), 0, i, blas)


def _rot(rng):
    a, b = rng.uniform(0, 2 * np.pi, 2)
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    return (rz @ ry).astype(np.float32)


def _scene_random():
    mesh = random_mesh(np.random.default_rng(10), 300, spread=5.0)
    return [_identity(accel.BuildBottomAccelStruct(mesh))]


def _scene_transformed():
    mesh = random_mesh(np.random.default_rng(11), 150, spread=5.0)
    c, s = np.cos(0.6), np.sin(0.6)
    tf = np.array([[c * 2, 0, s * 2, 1.0], [0, 2, 0, -2.0],
                   [-s * 2, 0, c * 2, 3.0], [0, 0, 0, 1]], np.float32)
    return [types.Instance(tf, 0, 0, accel.BuildBottomAccelStruct(mesh))]


FAR = np.array([600.0, 400.0, 500.0], np.float32)


def _scene_far():
    """Mesh ~880 units from the origin: grazing rays from a far eye."""
    mesh = random_mesh(np.random.default_rng(5), 400, spread=5.0)
    mesh = types.Mesh(mesh.vertices + FAR, mesh.triangles)
    return [_identity(accel.BuildBottomAccelStruct(mesh))]


CITY_TRIS, CITY_CLUSTERS = 3840, 8


def _scene_city():
    verts, tris = bench_scenes.city_geometry(CITY_TRIS,
                                             n_clusters=CITY_CLUSTERS)
    return [_identity(accel.BuildBottomAccelStruct(types.Mesh(verts, tris)))]


def _scene_capped():
    """Groups of triangles sharing one centroid: SAH cannot split them,
    so the builder emits oversized leaves that the device layout splits
    into bundles at the LEAF_WIDTH cap."""
    rng = np.random.default_rng(3)
    base = np.array([[-1.0, -0.6, 0.0], [1.0, -0.6, 0.0], [0.0, 1.2, 0.0]],
                    np.float32)
    base -= base.mean(axis=0)
    verts = []
    for c in rng.uniform(-6, 6, (12, 3)):
        for _ in range(24):
            verts.append(base @ _rot(rng).T + c)
    verts = np.concatenate(verts).astype(np.float32)
    tris = np.arange(len(verts), dtype=np.uint32).reshape(-1, 3)
    return [_identity(accel.BuildBottomAccelStruct(types.Mesh(verts, tris)))]


def _scene_tlas2():
    rng = np.random.default_rng(21)
    b1 = accel.BuildBottomAccelStruct(random_mesh(rng, 120, spread=2.0))
    b2 = accel.BuildBottomAccelStruct(random_mesh(rng, 90, spread=2.0))
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = _rot(rng) * 1.5
    tf[:3, 3] = [4.0, -1.0, 2.0]
    return [_identity(b1), types.Instance(tf, 0, 1, b2)]


def _scene_tlas9():
    """Shared-BLAS instances under rotation, placement and scale."""
    rng = np.random.default_rng(7)
    blas = [accel.BuildBottomAccelStruct(random_mesh(rng, 150, spread=2.0))
            for _ in range(3)]
    out = []
    for i in range(9):
        tf = np.eye(4, dtype=np.float32)
        tf[:3, :3] = _rot(rng) * rng.uniform(0.5, 2.0)
        tf[:3, 3] = rng.uniform(-10, 10, 3)
        out.append(types.Instance(tf, 0, i, blas[i % 3]))
    return out


def _scene_interior():
    verts, tris = bench_scenes.scene_geometry("interior", 3000)
    return [_identity(accel.BuildBottomAccelStruct(types.Mesh(verts, tris)))]


SCENES = {
    "random": _scene_random, "transformed": _scene_transformed,
    "far": _scene_far, "city": _scene_city, "capped": _scene_capped,
    "tlas2": _scene_tlas2, "tlas9": _scene_tlas9,
    "interior": _scene_interior,
}


@functools.lru_cache(maxsize=None)
def scene_bundle(name):
    """(instances, DeviceScene, world soup) -- built on first use."""
    inst = SCENES[name]()
    ds = accel.BuildTopAccelStruct(inst).device_scene()
    return inst, ds, world_soup(inst)


# --------------------------------------------------------- ray sets


def _rays_random(rng, soup):
    return gen_rays(rng, N_RAYS, spread=10.0)


def _rays_grazing(rng, soup):
    o = np.tile(FAR + [0, 0, 60.0], (N_RAYS, 1)).astype(np.float32)
    d = FAR + rng.uniform(-5, 5, (N_RAYS, 3)) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _rays_tiles(rng, soup):
    """Tile-ordered camera rays from 8 units in front of the first city
    cluster, which fills a good part of the view."""
    o, d = bench_scenes.camera_rays("city", 32, 32, tile=8)
    verts, _ = bench_scenes.city_geometry(CITY_TRIS,
                                          n_clusters=CITY_CLUSTERS)
    first = verts[:3 * CITY_TRIS // CITY_CLUSTERS].mean(axis=0)
    o = np.broadcast_to(first + [0.0, 0.0, 8.0], o.shape).astype(np.float32)
    return o, d


def _rays_camera_interior(rng, soup):
    # includes the screen row with d_y == 0 exactly: rays lying in the
    # plane y = 6 of box faces
    return bench_scenes.camera_rays("interior", 32, 32, tile=8)


def _surface_points(rng, soup, n):
    v0, e1, e2 = soup[:3]
    f = rng.integers(0, len(v0), n)
    a, b = rng.uniform(0, 1, (2, n))
    flip = a + b > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    nrm = np.cross(e1[f], e2[f])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    p = v0[f] + a[:, None] * e1[f] + b[:, None] * e2[f]
    return p, nrm


def _rays_ggx(rng, soup):
    """Bounce rays: origins on the surfaces (offset along the normal),
    directions from a GGX lobe (roughness 0.6) about the normal."""
    p, nrm = _surface_points(rng, soup, N_RAYS)
    side = np.where(rng.uniform(size=(N_RAYS, 1)) < 0.5, -1.0, 1.0)
    nrm = nrm * side
    rx, ry = rng.uniform(0, 1, (2, N_RAYS))
    alpha = 0.6 ** 2
    cos_t = np.sqrt((1 - ry) / (1 + (alpha ** 2 - 1) * ry))
    sin_t = np.sqrt(1 - cos_t ** 2)
    phi = 2 * np.pi * rx
    t = np.cross(nrm, [0.0, 1.0, 0.0])
    t = np.where(np.linalg.norm(t, axis=-1, keepdims=True) < 1e-3,
                 np.cross(nrm, [1.0, 0.0, 0.0]), t)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(nrm, t)
    d = (sin_t[:, None] * (np.cos(phi)[:, None] * t
                           + np.sin(phi)[:, None] * b)
         + cos_t[:, None] * nrm)
    return ((p + nrm * 1e-3).astype(np.float32),
            (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
                np.float32))


def _rays_degenerate(rng, soup):
    """Zero directions (must miss), axis-parallel rays whose origin lies
    on a vertex coordinate plane (slab planes of the node boxes), signed
    zeros, and directions far from unit length."""
    v0 = soup[0]
    n = N_RAYS // 4
    o_zero = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d_zero = np.zeros((n, 3), np.float32)
    vert = v0[rng.integers(0, len(v0), n)]
    o_ax = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    ax = rng.integers(0, 3, n)
    o_ax[np.arange(n), ax] = vert[np.arange(n), ax]       # on the plane
    d_ax = np.zeros((n, 3), np.float32)
    mv = (ax + 1 + rng.integers(0, 2, n)) % 3             # moving axis
    d_ax[np.arange(n), mv] = np.where(vert[np.arange(n), mv]
                                      > o_ax[np.arange(n), mv], 1.0, -1.0)
    d_ax[np.arange(n), ax] = np.where(rng.uniform(size=n) < 0.5,
                                      0.0, -0.0)
    o_s, d_s = gen_rays(rng, n, spread=10.0)
    d_s = d_s * rng.choice([1e-3, 1e3], size=(n, 1)).astype(np.float32)
    o_r, d_r = gen_rays(rng, n, spread=10.0)
    return (np.concatenate([o_zero, o_ax, o_s, o_r]),
            np.concatenate([d_zero, d_ax, d_s, d_r]))


RAYS = {
    "random": _rays_random, "grazing": _rays_grazing,
    "tiles": _rays_tiles, "camera": _rays_camera_interior,
    "ggx": _rays_ggx, "degenerate": _rays_degenerate,
}

# (scene, ray set, parked): parked parks every third lane at the
# engine's parking spot, which must report a miss
CASES = [
    ("random", "random", False), ("random", "random", True),
    ("random", "degenerate", False), ("random", "ggx", False),
    ("transformed", "random", False), ("far", "grazing", False),
    ("city", "tiles", False), ("city", "ggx", False),
    ("capped", "degenerate", False), ("capped", "random", False),
    ("tlas2", "random", False), ("tlas2", "ggx", True),
    ("tlas9", "random", False), ("tlas9", "ggx", False),
    ("interior", "camera", False), ("interior", "degenerate", False),
]

_TRACE = jax.jit(
    lambda ds, o, d, any_hit: traversal.trace_rays(
        ds, o, d, TMIN, TMAX, any_hit_terminate=any_hit),
    static_argnums=3)


def _oracle(soup, o, d):
    v0, e1, e2, prims, inst_ids = soup
    t, idx, _, _ = intersect_triangle_soup(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(e1),
        jnp.asarray(e2), TMIN, TMAX)
    t, idx = np.asarray(t), np.asarray(idx)
    hit = t < FLT_MAX
    return (t, np.where(hit, prims[np.clip(idx, 0, None)], -1),
            np.where(hit, inst_ids[np.clip(idx, 0, None)], -1))


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("scene,rays,parked", CASES,
                         ids=[f"{s}-{r}{'-parked' if p else ''}"
                              for s, r, p in CASES])
def test_walk_matches_brute_force(scene, rays, parked, mode):
    inst, ds, soup = scene_bundle(scene)
    rng = np.random.default_rng(zlib.crc32(f"{scene}/{rays}".encode()))
    o, d = RAYS[rays](rng, soup)
    live = np.ones(len(o), bool)
    if parked:
        live[::3] = False
        o = np.where(live[:, None], o, np.float32(pathtracer._PARK_ORIGIN))
        d = np.where(live[:, None], d, np.float32(1.0))
    rec = _TRACE(ds, jnp.asarray(o), jnp.asarray(d), mode == "any")
    t_got = np.asarray(rec.t)
    t_ref, prim_ref, inst_ref = _oracle(soup, o, d)
    hit_got, hit_ref = t_got < FLT_MAX, t_ref < FLT_MAX
    assert hit_ref[live].mean() > 0.02, "ray set barely hits the scene"
    assert not hit_got[~live].any(), "a parked lane reported a hit"
    exact = len(inst) == 1 or all(
        np.array_equal(i.transform, np.eye(4)) for i in inst)
    agree = (hit_got == hit_ref)[live].mean()
    assert agree >= (1.0 if exact else 0.99), f"hit agreement {agree:.4f}"
    both = hit_got & hit_ref & live
    if mode == "any":
        # an occlusion hit is *a* hit in the window, never nearer than
        # the closest one
        assert np.all(t_got[both] >= t_ref[both] * (1 - 1e-5) - 1e-6)
        assert np.all((t_got[both] > TMIN) & (t_got[both] < TMAX))
        return
    np.testing.assert_allclose(t_got[both], t_ref[both],
                               rtol=1e-6 if exact else 1e-3, atol=1e-5)
    slot = np.asarray(rec.slot)
    inst_got = np.where(slot >= 0, np.asarray(ds.inst_id)[
        np.clip(slot, 0, None)], -1)
    same = both & (np.abs(t_got - t_ref) <= 1e-6 * np.abs(t_ref))
    assert (np.asarray(rec.prim)[same] == prim_ref[same]).mean() >= 0.99
    assert (inst_got[same] == inst_ref[same]).mean() >= 0.99
    assert np.all(slot[~hit_got] == -1)
