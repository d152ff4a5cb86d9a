"""Two-level traversal vs brute-force oracle (SURVEY.md §4 strategy b)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radiance_tpu.api import accel
from radiance_tpu.core import types
from radiance_tpu.ops import traversal
from radiance_tpu.ops.intersect import FLT_MAX, intersect_triangle_soup

from test_bvh import random_mesh


def world_soup(instances):
    """Transform every instance's triangles to world space; track ids."""
    v0s, e1s, e2s, prims, inst_ids = [], [], [], [], []
    for inst_id, inst in enumerate(instances):
        blas = inst.bottom_accel_struct
        tris = blas.faces  # leaf order but primID = original index
        v = blas.vertices
        m = inst.transform
        for rec in tris:
            a = v[int(rec["idx0"])]
            b = v[int(rec["idx1"])]
            c = v[int(rec["idx2"])]
            pts = np.stack([a, b, c])
            w = (m[:3, :3] @ pts.T).T + m[:3, 3]
            v0s.append(w[0])
            e1s.append(w[1] - w[0])
            e2s.append(w[2] - w[0])
            prims.append(int(rec["primID"]))
            inst_ids.append(inst_id)
    return (np.asarray(v0s, np.float32), np.asarray(e1s, np.float32),
            np.asarray(e2s, np.float32), np.asarray(prims), np.asarray(inst_ids))


def single_instance_scene(n_tris=300, seed=10, transform=None):
    rng = np.random.default_rng(seed)
    mesh = random_mesh(rng, n_tris, spread=5.0)
    blas = accel.BuildBottomAccelStruct(mesh)
    tf = np.eye(4, dtype=np.float32) if transform is None else transform
    inst = types.Instance(transform=tf, sbt_offset=0,
                          custom_instance_id=0, bottom_accel_struct=blas)
    return accel.BuildTopAccelStruct([inst]).device_scene()


def gen_rays(rng, n, spread=12.0):
    o = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def run_and_compare(instances, n_rays=256, seed=0, tmin=1e-3, tmax=1e3):
    rng = np.random.default_rng(seed)
    tlas = accel.BuildTopAccelStruct(instances)
    ds = tlas.device_scene()

    o, d = gen_rays(rng, n_rays)
    hits = jax.jit(
        lambda o, d: traversal.trace_rays(ds, o, d, tmin, tmax)
    )(jnp.asarray(o), jnp.asarray(d))

    v0, e1, e2, prims, inst_ids = world_soup(instances)
    t_ref, idx_ref, b1_ref, b2_ref = intersect_triangle_soup(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(e1),
        jnp.asarray(e2), tmin, tmax)
    t_ref = np.asarray(t_ref)
    idx_ref = np.asarray(idx_ref)

    t_got = np.asarray(hits.t)
    hit_got = t_got < FLT_MAX
    hit_ref = t_ref < FLT_MAX

    # hit/miss agreement; allow razor-edge disagreements only with tiny t gap
    agree = hit_got == hit_ref
    assert agree.mean() > 0.99, f"hit disagreement {1 - agree.mean():.3%}"
    both = hit_got & hit_ref
    np.testing.assert_allclose(t_got[both], t_ref[both], rtol=1e-3, atol=1e-4)

    # identity of hit primitive/instance where distances are unambiguous
    prim_ref = np.where(hit_ref, prims[np.clip(idx_ref, 0, None)], -1)
    inst_ref = np.where(hit_ref, inst_ids[np.clip(idx_ref, 0, None)], -1)
    slot = np.asarray(hits.slot)
    inst_got = np.where(slot >= 0, np.asarray(ds.inst_id)[np.clip(slot, 0, None)], -1)
    prim_got = np.asarray(hits.prim)
    same = both & (np.abs(t_got - t_ref) < 1e-5)
    assert (prim_got[same] == prim_ref[same]).mean() > 0.98
    assert (inst_got[same] == inst_ref[same]).mean() > 0.98
    return hits, (t_ref, idx_ref)


def test_single_identity_instance():
    rng = np.random.default_rng(10)
    mesh = random_mesh(rng, 300, spread=5.0)
    blas = accel.BuildBottomAccelStruct(mesh)
    inst = types.Instance(transform=np.eye(4, dtype=np.float32), sbt_offset=0,
                          custom_instance_id=0, bottom_accel_struct=blas)
    run_and_compare([inst], n_rays=512, seed=1)


def test_multi_instance_transformed():
    rng = np.random.default_rng(11)
    mesh1 = random_mesh(rng, 120, spread=2.0)
    mesh2 = random_mesh(rng, 80, spread=2.0)
    blas1 = accel.BuildBottomAccelStruct(mesh1)
    blas2 = accel.BuildBottomAccelStruct(mesh2)

    def tf(tx, ty, tz, ry=0.0, s=1.0):
        c, si = np.cos(ry), np.sin(ry)
        m = np.array([
            [c * s, 0, si * s, tx],
            [0, s, 0, ty],
            [-si * s, 0, c * s, tz],
            [0, 0, 0, 1]], np.float32)
        return m

    instances = [
        types.Instance(tf(0, 0, 0), 0, 0, blas1),
        types.Instance(tf(6, 1, -2, ry=0.7), 0, 1, blas2),
        types.Instance(tf(-6, -1, 3, ry=1.9, s=1.5), 0, 2, blas1),
        types.Instance(tf(0, 7, 0, ry=0.3, s=0.5), 0, 3, blas2),
    ]
    run_and_compare(instances, n_rays=512, seed=2)


def test_many_instances_deep_tlas():
    # > MAX_LEAF instances so the TLAS gets inner nodes
    rng = np.random.default_rng(12)
    mesh = random_mesh(rng, 40, spread=1.0)
    blas = accel.BuildBottomAccelStruct(mesh)
    instances = []
    for i in range(25):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = rng.uniform(-20, 20, 3)
        instances.append(types.Instance(m, 0, i, blas))
    run_and_compare(instances, n_rays=512, seed=3)


def test_any_hit_occlusion():
    rng = np.random.default_rng(13)
    mesh = random_mesh(rng, 200, spread=4.0)
    blas = accel.BuildBottomAccelStruct(mesh)
    inst = types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)
    tlas = accel.BuildTopAccelStruct([inst])
    ds = tlas.device_scene()
    o, d = gen_rays(rng, 256, spread=6.0)
    closest = traversal.trace_rays(ds, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e3)
    anyhit = traversal.trace_rays(ds, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e3,
                                  any_hit_terminate=True)
    # occlusion query finds a hit iff closest-hit does
    np.testing.assert_array_equal(np.asarray(closest.hit), np.asarray(anyhit.hit))
    # any-hit t is >= ... no: it's *a* hit, so t >= closest t
    both = np.asarray(closest.hit)
    assert np.all(np.asarray(anyhit.t)[both] >= np.asarray(closest.t)[both] - 1e-5)


def test_oversized_leaf_normalization():
    # coincident centroids force a 32-wide reference leaf; device scene must
    # split it and traversal must still find hits
    n = 32
    tris_v = []
    for i in range(n):
        z = 1.0 + 0.01 * i
        tris_v += [[0, 0, z], [4, 0, z], [0, 4, z]]
    # same centroid in xy... vary z slightly but centers differ then.
    # Force degenerate: make all triangles identical bbox centers by using
    # the same geometry, differing only in index order (primID distinguishes).
    v = np.asarray([[0, 0, 1], [4, 0, 1], [0, 4, 1]], np.float32)
    verts = np.tile(v, (n, 1))
    tris = np.arange(n * 3, dtype=np.uint32).reshape(-1, 3)
    mesh = types.Mesh(vertices=verts, triangles=tris)
    blas = accel.BuildBottomAccelStruct(mesh)
    assert len(blas.nodes) == 1  # reference builder: one oversized leaf
    inst = types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)
    ds = accel.BuildTopAccelStruct([inst]).device_scene()
    # normalized: all tri-leaf node counts <= 8
    kinds = np.asarray(ds.node_kind)
    counts = np.asarray(ds.node_b)
    assert np.all(counts[kinds == 1] <= 8)
    o = jnp.asarray(np.array([[1, 1, 0]], np.float32))
    d = jnp.asarray(np.array([[0, 0, 1]], np.float32))
    hits = traversal.trace_rays(ds, o, d, 1e-3, 1e3)
    assert bool(hits.hit[0]) and np.isclose(float(hits.t[0]), 1.0)


def test_miss_everything():
    rng = np.random.default_rng(14)
    mesh = random_mesh(rng, 50, spread=1.0)
    blas = accel.BuildBottomAccelStruct(mesh)
    inst = types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)
    ds = accel.BuildTopAccelStruct([inst]).device_scene()
    o = jnp.asarray(np.array([[100, 100, 100]], np.float32))
    d = jnp.asarray(np.array([[0, 0, 1]], np.float32))
    hits = traversal.trace_rays(ds, o, d, 1e-3, 1e3)
    assert not bool(hits.hit[0])
    assert int(hits.slot[0]) == -1 and int(hits.prim[0]) == -1
