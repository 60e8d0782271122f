import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goblin_tpu.geometry import intersect as isect
from goblin_tpu.geometry.mesh import TriangleMesh, load_obj, make_sphere_mesh, write_obj


def test_moller_trumbore_basic():
    v0 = jnp.array([0.0, 0.0, 0.0])
    e1 = jnp.array([1.0, 0.0, 0.0])
    e2 = jnp.array([0.0, 1.0, 0.0])
    o = jnp.array([0.2, 0.2, -1.0])
    d = jnp.array([0.0, 0.0, 1.0])
    hit, t, b1, b2 = isect.moller_trumbore(o, d, v0, e1, e2, 0.0, 1e30)
    assert bool(hit)
    np.testing.assert_allclose(float(t), 1.0, rtol=1e-6)
    np.testing.assert_allclose([float(b1), float(b2)], [0.2, 0.2], atol=1e-6)
    # miss outside the triangle
    o2 = jnp.array([0.9, 0.9, -1.0])
    hit2, *_ = isect.moller_trumbore(o2, d, v0, e1, e2, 0.0, 1e30)
    assert not bool(hit2)


def test_moller_trumbore_vs_plane_solution():
    """Random triangles/rays: t matches the analytic plane intersection."""
    rng = np.random.default_rng(3)
    T = 256
    p0 = rng.normal(size=(T, 3)).astype(np.float32)
    p1 = p0 + rng.normal(size=(T, 3)).astype(np.float32)
    p2 = p0 + rng.normal(size=(T, 3)).astype(np.float32)
    o = rng.normal(size=(T, 3)).astype(np.float32) * 3
    # aim at a jittered point near each triangle's centroid so a good
    # fraction of rays actually hit
    target = (p0 + p1 + p2) / 3 + rng.normal(size=(T, 3)).astype(np.float32) * 0.3
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    e1, e2 = p1 - p0, p2 - p0
    hit, t, b1, b2 = isect.moller_trumbore(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(p0), jnp.asarray(e1),
        jnp.asarray(e2), jnp.float32(0.0), jnp.float32(1e30),
    )
    n = np.cross(e1, e2)
    denom = np.sum(n * d, axis=-1)
    t_plane = np.sum(n * (p0 - o), axis=-1) / np.where(denom == 0, 1e-30, denom)
    hits = np.asarray(hit)
    assert hits.sum() > 10  # sanity: some rays hit
    np.testing.assert_allclose(np.asarray(t)[hits], t_plane[hits], rtol=1e-3)
    # reconstructed point matches barycentric interpolation
    ph = o[hits] + t_plane[hits, None] * d[hits]
    pb = (
        (1 - np.asarray(b1) - np.asarray(b2))[hits, None] * p0[hits]
        + np.asarray(b1)[hits, None] * p1[hits]
        + np.asarray(b2)[hits, None] * p2[hits]
    )
    np.testing.assert_allclose(ph, pb, atol=1e-3)


def test_sphere_intersect():
    o = jnp.array([[0.0, 0.0, -5.0], [0.0, 2.0, -5.0], [0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, 1.0]] * 3)
    c = jnp.zeros(3)
    hit, t = isect.intersect_sphere(o, d, c, 1.0, jnp.float32(1e-3), jnp.float32(1e30))
    assert bool(hit[0]) and not bool(hit[1]) and bool(hit[2])
    np.testing.assert_allclose(float(t[0]), 4.0, rtol=1e-5)
    np.testing.assert_allclose(float(t[2]), 1.0, rtol=1e-5)  # from inside


def test_disk_intersect():
    o = jnp.array([[0.3, 0.0, -2.0], [1.5, 0.0, -2.0]])
    d = jnp.array([[0.0, 0.0, 1.0]] * 2)
    hit, t = isect.intersect_disk(
        o, d, jnp.zeros(3), jnp.array([0.0, 0.0, -1.0]), 1.0,
        jnp.float32(0.0), jnp.float32(1e30),
    )
    assert bool(hit[0]) and not bool(hit[1])
    np.testing.assert_allclose(float(t[0]), 2.0, rtol=1e-6)


def test_aabb_slab():
    o = jnp.array([[0.0, 0.0, -5.0], [3.0, 0.0, -5.0]])
    d = jnp.array([[0.0, 0.0, 1.0]] * 2)
    inv_d = 1.0 / jnp.where(d == 0, 1e-30, d)
    hit, tn = isect.intersect_aabb(
        o, inv_d, -jnp.ones(3), jnp.ones(3), jnp.float32(0.0), jnp.float32(1e30)
    )
    assert bool(hit[0]) and not bool(hit[1])
    np.testing.assert_allclose(float(tn[0]), 4.0, rtol=1e-6)


def test_obj_loader_roundtrip(tmp_path):
    mesh = make_sphere_mesh(1.0, 8, 16)
    path = os.path.join(tmp_path, "sphere.obj")
    write_obj(path, mesh)
    loaded = load_obj(path)
    assert loaded.num_faces == mesh.num_faces
    np.testing.assert_allclose(loaded.positions[loaded.faces],
                               mesh.positions[mesh.faces], atol=1e-5)
    assert loaded.has_normals and loaded.has_uvs


def test_obj_formats(tmp_path):
    content = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
f 1 2 3
f 1/1 2/2 3/3
f 1//1 2//1 3//1
f -4/-3/-1 -3/-2/-1 -2/-1/-1
f 1 2 3 4
"""
    p = os.path.join(tmp_path, "t.obj")
    with open(p, "w") as f:
        f.write(content)
    mesh = load_obj(p)
    # 4 tri faces + 1 quad -> 6 triangles
    assert mesh.num_faces == 6
    assert mesh.has_normals and mesh.has_uvs


def test_reference_plane_obj_loads():
    mesh = load_obj(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "models", "plane.obj"))
    assert mesh.num_faces >= 2
    # plane should be flat in y
    assert (
        np.ptp(mesh.positions[:, 1]) < 1e-3 or np.ptp(mesh.positions[:, 2]) < 1e-3
    )


def test_mesh_area():
    mesh = make_sphere_mesh(1.0, 64, 128)
    np.testing.assert_allclose(mesh.area(), 4 * np.pi, rtol=1e-2)
