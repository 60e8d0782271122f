"""BVH trace kernel (ops/trace_kernel) against its references.

The kernel runs here through the Pallas interpreter (interpret=True); the
compiled kernel is checked on the GPU by the `gpu`-marked test below and
at full-frame widths by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goblin_tpu.accel import traverse
from goblin_tpu.accel.bvh import build_bvh
from goblin_tpu.geometry import intersect as isect
from goblin_tpu.geometry.mesh import make_sphere_mesh
from goblin_tpu.ops import trace_kernel
from goblin_tpu.scene import bake
from goblin_tpu.scene import intersect as scn


def _scene_and_rays(n_tri=600, n_rays=1000, seed=0, max_leaf=4):
    rng = np.random.default_rng(seed)
    p0 = (rng.uniform(-1, 1, (n_tri, 3)) * 3).astype(np.float32)
    p1 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    p2 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    bvh = build_bvh(p0, p1, p2, max_leaf=max_leaf)
    k = bvh.order
    soup = np.concatenate([p0[k], p1[k] - p0[k], p2[k] - p0[k]], axis=-1)
    o = (rng.uniform(-1, 1, (n_rays, 3)) * 6).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32) * 1.5 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tables = tuple(jnp.asarray(a) for a in (bvh.bounds, bvh.meta, soup))
    return (p0, p1, p2), bvh, tables, jnp.asarray(o), jnp.asarray(d)


def _rays_t(n, mint=1e-4, maxt=1e30):
    return (jnp.full((n,), mint, jnp.float32),
            jnp.full((n,), maxt, jnp.float32))


def _assert_same(a, b):
    """Kernel vs jnp reference: same walk, same picks. Floats differ only
    by the order and FMA contraction of the Moller-Trumbore products, so
    t agrees to rtol 1e-5; the barycentrics are differences of products
    of the ray/edge coordinates, so their error is absolute (atol 1e-5)
    however small the barycentric itself."""
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    np.testing.assert_array_equal(np.asarray(a.tri), np.asarray(b.tri))
    h = np.asarray(a.hit)
    np.testing.assert_allclose(np.asarray(a.t)[h], np.asarray(b.t)[h],
                               rtol=1e-5)
    for x, y in ((a.b1, b.b1), (a.b2, b.b2)):
        np.testing.assert_allclose(np.asarray(x)[h], np.asarray(y)[h],
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(a.t)[~h], np.asarray(b.t)[~h])


@pytest.mark.parametrize("seed", [0, 1])
def test_closest_hit_matches_brute_force(seed):
    (p0, p1, p2), bvh, tables, o, d = _scene_and_rays(seed=seed)
    mint, maxt = _rays_t(o.shape[0])
    res = trace_kernel.trace(*tables, o, d, mint, maxt, interpret=True)
    bf_hit, bf_t, bf_tri, _, _ = isect.brute_force_closest(
        o, d, jnp.asarray(p0), jnp.asarray(p1 - p0), jnp.asarray(p2 - p0),
        mint, maxt,
    )
    hit = np.asarray(res.hit)
    np.testing.assert_array_equal(hit, np.asarray(bf_hit))
    assert hit.sum() > 100
    np.testing.assert_allclose(np.asarray(res.t)[hit],
                               np.asarray(bf_t)[hit], rtol=1e-4)
    remap = bvh.order[np.asarray(res.tri)[hit]]
    assert (remap == np.asarray(bf_tri)[hit]).mean() > 0.99


@pytest.mark.parametrize("seed", [5, 6])
def test_any_hit_matches_brute_force(seed):
    (p0, p1, p2), _, tables, o, d = _scene_and_rays(seed=seed)
    mint, maxt = _rays_t(o.shape[0], maxt=4.0)
    res = trace_kernel.trace(*tables, o, d, mint, maxt, any_hit=True,
                             interpret=True)
    bf = isect.brute_force_occluded(
        o, d, jnp.asarray(p0), jnp.asarray(p1 - p0), jnp.asarray(p2 - p0),
        mint, maxt,
    )
    np.testing.assert_array_equal(np.asarray(res.hit), np.asarray(bf))
    assert 0 < np.asarray(bf).sum() < o.shape[0]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_parity_with_jnp_traverse(seed, any_hit):
    _, _, tables, o, d = _scene_and_rays(seed=seed)
    mint, maxt = _rays_t(o.shape[0], maxt=5.0 if any_hit else 1e30)
    ref = traverse.trace(*tables, o, d, mint, maxt, any_hit=any_hit)
    got = trace_kernel.trace(*tables, o, d, mint, maxt, any_hit=any_hit,
                             interpret=True)
    _assert_same(got, ref)


@pytest.mark.parametrize("max_leaf", [1, 2, 8])
def test_parity_across_leaf_sizes(max_leaf):
    _, _, tables, o, d = _scene_and_rays(seed=2, max_leaf=max_leaf)
    mint, maxt = _rays_t(o.shape[0])
    ref = traverse.trace(*tables, o, d, mint, maxt, max_leaf=max_leaf)
    got = trace_kernel.trace(*tables, o, d, mint, maxt, max_leaf=max_leaf,
                             interpret=True)
    _assert_same(got, ref)


@pytest.mark.parametrize("n_rays", [1, 127, 129, 1000])
def test_ray_counts_off_the_block(n_rays):
    """Ray counts that are not a multiple of BLOCK are padded with dead
    lanes and cut back: shapes and results match the reference."""
    _, _, tables, o, d = _scene_and_rays(seed=4, n_rays=1024)
    o, d = o[:n_rays], d[:n_rays]
    mint, maxt = _rays_t(n_rays)
    got = trace_kernel.trace(*tables, o, d, mint, maxt, interpret=True)
    assert all(v.shape == (n_rays,) for v in got)
    _assert_same(got, traverse.trace(*tables, o, d, mint, maxt))


@pytest.mark.parametrize("backend", ["interpret", "jnp"])
def test_dead_rays_report_no_hit(backend):
    """maxt <= mint marks a finished ray: no hit, t = BIG_T, tri = -1,
    on the kernel and on the reference alike."""
    _, _, tables, o, d = _scene_and_rays(seed=8, n_rays=256)
    mint = jnp.full((256,), isect.BIG_T, jnp.float32)
    maxt = jnp.zeros((256,), jnp.float32)
    if backend == "jnp":
        res = traverse.trace(*tables, o, d, mint, maxt)
    else:
        res = trace_kernel.trace(*tables, o, d, mint, maxt, interpret=True)
    assert not np.asarray(res.hit).any()
    assert (np.asarray(res.tri) == -1).all()
    assert (np.asarray(res.t) == isect.BIG_T).all()


def test_half_dead_wavefront():
    _, _, tables, o, d = _scene_and_rays(seed=9, n_rays=512)
    alive = jnp.arange(512) % 3 != 0
    mint = jnp.where(alive, 1e-4, isect.BIG_T)
    maxt = jnp.where(alive, 1e30, 0.0)
    got = trace_kernel.trace(*tables, o, d, mint, maxt, interpret=True)
    _assert_same(got, traverse.trace(*tables, o, d, mint, maxt))
    assert not np.asarray(got.hit)[~np.asarray(alive)].any()


def test_pack_tables_row_widths():
    _, bvh, tables, _, _ = _scene_and_rays(seed=0, n_rays=8)
    nodes, meta, tris = trace_kernel.pack_tables(*tables)
    assert nodes.shape == (bvh.num_nodes, trace_kernel.NODE_W)
    assert meta.shape == (bvh.num_nodes, trace_kernel.META_W)
    assert tris.shape == (tables[2].shape[0], trace_kernel.TRI_W)
    np.testing.assert_array_equal(np.asarray(nodes[:, :6]), bvh.bounds)
    np.testing.assert_array_equal(np.asarray(meta[:, :3]), bvh.meta)
    assert not np.asarray(tris[:, 9:]).any()


@pytest.mark.parametrize("platform,env,expected", [
    ("gpu", None, "kernel"),
    ("cpu", None, "jnp"),
    ("gpu", "jnp", "jnp"),
    ("cpu", "kernel", "kernel"),
])
def test_default_backend_choice(monkeypatch, platform, env, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if env is None:
        monkeypatch.delenv("GOBLIN_TRACE", raising=False)
    else:
        monkeypatch.setenv("GOBLIN_TRACE", env)
    assert bake.default_trace_backend() == expected


def test_unknown_backend_name_raises(monkeypatch):
    monkeypatch.setenv("GOBLIN_TRACE", "pallas")
    with pytest.raises(ValueError, match="GOBLIN_TRACE"):
        bake.default_trace_backend()


def test_interpret_is_chosen_through_bake_only(monkeypatch):
    monkeypatch.setenv("GOBLIN_TRACE", "interpret")
    with pytest.raises(ValueError, match="GOBLIN_TRACE"):
        bake.default_trace_backend()
    monkeypatch.delenv("GOBLIN_TRACE")
    _, meta = _sphere_scene("interpret")
    assert meta.trace_backend == "interpret"
    with pytest.raises(ValueError, match="trace_backend"):
        _sphere_scene("pallas")


def test_compiled_kernel_off_gpu_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    _, _, tables, o, d = _scene_and_rays(seed=0, n_rays=8)
    mint, maxt = _rays_t(8)
    with pytest.raises(ValueError, match="GPU"):
        trace_kernel.trace(*tables, o, d, mint, maxt)


def _sphere_scene(backend):
    builder = bake.SceneBuilder()
    builder.add_instance(bake.InstanceRecord(
        geometry=make_sphere_mesh(1.0, 12, 24), material=0,
        to_world=np.eye(4, dtype=np.float32),
    ))
    return builder.bake(trace_backend=backend)


def _camera_rays(n=256, seed=0):
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([0.2, 0.1, -4.0]), (n, 1))
    tgt = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    tgt[:, 2] = 0.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("sort", ["dir", "octant", True, "compact"])
def test_ray_order_wraps_either_trace(sort):
    """The optional coherence permutations wrap the kernel and the jnp
    trace alike, and hand results back in the caller's order."""
    o, d = _camera_rays(300, seed=1)
    d = jnp.where(jnp.arange(300)[:, None] % 2 == 0, d, -d)
    alive = jnp.arange(300) % 5 != 0
    mint = jnp.where(alive, 1e-4, isect.BIG_T)
    maxt = jnp.where(alive, 1e30, 0.0)
    for backend in ("interpret", "jnp"):
        scene, meta = _sphere_scene(backend)
        plain = scn.trace_rays(scene, meta, o, d, mint, maxt, sort=False)
        if sort == "compact":
            meta.trace_compact = True
            got = scn.trace_rays(scene, meta, o, d, mint, maxt, sort=False)
        else:
            got = scn.trace_rays(scene, meta, o, d, mint, maxt, sort=sort)
        _assert_same(got, plain)
        assert np.asarray(plain.hit).sum() > 50


def test_intersect_gradient_matches_jnp_backend():
    """jax.grad through scene.intersect: the trace is detached, so the
    vertex gradient flows through the hit refine alone and must not
    depend on which trace picked the triangles."""
    o, d = _camera_rays()
    mint, maxt = _rays_t(o.shape[0])
    w = jnp.asarray(np.random.default_rng(3).normal(size=(o.shape[0], 3)),
                    jnp.float32)
    grads = {}
    for backend in ("interpret", "jnp"):
        scene, meta = _sphere_scene(backend)

        def loss(soup, scene=scene, meta=meta):
            frag = scn.intersect(dict(scene, tri_soup=soup), meta, o, d,
                                 mint, maxt)
            return jnp.sum(jnp.where(frag["hit"][:, None],
                                     frag["p"] * w + frag["ns"], 0.0))

        grads[backend] = np.asarray(jax.grad(loss)(scene["tri_soup"]))
    assert np.abs(grads["jnp"]).sum() > 0
    np.testing.assert_allclose(grads["interpret"], grads["jnp"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp_on_gpu():
    _, _, tables, o, d = _scene_and_rays(seed=0, n_rays=4096)
    mint, maxt = _rays_t(4096)
    for any_hit in (False, True):
        ref = traverse.trace(*tables, o, d, mint, maxt, any_hit=any_hit)
        got = trace_kernel.trace(*tables, o, d, mint, maxt, any_hit=any_hit)
        _assert_same(got, ref)
