"""Device-mesh sharding of the render wavefront.

The reference scales by std::thread over image tiles in one process
(src/GoblinThreadPool.cpp, SURVEY.md §2.9). Here the scaling axis is the
ray wavefront: pixel batches are sharded over a 1-D ``rays`` mesh axis
(data parallel) and the scene SoA is replicated. The radiance function
runs under shard_map, so each device traces its own rays (the GPU trace
kernel is a custom call the GSPMD partitioner cannot split); film splats
land in replicated film arrays and parameter gradients are summed across
the mesh (XLA inserts the collectives: NCCL over NVLink on GPUs, the fake
CPU mesh in tests).

On multi-host slices the same mesh spans hosts: processes bootstrap via
parallel.multihost.init_from_env() (jax.distributed.initialize), after
which jax.devices() is the global device list and make_mesh() spans
hosts; host-side arrays are placed with multihost.global_put so each
process contributes its addressable shards. tests/test_multihost.py
runs the real 2-process × 4-fake-device path and asserts film equality
with the single-process render.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..camera import film as film_mod
from ..core.rng import hash_uniform
from ..integrators import common


def make_mesh(n_devices: int | None = None, axis: str = "rays") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_li(li_fn, mesh: Mesh, axis: str = "rays"):
    """li_fn mapped over the mesh's ray axis: every leaf of the ray dict
    and the pixel ids are split along their first dimension, the scene
    and the sample index are replicated, and each device runs the whole
    radiance function on its own rays."""

    def li(scene, meta, ray, pixel_ids, s_idx, seed):
        return jax.shard_map(
            lambda sc, r, pix, s: li_fn(sc, meta, r, pix, s, seed),
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P()),
            out_specs=P(axis),
            # the integrators start loop carries from unsharded constants
            check_vma=False,
        )(scene, ray, pixel_ids, s_idx)

    return li


def replicate_scene(scene, mesh: Mesh):
    """Place every scene array replicated on the mesh."""
    from .multihost import global_put

    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: global_put(a, rep), scene)


def make_sharded_render_step(scene, meta, li_fn, mesh: Mesh,
                             axis: str = "rays"):
    """-> (step_fn, sharded_scene). step_fn(color, weight, pixel_ids,
    valid, s_idx) renders one sharded chunk and accumulates into the
    (replicated) film arrays."""
    cam = meta.camera
    spec = cam.film
    seed = int(meta.settings.get("seed", 0))
    n_grid = common.spp_grid(int(meta.settings.get("sample_per_pixel", 1)))
    li_fn = shard_li(li_fn, mesh, axis)
    scene_sh = replicate_scene(scene, mesh)
    ray_sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    @partial(
        jax.jit,
        donate_argnums=(0, 1),
        in_shardings=(rep, rep, ray_sh, ray_sh, None),
        out_shardings=(rep, rep),
    )
    def step(color, weight, pixel_ids, valid, s_idx):
        x, y = common.pixel_samples(seed, pixel_ids, spec.x_res, s_idx, n_grid)
        lu = hash_uniform(seed, pixel_ids, s_idx, common.BOUNCE_CAMERA,
                          common.DIM_LENS_U)
        lv = hash_uniform(seed, pixel_ids, s_idx, common.BOUNCE_CAMERA,
                          common.DIM_LENS_V)
        ray = cam.generate_ray(x, y, lu, lv)
        L = li_fn(scene_sh, meta, ray, pixel_ids, s_idx, seed)
        L = jnp.where(valid[:, None], L, jnp.nan)
        return film_mod.splat(spec, color, weight, x, y, L)

    return step, scene_sh


def render_sharded(scene, meta, li_fn, mesh: Mesh, spp=None,
                   chunk_size=1 << 15, axis: str = "rays"):
    """Full sharded render (the multi-chip analogue of
    integrators.common.render)."""
    spec = meta.camera.film
    if spp is None:
        spp = int(meta.settings.get("sample_per_pixel", 1))
    n_grid = common.spp_grid(spp)
    n_spp = n_grid * n_grid
    step, scene_sh = make_sharded_render_step(scene, meta, li_fn, mesh, axis)

    n_dev = len(mesh.devices.reshape(-1))
    chunk_size = max(n_dev, (chunk_size // n_dev) * n_dev)

    xs_, xc, ys_, yc = spec.crop_window()
    pixel_ids_all = (
        (np.arange(ys_, ys_ + yc)[:, None] * spec.x_res
         + np.arange(xs_, xs_ + xc)[None, :]).reshape(-1).astype(np.int32)
    )
    n_pix = pixel_ids_all.size
    n_chunks = (n_pix + chunk_size - 1) // chunk_size
    pad = n_chunks * chunk_size - n_pix
    valid_all = np.ones(n_pix + pad, bool)
    if pad:
        pixel_ids_all = np.concatenate(
            [pixel_ids_all, np.full(pad, pixel_ids_all[-1], np.int32)]
        )
        valid_all[n_pix:] = False

    from .multihost import global_put

    rep = NamedSharding(mesh, P())
    ray_sh = NamedSharding(mesh, P(axis))
    color, weight = film_mod.new_film(spec)
    color = global_put(color, rep)
    weight = global_put(weight, rep)
    for s in range(n_spp):
        for c in range(n_chunks):
            sl = slice(c * chunk_size, (c + 1) * chunk_size)
            color, weight = step(
                color, weight,
                global_put(pixel_ids_all[sl], ray_sh),
                global_put(valid_all[sl], ray_sh),
                jnp.int32(s),
            )
    return film_mod.to_image(color, weight, normalize=True)


def make_sharded_train_step(scene, meta, li_fn, mesh: Mesh,
                            axis: str = "rays", boundary_grad_fn=None):
    """Differentiable sharded step: grads of an image loss w.r.t. light
    emission + the texture atlas (material colors), reduced across the
    mesh by the partitioner — the renderer analogue of a DP training step
    with gradient all-reduce over ICI.

    boundary_grad_fn (opt-in): callable (params, pixel_ids, s_idx) ->
    grads-pytree added to the AD grads. AD cannot see the visibility
    boundary term (a moving occluder changes WHICH samples are blocked);
    integrators/edge_grad.mesh_boundary_grad supplies it via silhouette
    edge sampling — wrap it to your parameterization and pass it here
    (tests/test_gradients.py shows the wiring)."""
    cam = meta.camera
    spec = cam.film
    seed = int(meta.settings.get("seed", 0))
    li_fn = shard_li(li_fn, mesh, axis)
    scene_sh = replicate_scene(scene, mesh)
    ray_sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    @partial(
        jax.jit,
        in_shardings=((rep, rep), ray_sh, None),
        out_shardings=(None, (rep, rep)),
    )
    def train_step(params, pixel_ids, s_idx):
        light_color, tex_atlas = params

        def loss_fn(lc, ta):
            sc = dict(scene_sh)
            sc["lights"] = dict(scene_sh["lights"])
            sc["lights"]["color"] = lc
            sc["tex_atlas"] = ta
            x, y = common.pixel_samples(seed, pixel_ids, spec.x_res, s_idx, 1)
            ray = cam.generate_ray(x, y)
            L = li_fn(sc, meta, ray, pixel_ids, s_idx, seed)
            return jnp.mean(L)

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            light_color, tex_atlas
        )
        if boundary_grad_fn is not None:
            extra = boundary_grad_fn(params, pixel_ids, s_idx)
            grads = jax.tree_util.tree_map(jnp.add, grads, extra)
        return loss, grads

    return train_step, scene_sh


def make_sharded_render_pass(scene, meta, li_fn, mesh: Mesh, spp, seed,
                             chunk_size=1 << 16, axis: str = "rays"):
    """Sharded mirror of common.make_render_pass: radiance chunks are
    constrained to the mesh's ray axis, the dense full-frame filter
    splat stays replicated (the per-pass image is small; XLA inserts the
    all-gather). Returns (render_pass, n_spp) — same contract, so
    bench/driver code can time the exact sharded production pass.

    This replaces the per-chunk scatter splat of make_sharded_render_step
    for camera-sampled integrators; this path's overhead is the
    collective + partitioning only."""
    cam = meta.camera
    spec = cam.film
    n_grid = common.spp_grid(spp)
    n_spp = n_grid * n_grid
    li_fn = shard_li(li_fn, mesh, axis)
    scene_sh = replicate_scene(scene, mesh)
    ray_sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    xs_, xc, ys_, yc = spec.crop_window()
    row_major = (
        (np.arange(ys_, ys_ + yc)[:, None] * spec.x_res
         + np.arange(xs_, xs_ + xc)[None, :]).reshape(-1).astype(np.int32)
    )
    n_pix = row_major.size
    perm, inv_perm = common.tile_permutation(yc, xc)
    pixel_ids_all = row_major[perm]

    n_dev = len(mesh.devices.reshape(-1))
    chunk_size = max(n_dev * 1024,
                     (min(chunk_size, n_pix) // (n_dev * 1024))
                     * n_dev * 1024)
    n_chunks = (n_pix + chunk_size - 1) // chunk_size
    pad = n_chunks * chunk_size - n_pix
    if pad:
        pixel_ids_all = np.concatenate(
            [pixel_ids_all, np.full(pad, pixel_ids_all[-1], np.int32)]
        )

    from .multihost import global_put

    pix_dev = global_put(pixel_ids_all, rep)
    inv_perm_dev = global_put(inv_perm, rep)
    ids_rm = global_put(row_major, rep)

    @partial(jax.jit, donate_argnums=(0, 1),
              in_shardings=(rep, rep, None), out_shardings=(rep, rep))
    def render_pass(color, weight, s_idx):
        def chunk_body(c, L_acc):
            pixel_ids = jax.lax.dynamic_slice(
                pix_dev, (c * chunk_size,), (chunk_size,)
            )
            pixel_ids = jax.lax.with_sharding_constraint(pixel_ids, ray_sh)
            x, y = common.pixel_samples(seed, pixel_ids, spec.x_res, s_idx,
                                        common.spp_grid(spp))
            lu = hash_uniform(seed, pixel_ids, s_idx, common.BOUNCE_CAMERA,
                              common.DIM_LENS_U)
            lv = hash_uniform(seed, pixel_ids, s_idx, common.BOUNCE_CAMERA,
                              common.DIM_LENS_V)
            ray = cam.generate_ray(x, y, lu, lv)
            L = li_fn(scene_sh, meta, ray, pixel_ids, s_idx, seed)
            L = jax.lax.with_sharding_constraint(L, ray_sh)
            return jax.lax.dynamic_update_slice(L_acc, L, (c * chunk_size, 0))

        L_flat = jax.lax.fori_loop(
            0, n_chunks, chunk_body,
            jnp.zeros((n_chunks * chunk_size, 3), jnp.float32),
        )
        L_rm = jnp.take(L_flat[:n_pix], inv_perm_dev, axis=0)
        jx = hash_uniform(seed, ids_rm, s_idx, common.BOUNCE_CAMERA,
                          common.DIM_PIXEL_X)
        jy = hash_uniform(seed, ids_rm, s_idx, common.BOUNCE_CAMERA,
                          common.DIM_PIXEL_Y)
        n_g = common.spp_grid(spp)
        sx = (s_idx % n_g).astype(jnp.float32)
        sy = (s_idx // n_g).astype(jnp.float32)
        jx = (sx + jx) / n_g
        jy = (sy + jy) / n_g
        return film_mod.splat_dense(
            spec, color, weight,
            jx.reshape(yc, xc), jy.reshape(yc, xc),
            L_rm.reshape(yc, xc, 3), ys_, xs_,
        )

    return render_pass, n_spp


def render_sharded_dense(scene, meta, li_fn, mesh: Mesh, spp=None,
                         chunk_size=1 << 16):
    """Full sharded render via the dense-splat pass."""
    spec = meta.camera.film
    if spp is None:
        spp = int(meta.settings.get("sample_per_pixel", 1))
    render_pass, n_spp = make_sharded_render_pass(
        scene, meta, li_fn, mesh, spp,
        int(meta.settings.get("seed", 0)), chunk_size,
    )
    from .multihost import global_put

    rep = NamedSharding(mesh, P())
    color, weight = film_mod.new_film(spec)
    color = global_put(color, rep)
    weight = global_put(weight, rep)
    for s in range(n_spp):
        color, weight = render_pass(color, weight, jnp.int32(s))
    return film_mod.to_image(color, weight, normalize=True)
