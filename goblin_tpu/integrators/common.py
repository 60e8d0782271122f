"""Wavefront render driver shared by all integrators.

The reference's per-thread tile loop (RenderTask::run,
src/GoblinRenderer.cpp:29-52) becomes: for each spp index, jit-render a
flat chunk of pixels — raygen -> Li (integrator-specific batched fn) ->
film scatter-add — with film arrays donated across chunk calls. Sample
decorrelation uses the stateless hash streams (core/rng.py) with
per-pixel stratification over a ceil(sqrt(spp))^2 grid, the wavefront
analogue of the reference's stratified Sampler (spp rounded to a square,
src/GoblinSampler.cpp:23-33,63-197).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import film as film_mod
from ..core.rng import hash_uniform

# reserved dimension ids for the hash streams
DIM_PIXEL_X = 0
DIM_PIXEL_Y = 1
DIM_LENS_U = 2
DIM_LENS_V = 3
DIM_BASE = 4  # integrator dims start here
# bounce id used for camera-sample dims
BOUNCE_CAMERA = 0x7FFF
# edge in pixels of the screen tiles that order a pass's camera rays, so
# that neighbouring rays of a wavefront share BVH nodes
SCREEN_TILE = 32


def spp_grid(spp: int) -> int:
    """Stratification grid edge: smallest n with n*n >= spp (reference
    roundToSquare semantics — spp is rounded up to a perfect square)."""
    return int(np.ceil(np.sqrt(max(1, spp))))




def tile_permutation(yc: int, xc: int):
    """(perm, inv_perm) over a yc x xc crop: perm lists row-major pixel
    indices tile by tile (SCREEN_TILE squares), inv_perm undoes it."""
    t = SCREEN_TILE
    idx = np.arange(yc * xc, dtype=np.int32).reshape(yc, xc)
    perm = np.concatenate([
        idx[ty:ty + t, tx:tx + t].reshape(-1)
        for ty in range(0, yc, t)
        for tx in range(0, xc, t)
    ])
    inv_perm = np.empty(yc * xc, np.int32)
    inv_perm[perm] = np.arange(yc * xc, dtype=np.int32)
    return perm, inv_perm


def stratified_1d(seed, pixel_ids, s_idx, n_spp, bounce, dim):
    """Stratified-shuffled 1D sample for integrator dims: sample index
    s_idx maps to stratum (s + per-(pixel,bounce,dim) rotation) mod n_spp,
    jittered — each pixel's stream visits every stratum exactly once over
    an spp cycle (the wavefront analogue of the reference Sampler's
    sub-strata shuffle, src/GoblinSampler.cpp:127-150; a random rotation
    is a permutation, so per-sample uniformity and stratified coverage
    both hold)."""
    off = jnp.floor(
        hash_uniform(seed, pixel_ids, 0x57A7, bounce, dim) * n_spp
    ).astype(jnp.int32)
    cell = (s_idx + off) % n_spp
    j = hash_uniform(seed, pixel_ids, s_idx, bounce, dim)
    return (cell.astype(jnp.float32) + j) / n_spp


def stratified_2d(seed, pixel_ids, s_idx, n_spp, bounce, dim_a, dim_b):
    """Stratified-shuffled 2D pair over the n_grid x n_grid cell grid
    (n_spp is always a perfect square — reference roundToSquare)."""
    g = int(np.sqrt(n_spp))
    off = jnp.floor(
        hash_uniform(seed, pixel_ids, 0x57A8, bounce, dim_a) * n_spp
    ).astype(jnp.int32)
    cell = (s_idx + off) % n_spp
    j1 = hash_uniform(seed, pixel_ids, s_idx, bounce, dim_a)
    j2 = hash_uniform(seed, pixel_ids, s_idx, bounce, dim_b)
    u1 = ((cell % g).astype(jnp.float32) + j1) / g
    u2 = ((cell // g).astype(jnp.float32) + j2) / g
    return u1, u2


def pixel_samples(seed, pixel_ids, x_res, s_idx, n_grid):
    """Stratified-jittered continuous image coords for sample index s_idx."""
    px = (pixel_ids % x_res).astype(jnp.float32)
    py = (pixel_ids // x_res).astype(jnp.float32)
    sx = (s_idx % n_grid).astype(jnp.float32)
    sy = (s_idx // n_grid).astype(jnp.float32)
    jx = hash_uniform(seed, pixel_ids, s_idx, BOUNCE_CAMERA, DIM_PIXEL_X)
    jy = hash_uniform(seed, pixel_ids, s_idx, BOUNCE_CAMERA, DIM_PIXEL_Y)
    x = px + (sx + jx) / n_grid
    y = py + (sy + jy) / n_grid
    return x, y


def make_render_pass(scene, meta, li_fn, spp, seed, chunk_size=1 << 16):
    """Build the jitted single-pass render fn (one full-frame stratified
    sample per crop pixel -> dense filter splat into the film).

    Returns (render_pass, n_spp) where render_pass(color, weight, s_idx)
    -> updated (color, weight) with donated film buffers. Exposed
    separately from render() so bench.py times the exact production pass.
    """
    cam = meta.camera
    spec = cam.film
    n_grid = spp_grid(spp)
    n_spp = n_grid * n_grid

    xs_, xc, ys_, yc = spec.crop_window()
    row_major = (
        (np.arange(ys_, ys_ + yc)[:, None] * spec.x_res
         + np.arange(xs_, xs_ + xc)[None, :]).reshape(-1).astype(np.int32)
    )
    n_pix = row_major.size
    # tile-coherent ray order; perm maps tile order -> row-major index
    perm, inv_perm = tile_permutation(yc, xc)
    pixel_ids_all = row_major[perm]
    inv_perm_dev = jnp.asarray(inv_perm)
    # don't pad a small frame up to a huge chunk
    chunk_size = min(chunk_size, ((n_pix + 1023) // 1024) * 1024)
    n_chunks = (n_pix + chunk_size - 1) // chunk_size
    # pad to full chunks with repeated last pixel, dropped before splat
    pad = n_chunks * chunk_size - n_pix
    if pad:
        pixel_ids_all = np.concatenate(
            [pixel_ids_all, np.full(pad, pixel_ids_all[-1], np.int32)]
        )

    pix_dev = jnp.asarray(pixel_ids_all)

    @partial(jax.jit, donate_argnums=(0, 1))
    def render_pass(color, weight, s_idx):
        # one device dispatch per pass: chunked radiance inside a fori,
        # then a dense (scatter-free) filter splat of the pass image
        def chunk_body(c, L_acc):
            pixel_ids = jax.lax.dynamic_slice(
                pix_dev, (c * chunk_size,), (chunk_size,)
            )
            x, y = pixel_samples(seed, pixel_ids, spec.x_res, s_idx, n_grid)
            lu = hash_uniform(seed, pixel_ids, s_idx, BOUNCE_CAMERA, DIM_LENS_U)
            lv = hash_uniform(seed, pixel_ids, s_idx, BOUNCE_CAMERA, DIM_LENS_V)
            ray = cam.generate_ray(x, y, lu, lv)
            L = li_fn(scene, meta, ray, pixel_ids, s_idx, seed)
            return jax.lax.dynamic_update_slice(L_acc, L, (c * chunk_size, 0))

        L_flat = jax.lax.fori_loop(
            0, n_chunks, chunk_body,
            jnp.zeros((n_chunks * chunk_size, 3), jnp.float32),
        )
        # back to row-major for the dense splat
        L_rm = jnp.take(L_flat[:n_pix], inv_perm_dev, axis=0)
        ids = jnp.asarray(row_major)
        jx = hash_uniform(seed, ids, s_idx, BOUNCE_CAMERA, DIM_PIXEL_X)
        jy = hash_uniform(seed, ids, s_idx, BOUNCE_CAMERA, DIM_PIXEL_Y)
        sx = (s_idx % n_grid).astype(jnp.float32)
        sy = (s_idx // n_grid).astype(jnp.float32)
        jx = (sx + jx) / n_grid
        jy = (sy + jy) / n_grid
        return film_mod.splat_dense(
            spec, color, weight,
            jx.reshape(yc, xc), jy.reshape(yc, xc),
            L_rm.reshape(yc, xc, 3), ys_, xs_,
        )

    return render_pass, n_spp


def render(scene, meta, li_fn, spp=None, seed=None, chunk_size=1 << 16,
           report=None):
    """Render with a batched radiance function.

    li_fn(scene, meta, ray, pixel_ids, s_idx, seed) -> (R, 3) radiance.
    Returns the resolved image (H, W, 3) jnp array.
    """
    settings = meta.settings
    if spp is None:
        spp = int(settings.get("sample_per_pixel", 1))
    if seed is None:
        seed = int(settings.get("seed", 0))
    render_pass, n_spp = make_render_pass(
        scene, meta, li_fn, spp, seed, chunk_size
    )
    color, weight = film_mod.new_film(meta.camera.film)
    for s in range(n_spp):
        color, weight = render_pass(color, weight, jnp.int32(s))
        if report is not None:
            report(s + 1, n_spp)
    return film_mod.to_image(color, weight, normalize=True)


def jit_cache(meta, key, builder):
    """Per-(meta, scene) cache of built jitted passes.

    The splatting-method drivers (LT/BDPT/SPPM) build their jitted
    chunk functions inside the render call; without caching, EVERY
    render call creates fresh closures and pays a full retrace (tens of
    seconds for the big pass graphs) even when the persistent
    compilation cache skips XLA itself. Keyed storage lives on the meta
    object so same-scene re-renders reuse the compiled passes; include
    id(scene) in `key` when the builder closes over scene arrays."""
    cache = getattr(meta, "_jit_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(meta, "_jit_cache", cache)
    if key not in cache:
        cache[key] = builder()
    return cache[key]
