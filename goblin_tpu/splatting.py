"""Splatting integrators: light tracer (BDPT and SPPM build on the same
machinery).

Wavefront light tracing (reference splatFilmT1,
src/GoblinLightTracer.cpp:73-171): a batch of light paths walks the scene
with BSDFImportance transport, every surface vertex (plus the light
vertex itself) is connected to the camera with a visibility ray, and the
contribution is filter-splat at the projected pixel. Film is resolved
with normalize=False scaled by pixelCount/totalPaths
(src/GoblinLightTracer.cpp:360-365).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .camera import film as film_mod
from .core import vecmath as vm
from .core.rng import hash_uniform
from .integrators.common import DIM_BASE
from .integrators.materials import gather_material
from .integrators.path import _em_tri_data
from .lights import lights as lt
from .scene import intersect as scn
from .shading import bsdf as bx

def _env_le_at(scene, meta, wo):
    """Env radiance for emission eval: ImageBasedLight::eval looks the
    map up at -wo (src/GoblinLight.cpp:600-608). None without an IBL."""
    if not meta.has_env:
        return None
    from .lights import envmap

    return envmap.eval_env(scene, meta, -wo)


# dim layout for the light walk
DIM_PICK = DIM_BASE + 0
DIM_POS1 = DIM_BASE + 1
DIM_POS2 = DIM_BASE + 2
DIM_DIR1 = DIM_BASE + 3
DIM_DIR2 = DIM_BASE + 4
DIM_B1 = DIM_BASE + 5
DIM_B2 = DIM_BASE + 6
DIM_BC = DIM_BASE + 7


def walk_light_paths(scene, meta, path_ids, s_idx, seed, max_path_length,
                     mode=bx.MODE_IMPORTANCE):
    """Run the light walk. Returns (emission dict, stacked vertices).

    verts arrays are stacked (D, R, ...) with D = max_path_length - 1
    surface vertices; verts["tp"] is the path throughput UP TO each
    vertex (including the light's positional + directional terms and all
    preceding bsdf*cos/pdf factors).
    """
    lights = scene["lights"]
    tri_data = _em_tri_data(scene)
    R = path_ids.shape[0]

    u_pick = hash_uniform(seed, path_ids, s_idx, 0, DIM_PICK)
    lid, pick_pdf = lt.pick_light(lights, u_pick)
    em = lt.sample_emission(
        lights, tri_data, lid,
        hash_uniform(seed, path_ids, s_idx, 0, DIM_POS1),
        hash_uniform(seed, path_ids, s_idx, 0, DIM_POS2),
        hash_uniform(seed, path_ids, s_idx, 0, DIM_DIR1),
        hash_uniform(seed, path_ids, s_idx, 0, DIM_DIR2),
    )
    em["lid"] = lid
    em["pick_pdf"] = pick_pdf
    # throughput of the light vertex itself: 1/(pdf_pos * pick_pdf)
    em["vertex_tp"] = 1.0 / jnp.maximum(em["pdf_pos"] * pick_pdf, 1e-20)
    # walk throughput after leaving the light (delta lights skip |cos|:
    # reference splatFilmT1 throughput init)
    tp0 = em["vertex_tp"] * jnp.where(
        em["is_delta"],
        1.0 / jnp.maximum(em["pdf_dir"], 1e-20),
        vm.absdot(em["n"], em["dir"]) / jnp.maximum(em["pdf_dir"], 1e-20),
    )

    def walk_body(carry, b):
        o, d, eps, tp, active = carry
        frag = scn.intersect(
            scene, meta, o, d, eps, jnp.full((R,), 3.0e37, jnp.float32)
        )
        valid = active & frag["hit"]
        vert = {
            "p": frag["p"],
            "ns": frag["ns"],
            "dpdu": frag["dpdu"],
            "uv": frag["uv"],
            "mat": frag["mat"],
            "light": frag["light"],
            "eps": frag["eps"],
            "wo_prev": frag["wo"],
            "tp": jnp.where(valid[:, None], tp, 0.0),
            "valid": valid,
            "is_lens": frag["is_lens"] & valid,
        }
        mat = gather_material(
            scene, meta, frag,
            u_mask=hash_uniform(seed, path_ids, s_idx, b, DIM_BC + 1),
        )
        bs = bx.bsdf_sample(
            mat, frag["ns"], frag["dpdu"], frag["wo"],
            hash_uniform(seed, path_ids, s_idx, b, DIM_B1),
            hash_uniform(seed, path_ids, s_idx, b, DIM_B2),
            hash_uniform(seed, path_ids, s_idx, b, DIM_BC),
            bx.BSDF_ALL, mode=mode,
        )
        cont = valid & bs["valid"] & jnp.any(bs["f"] > 0.0, axis=-1)
        tp2 = tp * bs["f"] * (
            vm.absdot(bs["wi"], frag["ns"]) / jnp.maximum(bs["pdf"], 1e-20)
        )[:, None]
        tp2 = jnp.where(cont[:, None], tp2, 0.0)
        return (frag["p"], bs["wi"], frag["eps"], tp2, cont), vert

    init = (
        em["p"],
        em["dir"],
        jnp.full((R,), 1e-3, jnp.float32),
        jnp.broadcast_to(tp0[:, None], (R, 3)).astype(jnp.float32),
        jnp.ones((R,), bool),
    )
    _, verts = jax.lax.scan(walk_body, init, jnp.arange(1, max_path_length))
    return em, verts


def light_trace_contributions(scene, meta, path_ids, s_idx, seed,
                              max_path_length):
    """-> (x, y, contribution) flattened over all camera connections."""
    lights = scene["lights"]
    cam = meta.camera
    R = path_ids.shape[0]

    lu = hash_uniform(seed, path_ids, s_idx, 0x7FFE, 0)
    lv = hash_uniform(seed, path_ids, s_idx, 0x7FFE, 1)
    p_cam, n_cam, pdf_cam = cam.sample_position(lu, lv)
    cam_tp = 1.0 / jnp.maximum(pdf_cam, 1e-20)

    em, verts = walk_light_paths(
        scene, meta, path_ids, s_idx, seed, max_path_length
    )
    lid = em["lid"]
    p_light, n_light, dir_light = em["p"], em["n"], em["dir"]
    xs, ys, cs = [], [], []

    # ---- s == 1: the light vertex itself
    to_cam = p_cam - p_light
    dist = jnp.maximum(vm.length(to_cam), 1e-20)
    wo = to_cam / dist[:, None]
    sx, sy, _, scr_ok = cam.world_to_screen(p_light, p_cam)
    eps = 1e-3 * dist
    occ = scn.occluded(scene, meta, p_light, wo, eps, dist - eps)
    fsl = lt.eval_emission(lights, lid, n_light, wo,
                           env_le=_env_le_at(scene, meta, wo))
    G = vm.absdot(n_cam, wo) / jnp.maximum(dist * dist, 1e-20)
    G = G * jnp.where(em["is_delta"], 1.0, vm.absdot(n_light, wo))
    we = cam.eval_we(p_cam, p_light)
    c1 = fsl * (we * G * cam_tp * em["vertex_tp"])[:, None]
    ok1 = scr_ok & ~occ & jnp.any(fsl > 0, axis=-1)
    xs.append(jnp.where(ok1, sx, -1e9))
    ys.append(jnp.where(ok1, sy, -1e9))
    cs.append(jnp.where(ok1[:, None], c1, 0.0))

    # ---- s >= 2: surface vertices (static unroll over the stack)
    fsl_light = lt.eval_emission(lights, lid, n_light, dir_light,
                                 env_le=_env_le_at(scene, meta, dir_light))
    D = max_path_length - 1
    for d in range(D):
        p = verts["p"][d]
        ns = verts["ns"][d]
        valid = verts["valid"][d]
        tp = verts["tp"][d]
        to_cam = p_cam - p
        dist = jnp.maximum(vm.length(to_cam), 1e-20)
        wo = to_cam / dist[:, None]
        sx, sy, _, scr_ok = cam.world_to_screen(p, p_cam)
        eps = 1e-3 * dist
        occ = scn.occluded(scene, meta, p, wo, eps, dist - eps)
        frag_d = {"mat": verts["mat"][d], "uv": verts["uv"][d]}
        mat = gather_material(scene, meta, frag_d)
        f = bx.bsdf_eval(mat, ns, wo, verts["wo_prev"][d], bx.BSDF_ALL,
                         mode=bx.MODE_IMPORTANCE)
        fsl = f * fsl_light
        G = vm.absdot(ns, wo) * vm.absdot(n_cam, wo) / jnp.maximum(
            dist * dist, 1e-20
        )
        we = cam.eval_we(p_cam, p)
        c = fsl * tp * (we * G * cam_tp)[:, None]
        ok = valid & scr_ok & ~occ & jnp.any(fsl > 0, axis=-1)
        xs.append(jnp.where(ok, sx, -1e9))
        ys.append(jnp.where(ok, sy, -1e9))
        cs.append(jnp.where(ok[:, None], c, 0.0))

    return jnp.concatenate(xs), jnp.concatenate(ys), jnp.concatenate(cs)


def light_trace_t0_contributions(scene, meta, path_ids, s_idx, seed,
                                 max_path_length):
    """splatFilmT0 (reference src/GoblinLightTracer.cpp:180-238): the
    light walk deposits only when a vertex hits the camera-lens disk —
    contribution = light.eval * We * throughput-at-lens, splat at the
    re-projected pixel. Requires a lens primitive (lens_radius > 0)."""
    lights = scene["lights"]
    cam = meta.camera
    em, verts = walk_light_paths(
        scene, meta, path_ids, s_idx, seed, max_path_length
    )
    fsl = lt.eval_emission(lights, em["lid"], em["n"], em["dir"],
                           env_le=_env_le_at(scene, meta, em["dir"]))
    xs, ys, cs = [], [], []
    D = max_path_length - 1
    for d in range(D):
        p_lens = verts["p"][d]
        p_prev = em["p"] if d == 0 else verts["p"][d - 1]
        lens_hit = verts["is_lens"][d]
        sx, sy, _, scr_ok = cam.world_to_screen(p_prev, p_lens)
        we = cam.eval_we(p_lens, p_prev)
        c = fsl * verts["tp"][d] * we[:, None]
        ok = lens_hit & scr_ok & jnp.any(c > 0, axis=-1)
        xs.append(jnp.where(ok, sx, -1e9))
        ys.append(jnp.where(ok, sy, -1e9))
        cs.append(jnp.where(ok[:, None], c, 0.0))
    return jnp.concatenate(xs), jnp.concatenate(ys), jnp.concatenate(cs)


def light_trace_s1_contributions(scene, meta, path_ids, s_idx, seed,
                                 max_path_length):
    """splatFilmS1 (reference src/GoblinLightTracer.cpp:239-333): camera
    walk, every vertex connected to ONE light position sample (no MIS) —
    the PT-shaped alternate estimator of the LT verification trio."""
    lights = scene["lights"]
    tri_data = _em_tri_data(scene)
    cam = meta.camera
    spec = cam.film
    R = path_ids.shape[0]

    u_pick = hash_uniform(seed, path_ids, s_idx, 0, DIM_PICK)
    lid, pick_pdf = lt.pick_light(lights, u_pick)
    em = lt.sample_emission(
        lights, tri_data, lid,
        hash_uniform(seed, path_ids, s_idx, 0, DIM_POS1),
        hash_uniform(seed, path_ids, s_idx, 0, DIM_POS2),
        hash_uniform(seed, path_ids, s_idx, 0, DIM_DIR1),
        hash_uniform(seed, path_ids, s_idx, 0, DIM_DIR2),
    )
    p_light, n_light = em["p"], em["n"]
    l_tp = 1.0 / jnp.maximum(em["pdf_pos"] * pick_pdf, 1e-20)

    # camera start: random film position WITHIN THE CROP WINDOW — t1/t0
    # and the driver's path-count normalization are both based on
    # spp * crop pixel count, so s1 paths landing outside the crop would
    # misweight the estimate
    xs_, xc, ys_, yc = spec.crop_window()
    px = xs_ + hash_uniform(seed, path_ids, s_idx, 0x7FFD, 0) * xc
    py = ys_ + hash_uniform(seed, path_ids, s_idx, 0x7FFD, 1) * yc
    lu = hash_uniform(seed, path_ids, s_idx, 0x7FFE, 0)
    lv = hash_uniform(seed, path_ids, s_idx, 0x7FFE, 1)
    p_cam, n_cam, pdf_cam = cam.sample_position(lu, lv)
    dir_e, We, pdf_dir_e = cam.sample_direction(px, py, p_cam)
    cam_tp = 1.0 / jnp.maximum(pdf_cam, 1e-20)
    tp = (cam_tp * vm.absdot(n_cam, dir_e)
          / jnp.maximum(pdf_dir_e, 1e-20))[:, None] * jnp.ones((R, 3))

    # eye walk (importance transport is NOT used: radiance mode — the
    # reference's sampleBSDF default)
    o, dseg, eps = p_cam, dir_e, jnp.full((R,), 1e-3, jnp.float32)
    verts = []
    active = jnp.ones((R,), bool)
    for _ in range(max_path_length - 1):
        frag = scn.intersect(scene, meta, o, dseg, eps,
                             jnp.where(active, 3.0e37, 0.0))
        valid = active & frag["hit"]
        verts.append({
            "p": frag["p"], "ns": frag["ns"], "mat": frag["mat"],
            "uv": frag["uv"], "wo": frag["wo"], "eps": frag["eps"],
            "tp": jnp.where(valid[:, None], tp, 0.0), "valid": valid,
        })
        mat = gather_material(scene, meta, frag)
        bs = bx.bsdf_sample(
            mat, frag["ns"], frag["dpdu"], frag["wo"],
            hash_uniform(seed, path_ids, s_idx, len(verts), DIM_B1),
            hash_uniform(seed, path_ids, s_idx, len(verts), DIM_B2),
            hash_uniform(seed, path_ids, s_idx, len(verts), DIM_BC),
            bx.BSDF_ALL,
        )
        active = valid & bs["valid"] & jnp.any(bs["f"] > 0.0, -1)
        tp = jnp.where(
            active[:, None],
            tp * bs["f"] * (vm.absdot(bs["wi"], frag["ns"])
                            / jnp.maximum(bs["pdf"], 1e-20))[:, None],
            0.0,
        )
        o, dseg, eps = frag["p"], bs["wi"], frag["eps"]

    xs, ys, cs = [], [], []
    # t = 1: connect light to the camera vertex (re-projected pixel)
    to_l = p_light - p_cam
    dist = jnp.maximum(vm.length(to_l), 1e-20)
    wi = to_l / dist[:, None]
    eps_c = 1e-3 * dist
    occ = scn.occluded(scene, meta, p_cam, wi, eps_c, dist - eps_c)
    sx, sy, _, scr_ok = cam.world_to_screen(p_light, p_cam)
    fsE = cam.eval_we(p_cam, p_light)[:, None]
    fsL = lt.eval_emission(lights, lid, n_light, -wi,
                           env_le=_env_le_at(scene, meta, -wi))
    G = vm.absdot(n_cam, wi) / (dist * dist)
    G = G * jnp.where(em["is_delta"], 1.0, vm.absdot(n_light, wi))
    c = fsL * fsE * (G * l_tp * cam_tp)[:, None]
    ok = scr_ok & ~occ & jnp.any(c > 0, axis=-1)
    xs.append(jnp.where(ok, sx, -1e9))
    ys.append(jnp.where(ok, sy, -1e9))
    cs.append(jnp.where(ok[:, None], c, 0.0))
    # t >= 2: surface vertices, contribution at the sampled camera pixel
    for t_i, v in enumerate(verts):
        pv = v["p"]
        to_l = p_light - pv
        dist = jnp.maximum(vm.length(to_l), 1e-20)
        wi = to_l / dist[:, None]
        eps_c = 1e-3 * dist
        occ = scn.occluded(scene, meta, pv, wi, eps_c, dist - eps_c)
        frag_d = {"mat": v["mat"], "uv": v["uv"]}
        mat = gather_material(scene, meta, frag_d)
        f = bx.bsdf_eval(mat, v["ns"], v["wo"], wi, bx.BSDF_ALL)
        fsE = f * We[:, None]
        fsL = lt.eval_emission(lights, lid, n_light, -wi,
                               env_le=_env_le_at(scene, meta, -wi))
        G = vm.absdot(v["ns"], wi) / (dist * dist)
        G = G * jnp.where(em["is_delta"], 1.0, vm.absdot(n_light, wi))
        c = fsL * fsE * v["tp"] * (G * l_tp)[:, None]
        ok = v["valid"] & ~occ & jnp.any(c > 0, axis=-1)
        xs.append(jnp.where(ok, px, -1e9))
        ys.append(jnp.where(ok, py, -1e9))
        cs.append(jnp.where(ok[:, None], c, 0.0))
    return jnp.concatenate(xs), jnp.concatenate(ys), jnp.concatenate(cs)


def render_light_tracer(scene, meta, chunk_size=1 << 14, spp=None,
                        seed=None, strategy=None):
    """Full light-trace render -> image. Total paths = spp * pixelCount.

    strategy: "t1" (default; connect every vertex to the camera —
    reference task default), "t0" (lens-hit only; needs lens_radius>0),
    "s1" (camera walk + light connection). The reference implements all
    three as cross-validation estimators
    (src/GoblinLightTracer.h:30-46)."""
    spec = meta.camera.film
    if spp is None:
        spp = int(meta.settings.get("sample_per_pixel", 1))
    if seed is None:
        seed = int(meta.settings.get("seed", 0))
    max_len = max(1, int(meta.settings.get("max_ray_depth", 5)))
    if strategy is None:
        strategy = str(meta.settings.get("lt_strategy", "t1"))
    contrib_fn = {
        "t1": light_trace_contributions,
        "t0": light_trace_t0_contributions,
        "s1": light_trace_s1_contributions,
    }[strategy]

    xs_, xc, ys_, yc = spec.crop_window()
    n_pix = xc * yc
    total_paths = spp * n_pix
    n_chunks = (total_paths + chunk_size - 1) // chunk_size

    def build_chunk_fns():
        @jax.jit
        def taps_fn(path_ids):
            x, y, c = contrib_fn(
                scene, meta, path_ids, jnp.int32(0), seed, max_len
            )
            return film_mod.splat_taps(spec, x, y, c, normalized=True)

        # the scatter MUST be its own dispatch (film.splat_taps doc)
        accum_fn = jax.jit(film_mod.splat_accum, donate_argnums=(0, 1))
        return taps_fn, accum_fn

    from .integrators.common import jit_cache

    taps_fn, accum_fn = jit_cache(
        meta, ("lt", id(scene), seed, max_len, strategy, chunk_size),
        build_chunk_fns,
    )

    def chunk_fn(color, weight, path_ids):
        return accum_fn(color, weight, *taps_fn(path_ids))

    color, weight = film_mod.new_film(spec)
    for ci in range(n_chunks):
        ids = jnp.arange(
            ci * chunk_size, (ci + 1) * chunk_size, dtype=jnp.int32
        )
        color, weight = chunk_fn(color, weight, ids)
    actual_paths = n_chunks * chunk_size
    img = film_mod.to_image(color, weight, normalize=False)
    return img * (float(n_pix) / float(actual_paths))


def render_dispatch(scene, meta, method, chunk_size=1 << 14):
    if method == "light_tracing":
        return render_light_tracer(scene, meta, chunk_size=chunk_size)
    if method == "bdpt":
        from .integrators.bdpt import render_bdpt

        return render_bdpt(scene, meta, chunk_size=chunk_size)
    if method == "sppm":
        from .integrators.sppm import render_sppm

        return render_sppm(scene, meta, chunk_size=chunk_size)
    raise ValueError(f"render_method {method!r} not supported yet")
