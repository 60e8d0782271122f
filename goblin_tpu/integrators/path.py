"""Unidirectional path tracer with NEE + MIS, in wavefront form.

Faithful batched re-derivation of the reference PT
(src/GoblinPathtracer.cpp:50-208):
- per bounce: one power-CDF light pick, one NEE shadow ray with MIS
  (power heuristic; no MIS for delta lights), one BSDF continuation
  sample whose hit doubles as the BSDF-side MIS light contribution
- specular lobes skip the light-sample side and take full weight on the
  BSDF side (fWeight = 1)
- Le added at the primary hit; env light on primary miss; env via the
  picked light's Le on BSDF-ray miss scaled by the MIS weight
- NO Russian roulette: fixed max_ray_depth - 1 bounces (parity)
- inactive lanes are masked, the bounce loop is a lax.fori_loop (one
  compiled body, static shapes)

Index-matched BSDF_NULL handling: NEE shadow rays use
occluded_attenuated — mask surfaces never occlude, they attenuate by
their null lobe without consuming depth (reference
occluded(ray, &isOpaque) + evalAttenuation,
src/GoblinPathtracer.cpp:5-48,95-113). A null lobe drawn as the BSDF
continuation consumes a bounce, matching the reference's `continue`
(which also advances the bounce counter). Documented difference: the
BSDF-MIS light-hit check intersects unfiltered, so a null surface in
front of the picked light contributes via the null-continuation path
instead of the filtered shortcut.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..core.rng import hash_uniform
from ..core.sampling import power_heuristic
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading import bsdf as bx
from .common import DIM_BASE
from .materials import gather_material

# per-bounce dimension layout
DIM_PICK = DIM_BASE + 0
DIM_LIGHT_U1 = DIM_BASE + 1
DIM_LIGHT_U2 = DIM_BASE + 2
DIM_BSDF_U1 = DIM_BASE + 3
DIM_BSDF_U2 = DIM_BASE + 4
DIM_BSDF_COMP = DIM_BASE + 5


def _em_tri_data(scene):
    return {"em_rows": scene["em_rows"]}


def _area_light_Le(scene, frag, wo):
    """Emission toward wo from the hit point, one-sided
    (reference AreaLight::L: dot(ns, w) > 0)."""
    from ..lights.lights import _sel

    lid = frag["light"]
    has = lid >= 0
    Le = _sel(scene["lights"], "color", jnp.maximum(lid, 0))
    facing = vm.dot(frag["ns"], wo) > 0.0
    return jnp.where((has & facing)[..., None], Le, 0.0)


def _env_le(scene, meta, d):
    """Environment radiance for direction d (0 without an IBL)."""
    if not meta.has_env:
        return jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    from ..lights import envmap

    return envmap.eval_env(scene, meta, d)


def make_li(meta, max_depth=None, with_stats=False, unroll=False):
    """Build the batched radiance fn. with_stats=True returns
    (L, (active_per_bounce, cont_per_bounce)) so callers (bench.py) can
    report useful-ray counts alongside dispatched-lane throughput.
    unroll=True replaces the lax.scan bounce loop with a Python loop
    (identical math; lets instrumentation like
    chip_smoke.capture_wavefronts record per-bounce arrays)."""
    if max_depth is None:
        max_depth = int(meta.settings.get("max_ray_depth", 5))
    from .common import spp_grid, stratified_1d, stratified_2d

    # integrator dims are stratified over the declared spp (reference
    # Sampler stratifies every declared pattern, GoblinSampler.cpp:93-197)
    n_spp = spp_grid(int(meta.settings.get("sample_per_pixel", 1))) ** 2

    def li(scene, meta_, ray, pixel_ids, s_idx, seed):
        lights = scene["lights"]
        tri_data = _em_tri_data(scene)
        R = ray["o"].shape[0]

        frag = scn.intersect(
            scene, meta, ray["o"], ray["d"], ray["mint"], ray["maxt"],
            dxd=ray.get("dxd"), dyd=ray.get("dyd"),
        )
        miss = ~frag["hit"]
        L = jnp.where(miss[:, None], _env_le(scene, meta, ray["d"]), 0.0)
        L = L + jnp.where(
            frag["hit"][:, None], _area_light_Le(scene, frag, frag["wo"]), 0.0
        )
        if meta.has_bssrdf and meta.n_lights > 0:
            # subsurface transport at the camera hit (reference PT adds
            # Lsubsurface once, before the bounce loop —
            # src/GoblinPathtracer.cpp:68-70)
            from .bssrdf import subsurface_L

            L = L + subsurface_L(
                scene, meta, frag, frag["hit"], pixel_ids, s_idx, seed
            )

        if meta.n_lights == 0:
            if with_stats:
                z = jnp.zeros(max_depth - 1, jnp.int32)
                return L, (z, z)
            return L

        def bounce_body(state, b, trace_cont=True, sort_cont="dir"):
            L, throughput, frag, active = state
            p = frag["p"]
            ns = frag["ns"]
            wo = frag["wo"]
            eps = frag["eps"]
            mat = gather_material(
                scene, meta, frag,
                u_mask=hash_uniform(seed, pixel_ids, s_idx, b, DIM_BSDF_COMP),
            )

            # ---- pick light by power CDF
            u_pick = stratified_1d(seed, pixel_ids, s_idx, n_spp, b,
                                   DIM_PICK)
            lid, pick_pdf = lt.pick_light(lights, u_pick)

            # ---- light-sample side (NEE)
            u1, u2 = stratified_2d(seed, pixel_ids, s_idx, n_spp, b,
                                   DIM_LIGHT_U1, DIM_LIGHT_U2)
            ls = lt.sample_li(lights, tri_data, lid, p, eps, u1, u2)
            if meta.has_env:
                from ..lights import envmap

                is_ibl_pick = lights["type"][lid] == lt.LIGHT_IBL
                env_li, env_wi, env_pdf = envmap.sample_env(scene, meta, u1, u2)
                ls["Li"] = jnp.where(is_ibl_pick[:, None], env_li, ls["Li"])
                ls["wi"] = jnp.where(is_ibl_pick[:, None], env_wi, ls["wi"])
                ls["pdf"] = jnp.where(is_ibl_pick, env_pdf, ls["pdf"])
                ls["shadow_maxt"] = jnp.where(
                    is_ibl_pick, 3.0e37, ls["shadow_maxt"]
                )
            f_l = bx.bsdf_eval(mat, ns, wo, ls["wi"], bx.BSDF_ALL)
            consider = (
                active
                & (ls["pdf"] > 0.0)
                & jnp.any(ls["Li"] > 0.0, axis=-1)
                & jnp.any(f_l > 0.0, axis=-1)
            )
            # kill dead lanes at the trace level: mint=BIG/maxt=0 marks a
            # ray finished before its first node visit. Null-capable
            # (mask) surfaces punch through with attenuation, never
            # consuming depth.
            occ, tr_null = scn.occluded_attenuated(
                scene, meta, p, ls["wi"],
                jnp.where(consider, eps, scn.BIG_T),
                jnp.where(consider, ls["shadow_maxt"], 0.0),
            )
            vis = consider & ~occ
            bsdf_pdf_l = bx.bsdf_pdf(mat, ns, wo, ls["wi"], bx.BSDF_ALL)
            w_l = jnp.where(
                ls["is_delta"],
                1.0,
                power_heuristic(1.0, ls["pdf"], 1.0, bsdf_pdf_l),
            )
            Ld = jnp.where(
                vis[:, None],
                f_l * tr_null * ls["Li"]
                * (vm.absdot(ns, ls["wi"]) * w_l
                   / jnp.maximum(ls["pdf"], 1e-20))[:, None],
                0.0,
            )

            # ---- BSDF-sample side: continuation ray + MIS light hit
            bu1, bu2 = stratified_2d(seed, pixel_ids, s_idx, n_spp, b,
                                     DIM_BSDF_U1, DIM_BSDF_U2)
            bcomp = stratified_1d(seed, pixel_ids, s_idx, n_spp, b,
                                  DIM_BSDF_COMP + 3)
            bs = bx.bsdf_sample(
                mat, ns, frag["dpdu"], wo, bu1, bu2, bcomp, bx.BSDF_ALL
            )
            wi = bs["wi"]
            f_b = bs["f"]
            pdf_b = bs["pdf"]
            cont_ok = active & bs["valid"] & jnp.any(f_b > 0.0, axis=-1)

            if trace_cont:
                frag2 = scn.intersect(
                    scene, meta, p, wi,
                    jnp.where(cont_ok, eps, scn.BIG_T),
                    jnp.where(cont_ok, 3.0e37, 0.0),
                    sort=sort_cont
                    if getattr(meta, "trace_sort_bounce", True) else None,
                )
            else:
                # final bounce of an all-delta-light scene: the
                # continuation hit can't be emissive and the walk ends —
                # skip the trace, keep the fragment structure
                frag2 = jax.tree_util.tree_map(jnp.zeros_like, frag)
                frag2["hit"] = jnp.zeros_like(frag["hit"])
                frag2["light"] = jnp.full_like(frag["light"], -1)

            # light pdf of the BSDF direction for MIS (area lights only)
            cos_at_light = vm.dot(frag2["ns"], -wi)
            pdf_l_of_b = lt.pdf_li(
                lights, lid, p, wi, frag2["t"], cos_at_light, frag2["light"]
            )
            f_weight = jnp.where(
                bs["is_specular"] | bs["is_null"],
                1.0,
                power_heuristic(1.0, pdf_b, 1.0, pdf_l_of_b),
            )
            # emission seen along the BSDF ray, only if it hit the picked
            # light's geometry
            hit_le = _area_light_Le(scene, frag2, -wi)
            hit_is_picked = frag2["hit"] & (frag2["light"] == lid)
            Ld_b = jnp.where(
                (cont_ok & hit_is_picked)[:, None],
                f_b * hit_le * (vm.absdot(wi, ns) * f_weight
                                / jnp.maximum(pdf_b, 1e-20))[:, None],
                0.0,
            )
            # env contribution on miss, via the picked light (IBL only);
            # MIS against the env CDF2D pdf (reference ImageBasedLight::pdf)
            if meta.has_env:
                from ..lights import envmap

                is_ibl = lights["type"][lid] == lt.LIGHT_IBL
                env = _env_le(scene, meta, wi)
                env_pdf_b = envmap.pdf_env(scene, meta, wi)
                env_weight = jnp.where(
                    bs["is_specular"] | bs["is_null"],
                    1.0,
                    power_heuristic(1.0, pdf_b, 1.0, env_pdf_b),
                )
                Ld_b = Ld_b + jnp.where(
                    (cont_ok & ~frag2["hit"] & is_ibl)[:, None],
                    f_b * env * (vm.absdot(wi, ns) * env_weight
                                 / jnp.maximum(pdf_b, 1e-20))[:, None],
                    0.0,
                )

            L = L + jnp.where(
                active[:, None],
                throughput * (Ld + Ld_b) / jnp.maximum(pick_pdf, 1e-20)[:, None],
                0.0,
            )

            # ---- continue the walk
            throughput = jnp.where(
                cont_ok[:, None],
                throughput * f_b * (vm.absdot(wi, ns)
                                    / jnp.maximum(pdf_b, 1e-20))[:, None],
                throughput,
            )
            active = cont_ok & frag2["hit"]
            # keep the old fragment on lanes that went inactive (values
            # are masked anyway); select leaf-wise
            new_frag = jax.tree_util.tree_map(
                lambda a, b_: jnp.where(
                    active.reshape(active.shape + (1,) * (a.ndim - 1)), b_, a
                ),
                frag, frag2,
            )
            # census for bench.py: shadow rays actually considered, and
            # continuation rays actually TRACED (0 for the peeled last
            # bounce, whose trace is skipped while its NEE shadow rays
            # are real work)
            ys = (
                (jnp.sum(consider),
                 jnp.sum(cont_ok) if trace_cont else jnp.zeros((), jnp.int32))
                if with_stats else None
            )
            return (L, throughput, new_frag, active), ys

        init = (
            L,
            jnp.ones((R, 3), jnp.float32),
            frag,
            frag["hit"],
        )
        # scan (not fori_loop) so the bounce loop is reverse-mode
        # differentiable for the gradient path; for all-delta-light
        # scenes the LAST bounce is peeled out of the scan and runs
        # without its (provably zero-contribution) continuation trace
        skip_last = (
            getattr(meta, "all_delta_lights", False) and max_depth >= 2
        )
        n_scan = max_depth - 2 if skip_last else max_depth - 1
        if unroll:
            ys_list = []
            state = init
            for b in range(n_scan):
                state, y = bounce_body(state, jnp.int32(b),
                                       sort_cont=None if b == 0 else "dir")
                ys_list.append(y)
            ys = (
                tuple(jnp.stack(v) for v in zip(*ys_list))
                if with_stats and ys_list else
                (jnp.zeros(0, jnp.int32), jnp.zeros(0, jnp.int32))
            )
        else:
            # bounce 1 is peeled out of the scan and traces UNSORTED:
            # its wavefront still carries screen-tile coherence (one
            # diffuse bounce off mostly-planar geometry); bounces >= 2
            # are direction-incoherent and take the optional global
            # (dead, octant, axis) sort when trace_sort_bounce is on
            ys0 = None
            if n_scan >= 1:
                state, ys0 = bounce_body(init, jnp.int32(0),
                                         sort_cont=None)
            else:
                state = init
            state, ys = jax.lax.scan(
                bounce_body, state, jnp.arange(1, max(n_scan, 1))
            )
            if with_stats and ys0 is not None:
                ys = tuple(
                    jnp.concatenate([a[None], b_])
                    for a, b_ in zip(ys0, ys)
                )
        if skip_last:
            state, ys_last = bounce_body(
                state, jnp.int32(max_depth - 2), trace_cont=False
            )
            if with_stats:
                ys = tuple(
                    jnp.concatenate([a, b[None]])
                    for a, b in zip(ys, ys_last)
                )
        (L, _, _, _) = state
        if meta.volume is not None:
            from .volume import apply_volume

            L = apply_volume(scene, meta, ray, frag["t"], L, pixel_ids,
                             s_idx, seed)
        if with_stats:
            return L, ys
        return L

    return li
