"""Wavefront BSDF evaluation / sampling / pdf with table dispatch.

The reference's Material class hierarchy (src/GoblinMaterial.{h,cpp}) becomes
a type-id + SoA parameter table: every lane carries a material row and all
material models are evaluated branch-free with masked selects — the
wavefront replacement for C++ virtual dispatch. The BSDFType bitmask
semantics (matchType, hemisphere-stripped sample type, BSDF_NULL alpha
punch-through, Radiance-vs-Importance transport) are preserved exactly;
they are load-bearing for PT shadow rays and BDPT
(src/GoblinPathtracer.cpp:5-11, src/GoblinMaterial.cpp:285-294,378-387).

Material models (type ids):
    0 lambert     kd=c0                              (reflection|diffuse)
    1 blinn       kg=c0, exponent=f0, eta, k         (reflection|glossy)
    2 transparent kr=c0, kt=c1, eta                  (specular|refl|trans)
    3 mirror      kr=c0, eta, k                      (specular|reflection)
    4 subsurface  kr=c0, eta                         (specular|reflection)
    5 mask        inner material + alpha=f1, transparent_color=c1

Everything is differentiable jnp; pdfs are returned separately so
integrators can stop_gradient them (detached sampling estimator).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import vecmath as vm
from ..core.vecmath import INV_PI, INV_TWO_PI, TWO_PI

# BSDFType bitmask (reference src/GoblinMaterial.h:17-27)
BSDF_REFLECTION = 1 << 0
BSDF_TRANSMISSION = 1 << 1
BSDF_DIFFUSE = 1 << 2
BSDF_GLOSSY = 1 << 3
BSDF_SPECULAR = 1 << 4
BSDF_NULL = 1 << 5
BSDF_ALL = (
    BSDF_REFLECTION | BSDF_TRANSMISSION | BSDF_DIFFUSE | BSDF_GLOSSY
    | BSDF_SPECULAR | BSDF_NULL
)

# transport mode
MODE_RADIANCE = 0
MODE_IMPORTANCE = 1

# material type ids
MAT_LAMBERT = 0
MAT_BLINN = 1
MAT_TRANSPARENT = 2
MAT_MIRROR = 3
MAT_SUBSURFACE = 4
MAT_MASK = 5

_LOBE_BY_TYPE = {
    MAT_LAMBERT: BSDF_REFLECTION | BSDF_DIFFUSE,
    MAT_BLINN: BSDF_REFLECTION | BSDF_GLOSSY,
    MAT_TRANSPARENT: BSDF_SPECULAR | BSDF_REFLECTION | BSDF_TRANSMISSION,
    MAT_MIRROR: BSDF_SPECULAR | BSDF_REFLECTION,
    MAT_SUBSURFACE: BSDF_SPECULAR | BSDF_REFLECTION,
    MAT_MASK: 0,  # inner lobe | BSDF_NULL, resolved per-lane
}


def lobe_of(mtype):
    """Per-lane material lobe bitmask from material type id array."""
    table = jnp.array(
        [_LOBE_BY_TYPE[i] for i in range(5)] + [0], dtype=jnp.int32
    )
    return table[jnp.clip(mtype, 0, 5)]


def match_type(type_mask, to_match):
    """(type & toMatch) == toMatch (reference GoblinMaterial.h:191-193)."""
    return (type_mask & to_match) == to_match


def strip_by_hemisphere(ns, wo, wi, type_mask):
    """Strip Reflection or Transmission bit by the wo/wi hemisphere test
    (reference Material::getSampleType, src/GoblinMaterial.cpp:285-294)."""
    same = vm.dot(ns, wo) * vm.dot(ns, wi) > 0.0
    stripped = jnp.where(
        same, type_mask & ~BSDF_TRANSMISSION, type_mask & ~BSDF_REFLECTION
    )
    return stripped


def fresnel_dielectric(cosi, etai, etat):
    """Full rParl/rPerp dielectric Fresnel (src/GoblinMaterial.cpp:389-410).

    Broadcastable; etai/etat are the incident/transmitted IORs *already
    oriented* (caller swaps on exiting rays).
    """
    cosi = jnp.clip(cosi, -1.0, 1.0)
    sint = (etai / etat) * jnp.sqrt(jnp.maximum(0.0, 1.0 - cosi * cosi))
    total = sint >= 1.0
    cost = jnp.sqrt(jnp.maximum(0.0, 1.0 - sint * sint))
    ci = jnp.abs(cosi)
    r_parl = (etat * ci - etai * cost) / jnp.maximum(etat * ci + etai * cost, 1e-12)
    r_perp = (etai * ci - etat * cost) / jnp.maximum(etai * ci + etat * cost, 1e-12)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return jnp.where(total, 1.0, f)


def fresnel_conductor(cosi, eta, k):
    """Conductor Fresnel (src/GoblinMaterial.cpp:412-421)."""
    tmp = eta * eta + k * k
    c2 = cosi * cosi
    r_parl2 = (tmp * c2 - 2.0 * eta * cosi + 1.0) / (
        tmp * c2 + 2.0 * eta * cosi + 1.0
    )
    r_perp2 = (tmp - 2.0 * eta * cosi + c2) / (tmp + 2.0 * eta * cosi + c2)
    return 0.5 * (r_parl2 + r_perp2)


def shading_frame(ns, dpdu):
    """Orthonormal (tangent, bitangent, normal) from shading normal + dpdu.

    Mirrors Fragment::getWorldToShade: z = ns, x = gram-schmidt(dpdu),
    y = z × x; falls back to coordinate_system when dpdu is degenerate.
    """
    t = dpdu - vm.dotn(dpdu, ns) * ns
    bad = vm.squared_length(t) < 1e-16
    alt, _ = vm.coordinate_system(ns)
    t = jnp.where(bad[..., None], alt, vm.normalize(t, eps=1e-30))
    b = vm.cross(ns, t)
    return t, b


def to_local(t, b, n, w):
    """World -> shading space."""
    return jnp.stack([vm.dot(w, t), vm.dot(w, b), vm.dot(w, n)], axis=-1)


def to_world(t, b, n, w_local):
    return (
        w_local[..., 0:1] * t + w_local[..., 1:2] * b + w_local[..., 2:3] * n
    )


# ---------------------------------------------------------------------------
# Per-model eval / pdf (non-delta models only; deltas eval to 0)
# ---------------------------------------------------------------------------


def _lambert_eval(mat, ns, wo, wi, type_mask):
    st = strip_by_hemisphere(ns, wo, wi, type_mask)
    ok = match_type(st, BSDF_REFLECTION | BSDF_DIFFUSE)
    return jnp.where(ok[..., None], mat["c0"] * INV_PI, 0.0)


def _lambert_pdf(mat, ns, wo, wi, type_mask):
    ok = match_type(type_mask, BSDF_REFLECTION | BSDF_DIFFUSE)
    same = vm.dot(ns, wo) * vm.dot(ns, wi) > 0.0
    return jnp.where(ok & same, vm.absdot(ns, wi) * INV_PI, 0.0)


def _blinn_terms(mat, ns, wo, wi):
    cosi = vm.absdot(ns, wi)
    coso = vm.absdot(ns, wo)
    wh = vm.normalize(wo + wi, eps=1e-30)
    cosh = vm.absdot(ns, wh)
    e = mat["f0"]
    D = (e + 2.0) * INV_TWO_PI * jnp.power(jnp.maximum(cosh, 1e-12), e)
    wo_dot_wh = vm.absdot(wo, wh)
    safe = jnp.maximum(wo_dot_wh, 1e-12)
    G = jnp.minimum(
        1.0, jnp.minimum(2.0 * cosh * coso / safe, 2.0 * cosh * cosi / safe)
    )
    conductor = mat["k"] > 0.0
    F = jnp.where(
        conductor,
        fresnel_conductor(wo_dot_wh, mat["eta"], mat["k"]),
        fresnel_dielectric(wo_dot_wh, 1.0, mat["eta"]),
    )
    return cosi, coso, wh, cosh, D, G, F, wo_dot_wh


def _blinn_eval(mat, ns, wo, wi, type_mask):
    st = strip_by_hemisphere(ns, wo, wi, type_mask)
    ok = match_type(st, BSDF_REFLECTION | BSDF_GLOSSY)
    cosi, coso, _, _, D, G, F, _ = _blinn_terms(mat, ns, wo, wi)
    denom = jnp.maximum(4.0 * cosi * coso, 1e-12)
    ok = ok & (cosi > 0.0) & (coso > 0.0)
    f = mat["c0"] * (D * G * F / denom)[..., None]
    return jnp.where(ok[..., None], f, 0.0)


def _blinn_pdf(mat, ns, wo, wi, type_mask):
    ok = match_type(type_mask, BSDF_REFLECTION | BSDF_GLOSSY)
    same = vm.dot(ns, wo) * vm.dot(ns, wi) > 0.0
    wh = vm.normalize(wo + wi, eps=1e-30)
    cosh = vm.absdot(wh, ns)
    e = mat["f0"]
    pdf = (e + 1.0) * jnp.power(jnp.maximum(cosh, 1e-12), e) / (
        TWO_PI * 4.0 * jnp.maximum(vm.dot(wo, wh), 1e-12)
    )
    return jnp.where(ok & same, pdf, 0.0)


# ---------------------------------------------------------------------------
# Public batched API. `mat` is a dict of per-lane arrays:
#   mtype (R,) i32 ; c0, c1 (R,3) ; f0, f1 (R,) ; eta, k (R,)
# For mask materials the *inner* material must already be resolved into
# mtype/c0/f0/eta/k (bake-time flattening), with f1 = alpha and
# c1 = transparent_color kept for the null lobe.
# ---------------------------------------------------------------------------


def _need(mat, kind):
    """Static material-kind pruning: gather_material records the scene's
    present kinds (meta.material_kinds) as a python tuple in the mat
    dict; branches for absent kinds are dropped at trace time instead of
    computed-and-masked (a bunny pass was paying full Blinn
    Torrance-Sparrow math per bounce with zero blinn materials)."""
    kinds = mat.get("kinds")
    return kinds is None or kind in kinds


def bsdf_eval(mat, ns, wo, wi, type_mask, mode=MODE_RADIANCE):
    """f(wo, wi): (R, 3). Delta lobes contribute 0 (reference behavior)."""
    mtype = mat["mtype"]
    f = jnp.zeros(wo.shape, jnp.float32)
    if _need(mat, MAT_LAMBERT):
        f = jnp.where(
            (mtype == MAT_LAMBERT)[..., None],
            _lambert_eval(mat, ns, wo, wi, type_mask), f,
        )
    if _need(mat, MAT_BLINN):
        f = jnp.where(
            (mtype == MAT_BLINN)[..., None],
            _blinn_eval(mat, ns, wo, wi, type_mask), f,
        )
    # masked materials scale the inner bsdf by alpha (reference
    # MaskMaterial::bsdf) — resolved at bake: is_masked flag scales.
    alpha = mat.get("mask_alpha")
    if alpha is not None:
        f = f * jnp.where(mat["is_masked"], alpha, 1.0)[..., None]
    return f


def bsdf_pdf(mat, ns, wo, wi, type_mask):
    mtype = mat["mtype"]
    pdf = jnp.zeros(wo.shape[:-1], jnp.float32)
    if _need(mat, MAT_LAMBERT):
        pdf = jnp.where(mtype == MAT_LAMBERT,
                        _lambert_pdf(mat, ns, wo, wi, type_mask), pdf)
    if _need(mat, MAT_BLINN):
        pdf = jnp.where(mtype == MAT_BLINN,
                        _blinn_pdf(mat, ns, wo, wi, type_mask), pdf)
    alpha = mat.get("mask_alpha")
    if alpha is not None:
        pdf = pdf * jnp.where(mat["is_masked"], alpha, 1.0)
    return pdf


def bsdf_sample(mat, ns, dpdu, wo, u1, u2, u_comp, type_mask,
                mode=MODE_RADIANCE):
    """Sample a continuation direction for every lane.

    Returns dict with:
      f (R,3)        bsdf value of the sampled lobe (delta lobes already
                     divided by |cos| per reference convention)
      wi (R,3)
      pdf (R,)       probability (solid angle for smooth; discrete for delta)
      is_specular (R,) bool   sampled lobe is a delta
      is_null (R,)   bool     alpha punch-through lobe (wi = -wo)
      valid (R,)     bool     pdf > 0
    """
    mtype = mat["mtype"]
    t, b = shading_frame(ns, dpdu)
    n_dot_wo = vm.dot(ns, wo)
    flip = jnp.where(n_dot_wo < 0.0, -1.0, 1.0)[..., None]

    # --- lambert: cosine hemisphere around ns (flipped to wo side)
    sin_t = jnp.sqrt(jnp.maximum(u1, 0.0))
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    phi = TWO_PI * u2
    wi_loc = jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1
    )
    wi_lambert = to_world(t, b, ns, wi_loc * flip)

    # --- blinn: sample half vector, reflect
    if _need(mat, MAT_BLINN):
        e = mat["f0"]
        cos_th = jnp.power(jnp.maximum(u1, 1e-12), 1.0 / (e + 1.0))
        sin_th = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_th * cos_th))
        wh_loc = jnp.stack(
            [sin_th * jnp.cos(phi), sin_th * jnp.sin(phi), cos_th],
            axis=-1,
        )
        wh = to_world(t, b, ns, wh_loc * flip)
        wi_blinn = -wo + 2.0 * vm.dotn(wo, wh) * wh
    else:
        wi_blinn = wi_lambert  # never selected (no blinn material)

    # --- dielectric specular reflect / refract (transparent, subsurface)
    need_dielectric = (_need(mat, MAT_TRANSPARENT)
                       or _need(mat, MAT_SUBSURFACE))
    entering = n_dot_wo > 0.0
    n_or = jnp.where(entering[..., None], ns, -ns)
    cosi = jnp.abs(n_dot_wo)
    etai = mat["eta"]  # inside IOR (etat in reference naming)
    ei = jnp.where(entering, 1.0, etai)  # incident-side IOR
    et = jnp.where(entering, etai, 1.0)  # transmitted-side IOR
    if not need_dielectric:
        F = jnp.zeros_like(cosi)
        wi_reflect = wi_lambert
        eta_ratio = jnp.ones_like(cosi)
        total_internal = jnp.zeros_like(entering)
        cost = cosi
        wi_refract = wi_lambert
    else:
        F = fresnel_dielectric(cosi, ei, et)
        wi_reflect = 2.0 * cosi[..., None] * n_or - wo
        eta_ratio = ei / et
        sin2t = eta_ratio * eta_ratio * jnp.maximum(0.0, 1.0 - cosi * cosi)
        total_internal = sin2t >= 1.0
        cost = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2t))
        wi_refract = vm.normalize(
            n_or * (eta_ratio * cosi - cost)[..., None]
            - eta_ratio[..., None] * wo,
            eps=1e-30,
        )
    # radiance transport squeezes by eta^2; importance doesn't (Veach ch.5,
    # reference src/GoblinMaterial.cpp:378-387)
    eta_scale = jnp.where(mode == MODE_RADIANCE, eta_ratio * eta_ratio, 1.0)
    refract_scale = eta_scale * (1.0 - F) / jnp.maximum(
        vm.absdot(wi_refract, n_or), 1e-12
    )
    reflect_scale_dielectric = F / jnp.maximum(cosi, 1e-12)

    # importance-sample reflect-vs-refract by Fresnel-weighted reflectance
    # (reference TransparentMaterial::sampleBSDF nMatch==2 branch:
    # reflectChance = F/cosr * |wi.n| = F)
    reflect_chance = reflect_scale_dielectric * vm.absdot(wi_reflect, ns)
    # normalize to arrays: type_mask may be a static python int
    want_reflect = jnp.asarray(match_type(type_mask, BSDF_SPECULAR | BSDF_REFLECTION))
    want_refract = jnp.asarray(match_type(type_mask, BSDF_SPECULAR | BSDF_TRANSMISSION))
    both = want_reflect & want_refract
    do_reflect = jnp.where(
        both, u_comp < reflect_chance, want_reflect
    ) | total_internal
    f_transparent = jnp.where(
        do_reflect[..., None],
        mat["c0"] * reflect_scale_dielectric[..., None],
        mat["c1"] * refract_scale[..., None],
    )
    pdf_transparent = jnp.where(
        both,
        jnp.where(do_reflect, reflect_chance, 1.0 - reflect_chance),
        1.0,
    )
    pdf_transparent = jnp.where(
        total_internal & ~want_reflect, 0.0, pdf_transparent
    )
    wi_transparent = jnp.where(
        do_reflect[..., None], wi_reflect, wi_refract
    )

    # --- conductor mirror: F/cos, zero on backface
    if _need(mat, MAT_MIRROR):
        F_cond = fresnel_conductor(jnp.maximum(n_dot_wo, 0.0),
                                   mat["eta"], mat["k"])
        mirror_scale = jnp.where(
            n_dot_wo > 0.0, F_cond / jnp.maximum(n_dot_wo, 1e-12), 0.0
        )
        wi_mirror = 2.0 * vm.dotn(wo, ns) * ns - wo
    else:
        mirror_scale = jnp.zeros_like(n_dot_wo)
        wi_mirror = wi_lambert

    # --- subsurface surface lobe: dielectric specular reflection only
    f_subsurface = mat["c0"] * reflect_scale_dielectric[..., None]

    # select per material type
    is_lambert = mtype == MAT_LAMBERT
    is_blinn = mtype == MAT_BLINN
    is_transparent = mtype == MAT_TRANSPARENT
    is_mirror = mtype == MAT_MIRROR
    is_subsurface = mtype == MAT_SUBSURFACE

    wi = jnp.where(
        is_lambert[..., None],
        wi_lambert,
        jnp.where(
            is_blinn[..., None],
            wi_blinn,
            jnp.where(
                is_transparent[..., None],
                wi_transparent,
                jnp.where(
                    is_subsurface[..., None],
                    wi_reflect,
                    wi_mirror,
                ),
            ),
        ),
    )

    # smooth-lobe f & pdf by evaluating the model at sampled wi
    f_l = _lambert_eval(mat, ns, wo, wi, BSDF_ALL)
    p_l = _lambert_pdf(mat, ns, wo, wi, BSDF_ALL)
    if _need(mat, MAT_BLINN):
        f_b = _blinn_eval(mat, ns, wo, wi, BSDF_ALL)
        p_b = _blinn_pdf(mat, ns, wo, wi, BSDF_ALL)
    else:
        f_b = f_l
        p_b = p_l

    f = jnp.where(
        is_lambert[..., None],
        f_l,
        jnp.where(
            is_blinn[..., None],
            f_b,
            jnp.where(
                is_transparent[..., None],
                f_transparent,
                jnp.where(
                    is_subsurface[..., None],
                    f_subsurface,
                    mat["c0"] * mirror_scale[..., None],
                ),
            ),
        ),
    )
    pdf = jnp.where(
        is_lambert,
        p_l,
        jnp.where(
            is_blinn,
            p_b,
            jnp.where(is_transparent, pdf_transparent, 1.0),
        ),
    )
    is_specular = is_transparent | is_mirror | is_subsurface

    # require the requested type to include the material's lobe at all
    lobe = lobe_of(mtype)
    requested = (type_mask & lobe) != 0
    pdf = jnp.where(requested, pdf, 0.0)

    # mirror backface / degenerate guard
    pdf = jnp.where(is_mirror & (n_dot_wo <= 0.0), 0.0, pdf)

    # --- mask material: stochastic pick between inner lobe and punch-through
    is_null = jnp.zeros_like(is_specular)
    if "is_masked" in mat:
        alpha = mat["mask_alpha"]
        masked = mat["is_masked"]
        want_null = match_type(type_mask, BSDF_NULL)
        want_inner = type_mask != BSDF_NULL
        # stochastic branch only when both lobes requested (reference
        # MaskMaterial::sampleBSDF)
        u_mask = mat["mask_u"]
        pick_inner = jnp.where(
            want_inner & want_null, u_mask < alpha, want_inner
        )
        null_f = (1.0 - alpha)[..., None] * mat["c1"]
        null_pdf_both = 1.0 - alpha
        wi_null = -vm.normalize(wo, eps=1e-30)
        sel_null = masked & ~pick_inner & want_null
        f = jnp.where(sel_null[..., None], null_f, f * jnp.where(masked, alpha, 1.0)[..., None])
        pdf = jnp.where(
            sel_null,
            jnp.where(want_inner, null_pdf_both, 1.0),
            pdf * jnp.where(masked & want_null & want_inner, alpha, 1.0),
        )
        wi = jnp.where(sel_null[..., None], wi_null, wi)
        is_null = sel_null
        is_specular = jnp.where(sel_null, False, is_specular)

    valid = pdf > 0.0
    return {
        "f": f,
        "wi": wi,
        "pdf": pdf,
        "is_specular": is_specular,
        "is_null": is_null,
        "valid": valid,
    }
