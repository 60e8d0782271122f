"""Light table: batched sampling/eval for all light types.

Wavefront re-design of the reference Light hierarchy (src/GoblinLight.{h,cpp}):
per-lane type ids select between masked per-type computations. Semantics
preserved:

- point: Li = I/r^2, delta, power 4*pi*I            (:78-134)
- directional: parallel radiance, delta             (:136-210)
- spot: cone falloff ((cos-cosMax)/(cosStart-cosMax))^4  (:212-287)
- area: one-sided Le (dot(ns, w) > 0), solid-angle pdf via sampled
  geometry; world-space triangle sets with an area CDF per light
  (:289-461). Area lights here sample *world-space* triangles baked from
  the instanced geometry, so the world area is exact rather than the
  reference's uniform-scale approximation (:396-404).
- ibl: lat-long environment map (env_* fields; evaluated via the scene's
  env table)

Delta lights (point/directional/spot) return pdf == 1 with is_delta True,
matching the reference's convention where sampleL pdf is 1 and MIS is
skipped for delta lights.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..core import sampling as sp
from ..core import vecmath as vm

LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_SPOT = 2
LIGHT_AREA = 3
LIGHT_IBL = 4


@dataclass
class LightsBuild:
    """Host-side accumulation during scene bake."""

    types: list = field(default_factory=list)
    colors: list = field(default_factory=list)  # intensity/radiance/Le
    positions: list = field(default_factory=list)
    directions: list = field(default_factory=list)
    cos_theta_max: list = field(default_factory=list)
    cos_falloff_start: list = field(default_factory=list)
    sample_nums: list = field(default_factory=list)
    areas: list = field(default_factory=list)  # world area (area lights)

    def add(self, ltype, color, position=(0, 0, 0), direction=(0, 0, 1),
            cos_theta_max=-1.0, cos_falloff_start=-1.0, sample_num=1,
            area=0.0) -> int:
        self.types.append(ltype)
        self.colors.append(np.asarray(color, np.float32))
        self.positions.append(np.asarray(position, np.float32))
        d = np.asarray(direction, np.float32)
        n = np.linalg.norm(d)
        self.directions.append(d / n if n > 0 else np.float32([0, 0, 1]))
        self.cos_theta_max.append(cos_theta_max)
        self.cos_falloff_start.append(cos_falloff_start)
        self.sample_nums.append(sample_num)
        self.areas.append(area)
        return len(self.types) - 1


def bake_lights(build: LightsBuild, em_tri_light, em_tri_area,
                world_center, world_radius, env_luminance_power=0.0):
    """-> dict of device arrays (the light table).

    em_tri_light: (E,) light id per emissive triangle (BVH soup order ids
    are carried separately); em_tri_area: (E,) world areas.
    """
    L = max(1, len(build.types))
    types = np.asarray(build.types or [LIGHT_POINT], np.int32)
    colors = np.asarray(build.colors or [np.zeros(3)], np.float32).reshape(L, 3)
    positions = np.asarray(build.positions or [np.zeros(3)], np.float32).reshape(L, 3)
    directions = np.asarray(build.directions or [np.float32([0, 0, 1])],
                            np.float32).reshape(L, 3)

    # power for the light-pick CDF (reference Scene ctor,
    # src/GoblinScene.cpp:21-26, uses Color.luminance of power())
    areas = np.asarray(build.areas or [0.0], np.float32)
    lum = (
        0.212671 * colors[:, 0] + 0.715160 * colors[:, 1] + 0.072169 * colors[:, 2]
    )
    power = np.zeros(L, np.float32)
    for i, t in enumerate(np.asarray(types)):
        if t == LIGHT_POINT:
            power[i] = 4.0 * np.pi * lum[i]
        elif t == LIGHT_DIRECTIONAL:
            power[i] = np.pi * world_radius ** 2 * lum[i]
        elif t == LIGHT_SPOT:
            ctm = build.cos_theta_max[i]
            cfs = build.cos_falloff_start[i]
            power[i] = lum[i] * 2.0 * np.pi * (1.0 - 0.5 * (ctm + cfs))
        elif t == LIGHT_AREA:
            power[i] = lum[i] * np.pi * areas[i]
        elif t == LIGHT_IBL:
            power[i] = env_luminance_power
    if power.sum() <= 0.0:
        power[:] = 1.0

    # per-light emissive-triangle segments with an area CDF inside each
    E = len(em_tri_light)
    em_light = np.asarray(em_tri_light, np.int32) if E else np.zeros(0, np.int32)
    em_area = np.asarray(em_tri_area, np.float32) if E else np.zeros(0, np.float32)
    # triangles are appended per light in order, so segments are contiguous
    seg_start = np.zeros(L + 1, np.int32)
    for i in range(L):
        seg_start[i + 1] = seg_start[i] + int((em_light == i).sum())
    # normalized per-light area cdf (within segment), padded globally
    em_cdf = np.zeros(E, np.float32)
    for i in range(L):
        s, e = seg_start[i], seg_start[i + 1]
        if e > s:
            c = np.cumsum(em_area[s:e])
            em_cdf[s:e] = c / c[-1]

    return {
        "type": jnp.asarray(types),
        "color": jnp.asarray(colors),
        "position": jnp.asarray(positions),
        "direction": jnp.asarray(directions),
        "cos_theta_max": jnp.asarray(
            np.asarray(build.cos_theta_max or [-1.0], np.float32)
        ),
        "cos_falloff_start": jnp.asarray(
            np.asarray(build.cos_falloff_start or [-1.0], np.float32)
        ),
        "area": jnp.asarray(areas),
        "power": jnp.asarray(power),
        "power_cdf": jnp.asarray(np.cumsum(power) / power.sum()),
        "seg_start": jnp.asarray(seg_start),
        "em_cdf": jnp.asarray(em_cdf),
        "em_light": jnp.asarray(em_light),
        "world_center": jnp.asarray(np.asarray(world_center, np.float32)),
        "world_radius": jnp.float32(world_radius),
        # analytic sphere emitters (overwritten by bake when present):
        # cone-sampled NEE (reference GoblinSphere.cpp:108-136)
        "sph_center": jnp.zeros((L, 3), jnp.float32),
        "sph_radius": jnp.zeros(L, jnp.float32),
        "is_sphere": jnp.zeros(L, bool),
    }


def _sel(lights, key, lid):
    """Per-lane row select from the light table. Light counts are tiny,
    so a masked select-sum (dense elementwise ops over every light)
    replaces the per-lane gather; large tables fall back to gather."""
    tab = lights[key]
    L = tab.shape[0]
    if L <= 16:
        out = jnp.zeros(lid.shape + tab.shape[1:], tab.dtype)
        for x in range(L):
            m = lid == x
            out = jnp.where(
                m.reshape(m.shape + (1,) * (tab.ndim - 1)), tab[x], out
            )
        return out
    return jnp.take(tab, lid, axis=0)


def pick_light(lights, u):
    """Power-weighted light pick (reference Scene::sampleLight).
    Returns (light_id (R,), pick_pdf (R,))."""
    cdf = lights["power_cdf"]
    L = cdf.shape[0]
    idx = jnp.sum((cdf[None, :] <= u[..., None]).astype(jnp.int32), axis=-1)
    idx = jnp.clip(idx, 0, L - 1)
    pdf = _sel(lights, "power", idx) / jnp.sum(lights["power"])
    return idx, pdf


def _rescale_cdf_u(em_cdf, tri, seg0, u):
    """Remap u into [0,1) within its chosen cdf cell: (u - lo)/(hi - lo)
    where lo = cdf[tri-1] (0 at the segment start) and hi = cdf[tri].
    Conditional on landing in cell tri, u is uniform on [lo, hi), so the
    remap is uniform on [0,1) — required before any nonlinear warp."""
    hi = em_cdf[tri]
    lo = jnp.where(tri > seg0, em_cdf[jnp.maximum(tri - 1, 0)], 0.0)
    return jnp.clip((u - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 1.0 - 1e-7)


def spot_falloff(lights, lid, w):
    """Spot cone falloff for world direction w leaving the light."""
    d = _sel(lights, "direction", lid)
    cos_t = vm.dot(w, d)
    ctm = _sel(lights, "cos_theta_max", lid)
    cfs = _sel(lights, "cos_falloff_start", lid)
    delta = (cos_t - ctm) / jnp.maximum(cfs - ctm, 1e-12)
    f = jnp.clip(delta, 0.0, 1.0) ** 4
    return jnp.where(cos_t < ctm, 0.0, jnp.where(cos_t > cfs, 1.0, f))


def sample_li(lights, tri_data, lid, p, eps, u1, u2):
    """Sample incident illumination at p from light lid (all (R,) batched).

    tri_data: dict with emissive triangle geometry in *segment order*:
      em_v0/em_e1/em_e2 (E,3), em_n (E,3) geometric normals.

    Returns dict: Li (R,3), wi (R,3), pdf (R,), shadow_mint, shadow_maxt,
    is_delta (R,), dist (R,).
    """
    ltype = _sel(lights, "type", lid)
    lcolor = _sel(lights, "color", lid)
    lpos = _sel(lights, "position", lid)
    ldir = _sel(lights, "direction", lid)

    # --- point / spot: direction to the position
    to_l = lpos - p
    dist2 = jnp.maximum(vm.squared_length(to_l), 1e-20)
    dist = jnp.sqrt(dist2)
    wi_pos = to_l / dist[..., None]
    li_point = lcolor / dist2[..., None]
    li_spot = li_point * spot_falloff(lights, lid, -wi_pos)[..., None]

    # --- directional
    wi_dir = -ldir

    # --- area: pick a triangle in the light's segment by area cdf
    seg0 = _sel(lights, "seg_start", lid)
    seg1 = _sel(lights, "seg_start", lid + 1)
    E = lights["em_cdf"].shape[0]
    if E > 0:
        # searchsorted within segment via masked compare-all
        e_idx = jnp.arange(E)
        in_seg = (e_idx[None, :] >= seg0[..., None]) & (
            e_idx[None, :] < seg1[..., None]
        )
        below = in_seg & (lights["em_cdf"][None, :] < u1[..., None])
        tri = jnp.clip(
            seg0 + jnp.sum(below.astype(jnp.int32), axis=-1), 0, E - 1
        )
        # rescale u1 within the chosen cdf cell so the barycentric warp
        # sees a full-range uniform (reference CDF1D::sampleDiscrete's
        # remapped u, src/GoblinSampler.cpp:420-440). Raw re-use would
        # confine sqrt(u1) to a radial band per triangle — biased.
        u1r = _rescale_cdf_u(lights["em_cdf"], tri, seg0, u1)
        erows = jnp.take(tri_data["em_rows"], tri, axis=0)
        v0, e1, e2, n = (erows[..., 0:3], erows[..., 3:6], erows[..., 6:9],
                         erows[..., 9:12])
        bu, bv = sp.uniform_sample_triangle(u1r, u2)
        ps = v0 + bu[..., None] * e1 + bv[..., None] * e2
        to_s = ps - p
        d2 = jnp.maximum(vm.squared_length(to_s), 1e-20)
        dist_a = jnp.sqrt(d2)
        wi_area = to_s / dist_a[..., None]
        cos_l = vm.dot(n, -wi_area)
        total_area = _sel(lights, "area", lid)
        # solid-angle pdf: r^2 / (|cos| * A_total) (reference
        # Geometry::pdf, src/GoblinGeometry.cpp:44-62)
        pdf_area = d2 / jnp.maximum(jnp.abs(cos_l) * total_area, 1e-12)
        # one-sided emission
        li_area = jnp.where((cos_l > 0.0)[..., None], lcolor, 0.0)
    else:
        tri = jnp.zeros_like(lid)
        wi_area = wi_pos
        li_area = jnp.zeros_like(li_point)
        pdf_area = jnp.ones_like(dist)
        dist_a = dist

    is_point = ltype == LIGHT_POINT
    is_dir = ltype == LIGHT_DIRECTIONAL
    is_spot = ltype == LIGHT_SPOT
    is_sphere = _sel(lights, "is_sphere", lid)
    is_area = (ltype == LIGHT_AREA) & ~is_sphere
    is_ibl = ltype == LIGHT_IBL

    # --- sphere area light: cone sampling toward the sphere (reference
    # Sphere::sample(p, u1, u2), src/GoblinSphere.cpp:108-136).
    # Non-sphere rows carry zero-radius placeholders whose degenerate
    # geometry (cos_max=1, |v|~0) has infinite backward partials that
    # would NaN the masked lanes' grads — substitute well-conditioned
    # dummies on those lanes (results are where()-discarded anyway).
    is_sphere = _sel(lights, "is_sphere", lid)
    sc = _sel(lights, "sph_center", lid)
    sr = jnp.where(is_sphere, jnp.maximum(_sel(lights, "sph_radius", lid), 1e-6),
                   1.0)
    v = p - sc
    v_ok = vm.squared_length(v) > 1e-12
    v = jnp.where(
        (is_sphere & v_ok)[..., None], v,
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 4.0]), v.shape),
    )
    sd2 = jnp.maximum(vm.squared_length(v), 1e-20)
    outside = (sd2 - sr * sr) > 1e-4
    z_ax = vm.normalize(-v, eps=1e-30)
    x_ax, y_ax = vm.coordinate_system(z_ax)
    sin2max = jnp.clip(sr * sr / sd2, 0.0, 1.0)
    # double-where sqrt guards: sqrt'(0) = inf would turn the masked
    # (non-sphere) lanes' zero cotangents into NaN grads on sph_center
    cm2 = 1.0 - sin2max
    cm_ok = cm2 > 1e-12
    cos_max = jnp.where(
        cm_ok, jnp.sqrt(jnp.where(cm_ok, cm2, 1.0)), 0.0
    )
    # clamp below 1: at cos_max == 1 (zero-radius placeholder rows on
    # non-sphere lanes) the cone pdf 1/(2pi(1-c)) and the cone warp's
    # sqrt(1-cos^2) have infinite partials that would NaN the masked
    # lanes' backward pass
    cos_max = jnp.minimum(cos_max, 1.0 - 1e-7)
    cone = sp.uniform_sample_cone(u1, u2, cos_max)
    w_cone = (
        cone[..., 0:1] * x_ax + cone[..., 1:2] * y_ax + cone[..., 2:3] * z_ax
    )
    # analytic ray-sphere hit along w_cone (near root); scratch rays use
    # t = d * cosThetaMax like the reference fallback
    b_q = vm.dot(w_cone, -v)
    disc = b_q * b_q - (sd2 - sr * sr)
    d_ok = disc > 1e-12
    t_hit = jnp.where(
        d_ok, b_q - jnp.sqrt(jnp.where(d_ok, disc, 1.0)),
        jnp.sqrt(sd2) * cos_max,
    )
    ps_out = p + t_hit[..., None] * w_cone
    # inside: uniform surface sample
    ps_in = sc + sr[..., None] * sp.uniform_sample_sphere(u1, u2)
    ps_s = jnp.where(outside[..., None], ps_out, ps_in)
    ns_s = vm.normalize(ps_s - sc, eps=1e-30)
    to_ss = ps_s - p
    sdist2 = jnp.maximum(vm.squared_length(to_ss), 1e-20)
    sdist = jnp.sqrt(sdist2)
    wi_sph = to_ss / sdist[..., None]
    cos_sl = vm.dot(ns_s, -wi_sph)
    pdf_sph = jnp.where(
        outside,
        sp.uniform_cone_pdf(cos_max),
        sdist2 / jnp.maximum(
            jnp.abs(cos_sl) * _sel(lights, "area", lid), 1e-12
        ),
    )
    li_sph = jnp.where((cos_sl > 0.0)[..., None], lcolor, 0.0)

    wi = jnp.where(
        is_area[..., None],
        wi_area,
        jnp.where(
            is_sphere[..., None], wi_sph,
            jnp.where(is_dir[..., None],
                      jnp.broadcast_to(wi_dir, wi_pos.shape), wi_pos),
        ),
    )
    Li = jnp.where(
        is_point[..., None],
        li_point,
        jnp.where(
            is_spot[..., None],
            li_spot,
            jnp.where(
                is_dir[..., None],
                jnp.broadcast_to(lcolor, li_point.shape),
                jnp.where(is_sphere[..., None], li_sph, li_area),
            ),
        ),
    )
    # IBL NEE sampling is handled by the env CDF2D path (integrators/
    # envmap.py); until a lane routes there, IBL lanes contribute 0 on the
    # light-sample side and the BSDF side takes full MIS weight — unbiased.
    Li = jnp.where(is_ibl[..., None], 0.0, Li)
    pdf = jnp.where(is_area, pdf_area, jnp.where(is_sphere, pdf_sph, 1.0))
    shadow_maxt = jnp.where(
        is_dir,
        jnp.full_like(dist, 3.0e37),
        jnp.where(
            is_area, dist_a - eps,
            jnp.where(is_sphere, sdist - eps, dist - eps),
        ),
    )
    is_delta = is_point | is_dir | is_spot
    return {
        "Li": Li,
        "wi": wi,
        "pdf": pdf,
        "shadow_maxt": shadow_maxt,
        "is_delta": is_delta,
        "dist": jnp.where(is_area, dist_a,
                          jnp.where(is_sphere, sdist, dist)),
    }


def sample_emission(lights, tri_data, lid, u_p1, u_p2, u_d1, u_d2):
    """Photon-emission sampling (LT/BDPT/SPPM light-walk start).

    Mirrors the reference samplePosition/sampleDirection pairs
    (src/GoblinLight.cpp): point -> uniform sphere; directional -> world
    bounding-sphere disk + fixed dir; spot -> uniform cone; area ->
    area-uniform triangle point + cosine hemisphere; ibl -> uniform
    point on the world bounding sphere with inward normal + cosine
    hemisphere about that normal
    (ImageBasedLight::samplePosition/sampleDirection,
    src/GoblinLight.cpp:557-583). Deliberate divergence: the reference
    reports pdfArea = 1/(4pi) "omitting the radius factor", but the
    actual area density of a uniform bounding-sphere point is
    1/(4 pi r^2); using the true density keeps LT/BDPT particle
    throughput unbiased (the omission cancels in MIS ratios but NOT in
    absolute throughput — it shows up as an exactly r^2 energy deficit
    in the LT-vs-PT env consistency test).

    Returns dict: p (R,3), n (R,3) (zeros for delta positions), dir
    (R,3), pdf_pos (R,), pdf_dir (R,), is_delta (R,).
    """
    ltype = _sel(lights, "type", lid)
    lpos = _sel(lights, "position", lid)
    ldir = _sel(lights, "direction", lid)
    wc = lights["world_center"]
    wr = lights["world_radius"]

    # point / spot position (delta)
    p_point = jnp.broadcast_to(lpos, u_p1.shape + (3,))

    # directional position: disk on the bounding sphere
    x_ax, y_ax = vm.coordinate_system(ldir)
    disk = sp.uniform_sample_disk(u_p1, u_p2)
    p_dir = (
        wc
        + wr * (disk[..., 0:1] * x_ax + disk[..., 1:2] * y_ax)
        - ldir * wr
    )

    # area position: triangle sample in the light's segment
    seg0 = _sel(lights, "seg_start", lid)
    seg1 = _sel(lights, "seg_start", lid + 1)
    E = lights["em_cdf"].shape[0]
    if E > 0:
        e_idx = jnp.arange(E)
        in_seg = (e_idx[None, :] >= seg0[..., None]) & (
            e_idx[None, :] < seg1[..., None]
        )
        below = in_seg & (lights["em_cdf"][None, :] < u_p1[..., None])
        tri = jnp.clip(seg0 + jnp.sum(below.astype(jnp.int32), axis=-1), 0,
                       E - 1)
        u1r = _rescale_cdf_u(lights["em_cdf"], tri, seg0, u_p1)
        erows = jnp.take(tri_data["em_rows"], tri, axis=0)
        bu, bv = sp.uniform_sample_triangle(u1r, u_p2)
        p_area = (
            erows[..., 0:3]
            + bu[..., None] * erows[..., 3:6]
            + bv[..., None] * erows[..., 6:9]
        )
        n_area = erows[..., 9:12]
    else:
        p_area = p_point
        n_area = jnp.broadcast_to(ldir, p_point.shape)
    # sphere emitters: uniform surface position (reference
    # Sphere::sample(u1,u2), src/GoblinSphere.cpp:103-106)
    is_sph = _sel(lights, "is_sphere", lid)
    sph_n = sp.uniform_sample_sphere(u_p1, u_p2)
    p_sph = (_sel(lights, "sph_center", lid)
             + _sel(lights, "sph_radius", lid)[..., None] * sph_n)
    p_area = jnp.where(is_sph[..., None], p_sph, p_area)
    n_area = jnp.where(is_sph[..., None], sph_n, n_area)

    is_point = ltype == LIGHT_POINT
    is_dir = ltype == LIGHT_DIRECTIONAL
    is_spot = ltype == LIGHT_SPOT
    is_area = ltype == LIGHT_AREA
    is_ibl = ltype == LIGHT_IBL

    # ibl position: uniform point on the world bounding sphere, normal
    # pointing inward (ImageBasedLight::samplePosition)
    sph_dir = sp.uniform_sample_sphere(u_p1, u_p2)
    p_ibl = wc + wr * sph_dir
    n_ibl = -sph_dir

    p = jnp.where(
        is_area[..., None], p_area,
        jnp.where(
            is_ibl[..., None], p_ibl,
            jnp.where(is_dir[..., None], p_dir, p_point),
        ),
    )
    n_emit = jnp.where(is_ibl[..., None], n_ibl, n_area)
    n = jnp.where((is_area | is_ibl)[..., None], n_emit, 0.0)
    pdf_pos = jnp.where(
        is_dir,
        1.0 / (jnp.pi * wr * wr),
        jnp.where(
            is_area, 1.0 / jnp.maximum(_sel(lights, "area", lid), 1e-20),
            jnp.where(is_ibl, 1.0 / (4.0 * jnp.pi * wr * wr), 1.0),
        ),
    )

    # directions
    d_sphere = sp.uniform_sample_sphere(u_d1, u_d2)
    cone_local = sp.uniform_sample_cone(u_d1, u_d2,
                                        _sel(lights, "cos_theta_max", lid))
    lx, ly = vm.coordinate_system(ldir)
    d_cone = (
        cone_local[..., 0:1] * lx + cone_local[..., 1:2] * ly
        + cone_local[..., 2:3] * ldir
    )
    cos_local = sp.cosine_sample_hemisphere(u_d1, u_d2)
    ax, ay = vm.coordinate_system(n_emit)
    d_cos = (
        cos_local[..., 0:1] * ax + cos_local[..., 1:2] * ay
        + cos_local[..., 2:3] * n_emit
    )

    d = jnp.where(
        (is_area | is_ibl)[..., None], d_cos,
        jnp.where(
            is_dir[..., None], jnp.broadcast_to(ldir, d_sphere.shape),
            jnp.where(is_spot[..., None], d_cone, d_sphere),
        ),
    )
    pdf_dir = jnp.where(
        is_point,
        sp.uniform_sphere_pdf(),
        jnp.where(
            is_spot,
            sp.uniform_cone_pdf(_sel(lights, "cos_theta_max", lid)),
            jnp.where(
                is_area | is_ibl,
                jnp.maximum(cos_local[..., 2], 0.0) * (1.0 / jnp.pi),
                1.0,
            ),
        ),
    )
    is_delta = is_point | is_dir | is_spot
    return {
        "p": p, "n": n, "dir": d,
        "pdf_pos": pdf_pos, "pdf_dir": pdf_dir, "is_delta": is_delta,
    }


def eval_emission(lights, lid, n_light, wo, env_le=None):
    """Emitted radiance/intensity toward wo (reference Light::eval).

    env_le: (R,3) environment radiance for direction -wo (the caller
    evaluates envmap.eval_env(scene, meta, -wo) when the scene has an
    IBL — ImageBasedLight::eval looks the map up at -wo,
    src/GoblinLight.cpp:600-608); IBL lanes emit 0 when omitted."""
    ltype = _sel(lights, "type", lid)
    lcolor = _sel(lights, "color", lid)
    is_point = ltype == LIGHT_POINT
    is_dir = ltype == LIGHT_DIRECTIONAL
    is_spot = ltype == LIGHT_SPOT
    is_area = ltype == LIGHT_AREA
    ldir = _sel(lights, "direction", lid)
    spot = spot_falloff(lights, lid, wo)[..., None] * lcolor
    parallel = jnp.abs(vm.dot(wo, ldir) - 1.0) < 1e-5
    dir_e = jnp.where(parallel[..., None], lcolor, 0.0)
    area_e = jnp.where((vm.dot(n_light, wo) > 0.0)[..., None], lcolor, 0.0)
    ibl_e = env_le if env_le is not None else jnp.zeros_like(lcolor)
    return jnp.where(
        is_point[..., None], lcolor,
        jnp.where(
            is_spot[..., None], spot,
            jnp.where(
                is_dir[..., None], dir_e,
                jnp.where(
                    is_area[..., None], area_e,
                    jnp.where((ltype == LIGHT_IBL)[..., None], ibl_e, 0.0),
                ),
            ),
        ),
    )


def pdf_emission_direction(lights, lid, n_light, w):
    """Light::pdfDirection — pdf of emitting direction w from the light
    (solid angle): point -> 1/4pi; spot -> cone pdf; directional -> 0;
    area / ibl -> cos/pi one-sided (reference per-type pdfDirection;
    ImageBasedLight::pdfDirection src/GoblinLight.cpp:592-597)."""
    ltype = _sel(lights, "type", lid)
    cone = sp.uniform_cone_pdf(_sel(lights, "cos_theta_max", lid))
    cos_t = vm.dot(w, _sel(lights, "direction", lid))
    # spot pdfDirection ignores falloff (reference SpotLight::pdfDirection)
    area_cos = vm.dot(n_light, w)
    return jnp.where(
        ltype == LIGHT_POINT,
        sp.uniform_sphere_pdf(),
        jnp.where(
            ltype == LIGHT_SPOT,
            cone,
            jnp.where(
                (ltype == LIGHT_AREA) | (ltype == LIGHT_IBL),
                jnp.maximum(area_cos, 0.0) * (1.0 / jnp.pi),
                0.0,
            ),
        ),
    )


def pdf_emission_position(lights, lid):
    """Light::pdfPosition — area pdf of the emission position (ibl: the
    true bounding-sphere density 1/(4 pi r^2); see the sample_emission
    docstring for the deliberate divergence from the reference's
    radius-omitted 1/(4pi), src/GoblinLight.cpp:585-590)."""
    ltype = _sel(lights, "type", lid)
    wr = lights["world_radius"]
    return jnp.where(
        ltype == LIGHT_DIRECTIONAL,
        1.0 / (jnp.pi * wr * wr),
        jnp.where(
            ltype == LIGHT_AREA,
            1.0 / jnp.maximum(_sel(lights, "area", lid), 1e-20),
            jnp.where(
                ltype == LIGHT_IBL, 1.0 / (4.0 * jnp.pi * wr * wr), 0.0
            ),
        ),
    )


def pdf_li(lights, lid, p, wi, hit_t, hit_cos, hit_light):
    """Solid-angle pdf that light lid generates direction wi from p, given
    the BSDF ray's actual hit (t, |cos| at the light, hit light id).

    Used for MIS on the BSDF-sampling side: non-delta lights only. For
    area lights the pdf is r^2/(|cos| A); 0 when the hit isn't this light.
    """
    ltype = _sel(lights, "type", lid)
    is_sphere = _sel(lights, "is_sphere", lid)
    is_area = (ltype == LIGHT_AREA) & ~is_sphere
    total_area = _sel(lights, "area", lid)
    ok = (is_area | is_sphere) & (hit_light == lid)
    # clamp t under the mask: miss lanes carry t = BIG_T whose square is
    # inf, which would poison the backward pass through the where
    t_ok = jnp.where(ok, hit_t, 1.0)
    pdf_area = (t_ok * t_ok) / jnp.maximum(
        jnp.abs(hit_cos) * total_area, 1e-12
    )
    # sphere emitters: cone solid-angle pdf from outside (reference
    # Sphere::pdf, src/GoblinSphere.cpp:138-150)
    v = p - _sel(lights, "sph_center", lid)
    sd2 = jnp.maximum(vm.squared_length(v), 1e-20)
    sr = _sel(lights, "sph_radius", lid)
    sin2max = jnp.clip(sr * sr / sd2, 0.0, 1.0)
    cm2 = 1.0 - sin2max
    cm_ok = cm2 > 1e-12
    cos_max = jnp.where(
        cm_ok, jnp.sqrt(jnp.where(cm_ok, cm2, 1.0)), 0.0
    )
    cos_max = jnp.minimum(cos_max, 1.0 - 1e-7)  # see sample_li clamp
    outside = (sd2 - sr * sr) > 1e-4
    pdf_sph = jnp.where(
        outside, sp.uniform_cone_pdf(cos_max), pdf_area
    )
    return jnp.where(ok, jnp.where(is_sphere, pdf_sph, pdf_area), 0.0)
