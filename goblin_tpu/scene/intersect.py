"""Wavefront scene intersection: BVH trace + analytic prims + hit refine.

The reference's Scene::intersect returns a full Intersection object per
ray recursively (src/GoblinScene.cpp:75-95). Here the whole ray batch is
traced (accel/traverse), analytic spheres are tested densely, and a
*refine* stage gathers per-triangle shading data to build the batched
fragment dict — the wavefront analogue of Fragment
(src/GoblinGeometry.h:13-130):

    frag = {p, ns, ng, uv, dpdu, mat, light, eps, hit, t, wo}

Epsilon conventions: hit eps = 1e-3 * t (src/GoblinTriangle.cpp:84).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel.traverse import TraceResult, trace
from ..core import vecmath as vm
from ..geometry.intersect import BIG_T, intersect_sphere
from .bake import SceneMeta

HIT_EPS_SCALE = 1e-3


def _morton_key(o, d, mint, maxt, bmin, inv_ext):
    """Ray-coherence sort key: 6-bit-per-axis Morton code of the ray
    origin within the scene bounds, 3-bit direction octant above it, and
    a dead-ray flag on top so dead lanes gather at the end."""
    q = jnp.clip((o - bmin) * inv_ext * 63.0, 0.0, 63.0).astype(jnp.int32)

    def spread(x):  # bits -> every 3rd position (standard morton masks)
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = (
        spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)
    )
    dead = (maxt <= mint).astype(jnp.int32)
    return (dead << 24) | (_octant(d) << 18) | morton


def _octant(d):
    return (
        (d[..., 0] < 0).astype(jnp.int32)
        | ((d[..., 1] < 0).astype(jnp.int32) << 1)
        | ((d[..., 2] < 0).astype(jnp.int32) << 2)
    )


def _octant_partition(d, mint, maxt):
    """Stable counting-sort permutation over a 4-bit key (dead flag on
    top of the direction octant): rays keep their screen-tile order
    within a bucket while neighbouring rays share a direction octant,
    and dead lanes gather at the end. O(16R) cumsum work, no sort."""
    dead = (maxt <= mint).astype(jnp.int32)
    key = (dead << 3) | _octant(d)  # [0, 16)
    onehot = (key[:, None] == jnp.arange(16, dtype=jnp.int32)[None, :])
    ranks = jnp.cumsum(onehot.astype(jnp.int32), axis=0)  # rank+1 in bucket
    totals = ranks[-1]
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(totals)[:-1].astype(jnp.int32)]
    )
    rank = jnp.take_along_axis(ranks, key[:, None], axis=1)[:, 0] - 1
    pos = offsets[key] + rank
    # permutation inverse by argsort
    return jnp.argsort(pos)


def _ray_order(meta: SceneMeta, o, d, mint, maxt, sort):
    """Optional coherence permutation applied before the trace (None =
    trace in the order given). sort: "dir" = stable (dead, octant,
    dominant axis) sort; "octant" = counting-sort partition; any other
    truthy value = Morton + octant sort; meta.trace_compact = stable
    alive-first partition."""
    if sort == "dir":
        axis = jnp.argmax(jnp.abs(d), axis=-1).astype(jnp.int32)
        dead = (maxt <= mint).astype(jnp.int32)
        key = (dead << 5) | (_octant(d) << 2) | axis
        return jnp.argsort(key, stable=True)
    if sort == "octant":
        return _octant_partition(d, mint, maxt)
    if sort:
        bmin, bmax = meta.world_bounds
        bmin = jnp.asarray(bmin, jnp.float32)
        inv_ext = 1.0 / jnp.maximum(
            jnp.asarray(bmax, jnp.float32) - bmin, 1e-12
        )
        return jnp.argsort(_morton_key(o, d, mint, maxt, bmin, inv_ext))
    if meta.trace_compact:
        # stable alive-partition: live lanes to the front in their
        # original order (a cumsum-built permutation), dead lanes after
        alive = maxt > mint
        na = jnp.cumsum(alive.astype(jnp.int32))
        nd = jnp.cumsum((~alive).astype(jnp.int32))
        pos = jnp.where(alive, na - 1, na[-1] + nd - 1)
        return jnp.argsort(pos)
    return None


def trace_rays(scene, meta: SceneMeta, o, d, mint, maxt, any_hit=False,
               sort=None):
    """BVH trace over the wavefront, dispatched by meta.trace_backend:
    "kernel" runs the GPU kernel (ops/trace_kernel), "interpret" the same
    kernel in the Pallas interpreter, "jnp" the lockstep reference
    (accel/traverse). All replace the reference's per-thread stack walk
    (src/GoblinBVH.cpp:156-280).

    sort: per-call override of meta.trace_sort (see _ray_order). The
    permutation, when there is one, wraps whichever trace runs, and the
    results come back in the caller's order.
    """
    if sort is None:
        sort = meta.trace_sort
    order = _ray_order(meta, o, d, mint, maxt, sort)
    if order is not None:
        o, d, mint, maxt = (v[order] for v in (o, d, mint, maxt))
    args = (scene["node_bounds"], scene["node_meta"], scene["tri_soup"],
            o, d, mint, maxt)
    if meta.trace_backend == "jnp":
        res = trace(*args, max_leaf=meta.max_leaf, any_hit=any_hit)
    else:
        from ..ops import trace_kernel

        res = trace_kernel.trace(
            *args, max_leaf=meta.max_leaf, any_hit=any_hit,
            interpret=meta.trace_backend == "interpret",
        )
    if order is not None:
        # inverse permutation via argsort
        inv = jnp.argsort(order)
        res = TraceResult(*(v[inv] for v in res))
    return res


def _disk_pass(scene, o, d, mint, cur_t):
    """Dense test against analytic z=0-plane disks (world-space plane
    form; reference GoblinDisk.cpp:12-56). Returns (hit_id, t)."""
    D = scene["dsk_center"].shape[0]
    best_t = cur_t
    best = jnp.full(o.shape[:-1], -1, jnp.int32)
    for k in range(D):  # D is small and static
        c = scene["dsk_center"][k]
        n = scene["dsk_n"][k]
        r = scene["dsk_radius"][k]
        den = vm.dot(d, n)
        ok_den = jnp.abs(den) > 1e-7
        t = vm.dot(c - o, n) / jnp.where(ok_den, den, 1.0)
        p = o + t[..., None] * d
        q = p - c
        in_r = vm.squared_length(q) <= r * r
        upd = ok_den & in_r & (t >= mint) & (t < best_t)
        best_t = jnp.where(upd, t, best_t)
        best = jnp.where(upd, k, best)
    return best, best_t


def _sphere_pass(scene, o, d, mint, cur_t):
    """Dense test against analytic spheres; returns (hit_id, t) with
    hit_id = -1 when no sphere beats cur_t."""
    S = scene["sph_center"].shape[0]
    best_t = cur_t
    best = jnp.full(o.shape[:-1], -1, jnp.int32)
    for s in range(S):  # S is small and static
        hit, t = intersect_sphere(
            o, d, scene["sph_center"][s], scene["sph_radius"][s], mint, best_t
        )
        upd = hit & (t < best_t)
        best_t = jnp.where(upd, t, best_t)
        best = jnp.where(upd, s, best)
    return best, best_t


def intersect(scene, meta: SceneMeta, o, d, mint, maxt, dxd=None, dyd=None,
              sort=None):
    """Closest-hit over the whole scene. Returns the fragment dict.

    dxd/dyd: optional (R,3) camera ray-differential directions (same
    origin as o). When given, the fragment carries uv differentials
    (duv4 = [dudx, dvdx, dudy, dvdy] and duv = conservative widths) by
    intersecting the aux rays with the hit tangent plane and solving the
    2x2 system dpdx = dudx*dpdu + dvdx*dpdv on the two dominant axes —
    the wavefront analogue of Intersection::computeUVDifferential
    (reference src/GoblinPrimitive.cpp:32-97).

    The discrete traversal decision (which triangle) is non-differentiable
    and wrapped in stop_gradient; shading quantities are then recomputed
    from gathered primitive data so VJPs flow through materials/lights
    (SURVEY.md §7: differentiable layer — reparameterized visibility for
    geometry gradients is future work).
    """
    res = trace_rays(
        jax.lax.stop_gradient(scene), meta,
        jax.lax.stop_gradient(o), jax.lax.stop_gradient(d),
        jax.lax.stop_gradient(mint), jax.lax.stop_gradient(maxt),
        sort=sort,
    )
    t = res.t
    tri = res.tri
    b1, b2 = res.b1, res.b2
    hit = res.hit

    sph_id = None
    if meta.n_spheres > 0:
        sph_id, t2 = _sphere_pass(scene, o, d, mint, t)
        sph_hit = sph_id >= 0
        hit = hit | sph_hit
        t = jnp.where(sph_hit, t2, t)
    else:
        sph_hit = jnp.zeros_like(hit)

    if meta.n_disks > 0:
        dsk_id, t3 = _disk_pass(scene, o, d, mint, t)
        dsk_hit = dsk_id >= 0
        hit = hit | dsk_hit
        t = jnp.where(dsk_hit, t3, t)
        sph_hit = sph_hit & ~dsk_hit  # a closer disk wins the lane
    else:
        dsk_hit = jnp.zeros_like(hit)

    # --- refine triangles: ONE fused row gather for all per-triangle
    # shading data (positions + normals + uvs, 24 contiguous floats) —
    # separate gathers each pay XLA's row-gather cost; the concatenate is
    # constant-folded when the scene is a closed-over constant and stays
    # differentiable when tri_soup is a differentiation input
    tri_c = jnp.maximum(tri, 0)
    T_n = scene["tri_soup"].shape[0]
    shade_rows = jnp.concatenate(
        [
            scene["tri_soup"],
            scene["tri_n"].reshape(T_n, 9),
            scene["tri_uv"].reshape(T_n, 6),
            # int ids ride the same row gather, bitcast through f32
            jax.lax.bitcast_convert_type(
                scene["tri_mat"], jnp.float32
            )[:, None],
            jax.lax.bitcast_convert_type(
                scene["tri_light"], jnp.float32
            )[:, None],
        ],
        axis=-1,
    )
    packed = jnp.take(shade_rows, tri_c, axis=0)
    soup = packed[..., 0:9]
    v0, e1, e2 = soup[..., 0:3], soup[..., 3:6], soup[..., 6:9]

    # Differentiable hit recompute (SURVEY.md §7): the traversal's discrete
    # pick (which triangle) is detached, but t and the barycentrics are
    # re-derived by Möller–Trumbore on the *non-detached* gathered triangle
    # so hit points / normals / uvs carry gradients w.r.t. vertex positions.
    pvec = jnp.cross(d, e2)
    det_mt = vm.dot(e1, pvec)
    inv_mt = 1.0 / jnp.where(jnp.abs(det_mt) < 1e-20, 1.0, det_mt)
    tvec = o - v0
    b1_d = vm.dot(tvec, pvec) * inv_mt
    qvec = jnp.cross(tvec, e1)
    b2_d = vm.dot(d, qvec) * inv_mt
    t_d = vm.dot(e2, qvec) * inv_mt
    tri_hit = (
        hit & ~sph_hit & ~dsk_hit & (tri >= 0) & (jnp.abs(det_mt) >= 1e-20)
    )
    t = jnp.where(tri_hit, t_d, t)
    b1 = jnp.where(tri_hit, b1_d, b1)
    b2 = jnp.where(tri_hit, b2_d, b2)

    # miss lanes keep t = BIG_T; clamp the t used for the shading point so
    # no inf enters downstream math (inf * 0 = NaN in the backward pass —
    # miss-lane values are masked by `hit` everywhere they matter)
    p = o + jnp.where(hit, t, 1.0)[..., None] * d
    b0 = 1.0 - b1 - b2
    n_rows = packed[..., 9:18].reshape(packed.shape[:-1] + (3, 3))
    ns_tri = vm.normalize(
        b0[..., None] * n_rows[..., 0, :]
        + b1[..., None] * n_rows[..., 1, :]
        + b2[..., None] * n_rows[..., 2, :],
        eps=1e-30,
    )
    ng_tri = vm.normalize(jnp.cross(e1, e2), eps=1e-30)
    uv_rows = packed[..., 18:24].reshape(packed.shape[:-1] + (3, 2))
    uv_tri = (
        b0[..., None] * uv_rows[..., 0, :]
        + b1[..., None] * uv_rows[..., 1, :]
        + b2[..., None] * uv_rows[..., 2, :]
    )
    # dpdu from the uv edge matrix (src/GoblinTriangle.cpp:107-122)
    du1 = uv_rows[..., 1, 0] - uv_rows[..., 0, 0]
    dv1 = uv_rows[..., 1, 1] - uv_rows[..., 0, 1]
    du2 = uv_rows[..., 2, 0] - uv_rows[..., 0, 0]
    dv2 = uv_rows[..., 2, 1] - uv_rows[..., 0, 1]
    det = du1 * dv2 - dv1 * du2
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1.0, det)
    dpdu_tri = inv_det[..., None] * (dv2[..., None] * e1 - dv1[..., None] * e2)
    dpdv_tri = inv_det[..., None] * (-du2[..., None] * e1 + du1[..., None] * e2)
    degenerate = jnp.abs(det) < 1e-20
    fallback, fallback_v = vm.coordinate_system(ns_tri)
    dpdu_tri = jnp.where(degenerate[..., None], fallback, dpdu_tri)
    dpdv_tri = jnp.where(degenerate[..., None], fallback_v, dpdv_tri)
    mat_tri = jax.lax.bitcast_convert_type(packed[..., 24], jnp.int32)
    light_tri = jax.lax.bitcast_convert_type(packed[..., 25], jnp.int32)

    if meta.n_spheres > 0:
        sc = jnp.take(scene["sph_center"], jnp.maximum(sph_id, 0), axis=0)
        sr = jnp.take(scene["sph_radius"], jnp.maximum(sph_id, 0))
        ns_s = vm.normalize(p - sc, eps=1e-30)
        # spherical uv (phi/2pi, theta/pi) and dpdu along longitude
        phi = vm.spherical_phi(ns_s)
        theta = vm.spherical_theta(ns_s)
        uv_s = jnp.stack([phi / (2 * jnp.pi), theta / jnp.pi], axis=-1)
        dpdu_s = jnp.stack(
            [-ns_s[..., 1], ns_s[..., 0], jnp.zeros_like(phi)], axis=-1
        )
        dpdu_s = jnp.where(
            vm.squared_length(dpdu_s)[..., None] < 1e-12,
            vm.coordinate_system(ns_s)[0],
            dpdu_s,
        )
        # dpdv along latitude: r*dtheta direction, scaled to v = theta/pi
        # (analytic sphere partials, reference src/GoblinSphere.cpp:61-75)
        st = jnp.sin(theta)
        ct = jnp.cos(theta)
        dpdv_s = (jnp.pi * sr)[..., None] * jnp.stack(
            [ct * jnp.cos(phi), ct * jnp.sin(phi), -st], axis=-1
        )
        m = sph_hit[..., None]
        ns = jnp.where(m, ns_s, ns_tri)
        ng = jnp.where(m, ns_s, ng_tri)
        uv = jnp.where(m, uv_s, uv_tri)
        dpdu = jnp.where(m, dpdu_s, dpdu_tri)
        dpdv = jnp.where(m, dpdv_s, dpdv_tri)
        # derivative-scaled dpdu for duv: sphere dpdu w.r.t. u = 2*pi*r*...
        dpdu_deriv = jnp.where(m, (2 * jnp.pi) * sr[..., None] * dpdu_s, dpdu_tri)
        mat = jnp.where(sph_hit, jnp.take(scene["sph_mat"], jnp.maximum(sph_id, 0)),
                        mat_tri)
        light = jnp.where(
            sph_hit, jnp.take(scene["sph_light"], jnp.maximum(sph_id, 0)), light_tri
        )
    else:
        ns, ng, uv, dpdu, dpdv, mat, light = (
            ns_tri, ng_tri, uv_tri, dpdu_tri, dpdv_tri, mat_tri, light_tri
        )
        dpdu_deriv = dpdu_tri

    if meta.n_disks > 0:
        # analytic-disk shading frame (reference GoblinDisk.cpp:31-61:
        # uv = (phi/2pi, r/R), dpdu = [-2pi y, 2pi x], dpdv = R*[x,y]/r
        # in the disk's local frame; normal is the local +z, one-sided)
        did = jnp.maximum(dsk_id, 0)
        dc = jnp.take(scene["dsk_center"], did, axis=0)
        dn = jnp.take(scene["dsk_n"], did, axis=0)
        du_ax = jnp.take(scene["dsk_u"], did, axis=0)
        dr = jnp.take(scene["dsk_radius"], did)
        dv_ax = jnp.cross(dn, du_ax)
        q = p - dc
        xl = vm.dot(q, du_ax)
        yl = vm.dot(q, dv_ax)
        rl = jnp.sqrt(jnp.maximum(xl * xl + yl * yl, 1e-20))
        phi = jnp.arctan2(yl, xl)
        phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
        uv_d = jnp.stack(
            [phi / (2.0 * jnp.pi), rl / jnp.maximum(dr, 1e-20)], axis=-1
        )
        two_pi = 2.0 * jnp.pi
        dpdu_d = two_pi * (-yl[..., None] * du_ax + xl[..., None] * dv_ax)
        dpdv_d = (dr / rl)[..., None] * (
            xl[..., None] * du_ax + yl[..., None] * dv_ax
        )
        m = dsk_hit[..., None]
        ns = jnp.where(m, dn, ns)
        ng = jnp.where(m, dn, ng)
        uv = jnp.where(m, uv_d, uv)
        dpdu = jnp.where(m, dpdu_d, dpdu)
        dpdv = jnp.where(m, dpdv_d, dpdv)
        dpdu_deriv = jnp.where(m, dpdu_d, dpdu_deriv)
        mat = jnp.where(dsk_hit, jnp.take(scene["dsk_mat"], did), mat)
        light = jnp.where(dsk_hit, jnp.take(scene["dsk_light"], did), light)
        is_lens = dsk_hit & jnp.take(scene["dsk_lens"], did)
    else:
        is_lens = jnp.zeros_like(hit)

    frag = {
        "is_lens": is_lens,
        "hit": hit,
        "t": t,
        "p": p,
        "ns": ns,
        "ng": ng,
        "uv": uv,
        "dpdu": dpdu,
        "dpdv": dpdv,
        "mat": jnp.where(hit, mat, 0),
        "light": jnp.where(hit, light, -1),
        "eps": HIT_EPS_SCALE * jnp.where(hit, t, 1.0),
        "wo": -d,
    }
    if dxd is not None:
        frag["duv4"], frag["duv"] = _uv_differentials(
            o, dxd, dyd, p, ng, dpdu_deriv, dpdv, hit
        )
    else:
        # keep the fragment pytree structure identical across bounces
        # (path.py tree_maps primary + continuation fragments together)
        frag["duv4"] = jnp.zeros(t.shape + (4,), jnp.float32)
        frag["duv"] = jnp.zeros(t.shape + (2,), jnp.float32)
    if getattr(meta, "has_perturb", False):
        frag = _perturb(scene, meta, frag)
    return frag


def _uv_differentials(o, dxd, dyd, p, n, dpdu, dpdv, hit):
    """Solve dpdx = dudx*dpdu + dvdx*dpdv (and dy) on the two dominant
    axes of n (reference computeUVDifferential's axis pick + 2x2 solve,
    src/GoblinPrimitive.cpp:32-97). Aux rays share the primary origin
    (camera differentials offset by one pixel). Returns
    (duv4 (R,4) = [dudx, dvdx, dudy, dvdy], duv (R,2) widths)."""
    pon = vm.dot(p - o, n)

    def plane_hit(dd):
        den = vm.dot(dd, n)
        ok = jnp.abs(den) > 1e-12
        tt = pon / jnp.where(ok, den, 1.0)
        return o + tt[..., None] * dd - p, ok & (tt > 0.0)

    dpdx, okx = plane_hit(dxd)
    dpdy, oky = plane_hit(dyd)

    an = jnp.abs(n)
    # axis pair (a, b): drop the dominant normal axis
    ax_x = jnp.where(an[..., 0] > jnp.maximum(an[..., 1], an[..., 2]), 1, 0)
    ax_y = jnp.where(an[..., 2] > jnp.maximum(an[..., 0], an[..., 1]), 1, 2)

    def pick(v, ax):
        return jnp.take_along_axis(v, ax[..., None], axis=-1)[..., 0]

    a11 = pick(dpdu, ax_x)
    a12 = pick(dpdv, ax_x)
    a21 = pick(dpdu, ax_y)
    a22 = pick(dpdv, ax_y)
    det = a11 * a22 - a12 * a21
    ok_det = jnp.abs(det) > 1e-16
    inv = 1.0 / jnp.where(ok_det, det, 1.0)

    def solve(dp, ok):
        b1 = pick(dp, ax_x)
        b2 = pick(dp, ax_y)
        du = (a22 * b1 - a12 * b2) * inv
        dv = (a11 * b2 - a21 * b1) * inv
        valid = ok & ok_det & hit
        return jnp.where(valid, du, 0.0), jnp.where(valid, dv, 0.0)

    dudx, dvdx = solve(dpdx, okx)
    dudy, dvdy = solve(dpdy, oky)
    duv4 = jnp.stack([dudx, dvdx, dudy, dvdy], axis=-1)
    duv = jnp.stack(
        [jnp.maximum(jnp.abs(dudx), jnp.abs(dudy)),
         jnp.maximum(jnp.abs(dvdx), jnp.abs(dvdy))],
        axis=-1,
    )
    return duv4, duv


def _perturb(scene, meta: SceneMeta, frag):
    """Bump / normal-map shading-normal perturbation applied at hit time,
    the wavefront analogue of Material::perturb called from
    Scene::intersect (reference src/GoblinMaterial.cpp:221-283,
    src/GoblinScene.cpp:75-83). Bump: forward-difference the height map
    along u/v and tilt dpdu/dpdv; normal map: decode a tangent-space
    normal. Lanes whose material has neither are untouched."""
    uv = frag["uv"]
    ns = frag["ns"]
    dpdu = frag["dpdu"]
    dpdv = frag["dpdv"]
    mid = frag["mat"]
    bump_id = jnp.take(scene["mat_bump"], mid)
    norm_id = jnp.take(scene["mat_normal"], mid)

    duv = frag.get("duv")
    if duv is None:
        du = jnp.full(uv.shape[:-1], 5e-4, jnp.float32)
        dv = du
    else:
        du = jnp.maximum(duv[..., 0], 5e-4)
        dv = jnp.maximum(duv[..., 1], 5e-4)

    ftex = meta.float_texture_system
    atlas = scene.get("ftex_atlas")
    const = scene.get("ftex_const")
    p = frag.get("p")

    from ..integrators.materials import _pick

    def h(uv_q):
        stack = ftex.eval_all(uv_q, atlas=atlas, const=const, p=p)
        return _pick(stack, jnp.maximum(bump_id, 0))[..., 0]

    h0 = h(uv)
    hu = h(uv + jnp.stack([du, jnp.zeros_like(du)], -1))
    hv = h(uv + jnp.stack([jnp.zeros_like(dv), dv], -1))
    dhdu = (hu - h0) / du
    dhdv = (hv - h0) / dv
    bu = dpdu + dhdu[..., None] * ns
    bv = dpdv + dhdv[..., None] * ns
    n_bump = vm.normalize(jnp.cross(bu, bv), eps=1e-30)
    # keep orientation consistent with the original shading normal
    n_bump = jnp.where(
        vm.dot(n_bump, ns)[..., None] < 0.0, -n_bump, n_bump
    )
    has_bump = (bump_id >= 0)[..., None]
    ns = jnp.where(has_bump, n_bump, ns)
    dpdu = jnp.where(has_bump, bu, dpdu)
    dpdv = jnp.where(has_bump, bv, dpdv)

    ctex = meta.texture_system
    tex_stack = ctex.eval_all(
        uv, atlas=scene.get("tex_atlas"), const=scene.get("tex_const"),
        p=frag.get("p"),
    )
    c = _pick(tex_stack, jnp.maximum(norm_id, 0))
    n_ts = 2.0 * c - 1.0  # tangent-space decode
    t_ = vm.normalize(
        dpdu - vm.dot(dpdu, ns)[..., None] * ns, eps=1e-30
    )
    b_ = jnp.cross(ns, t_)
    n_map = vm.normalize(
        n_ts[..., 0:1] * t_ + n_ts[..., 1:2] * b_ + n_ts[..., 2:3] * ns,
        eps=1e-30,
    )
    has_norm = (norm_id >= 0)[..., None]
    ns = jnp.where(has_norm, n_map, ns)

    out = dict(frag)
    out["ns"] = ns
    out["dpdu"] = dpdu
    out["dpdv"] = dpdv
    return out


def occluded_attenuated(scene, meta: SceneMeta, o, d, mint, maxt,
                        max_punch: int = 4, sort=None):
    """Shadow query with index-matched (BSDF_NULL) punch-through that
    does NOT consume path depth: null-capable surfaces (mask materials)
    never occlude — they attenuate by their null lobe (1-alpha) *
    transparent_color — while any opaque hit blocks. The wavefront
    analogue of occluded(ray, &isOpaque) + PathTracer::evalAttenuation
    (reference src/GoblinPathtracer.cpp:5-48,95-113). Returns (occ, tr)
    with tr (R,3). Scenes without mask materials take the plain any-hit
    path (statically, zero extra cost); max_punch bounds the number of
    stacked null surfaces traversed (reference loops unboundedly)."""
    if not getattr(meta, "has_null", False):
        return occluded(scene, meta, o, d, mint, maxt, sort=sort), jnp.ones(
            o.shape[:-1] + (3,), jnp.float32
        )
    from ..integrators.materials import gather_material
    from ..shading.bsdf import MAT_MASK

    tr = jnp.ones(o.shape[:-1] + (3,), jnp.float32)
    occ = jnp.zeros(o.shape[:-1], bool)
    done = maxt <= mint  # dead lanes start done
    cur_mint = mint
    for _ in range(max_punch):
        frag = intersect(
            scene, meta, o, d,
            jnp.where(done, BIG_T, cur_mint),
            jnp.where(done, 0.0, maxt),
            sort=sort,
        )
        hit = frag["hit"] & ~done
        is_mask = jnp.take(scene["mat_type"], frag["mat"]) == MAT_MASK
        blocked = hit & ~is_mask
        punch = hit & is_mask
        occ = occ | blocked
        mat = gather_material(scene, meta, frag)
        tr = jnp.where(
            punch[..., None],
            tr * (1.0 - mat["mask_alpha"])[..., None] * mat["c1"],
            tr,
        )
        cur_mint = jnp.where(punch, frag["t"] + frag["eps"], cur_mint)
        done = done | blocked | ~frag["hit"] \
            | (punch & jnp.all(tr <= 0.0, axis=-1))
    # lanes that punched through all max_punch layers without resolving
    # are treated as occluded — conservative darkening instead of leaking
    # light past an untested opaque occluder (the reference loop is
    # unbounded, src/GoblinPathtracer.cpp:21-48)
    occ = occ | ~done
    return occ, tr


def occluded(scene, meta: SceneMeta, o, d, mint, maxt, sort=None):
    """Any-hit shadow query over triangles + spheres. Visibility is a
    discrete decision: inputs are detached so the traversal while_loop
    never sits on the differentiation path."""
    o, d, mint, maxt = (jax.lax.stop_gradient(v) for v in (o, d, mint, maxt))
    occ = trace_rays(
        jax.lax.stop_gradient(scene), meta, o, d, mint, maxt, any_hit=True,
        sort=sort,
    ).hit
    if meta.n_spheres > 0:
        sph_id, _ = _sphere_pass(scene, o, d, mint, maxt)
        occ = occ | (sph_id >= 0)
    if meta.n_disks > 0:
        dsk_id, _ = _disk_pass(scene, o, d, mint, maxt)
        occ = occ | (dsk_id >= 0)
    return occ
