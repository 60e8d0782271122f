"""Edge-sampled visibility gradients for area-light direct lighting.

The renderer's AD path differentiates every *smooth* term (BSDFs, light
radiance, geometry-dependent shading after the detached traversal —
scene/intersect.py), but the binary visibility V in the NEE integral is
a step function: moving an occluder changes WHICH light samples are
blocked, a boundary effect invisible to AD (SURVEY.md §7 "Hard parts
#2"; the reference has no differentiation support at all).

This module implements the missing boundary term by *edge sampling*
(the direct-lighting specialization of Li et al. 2018): for a shading
point p and an area light, the blocked region B on the light plane is
bounded by the projections of the occluder's silhouette edges from p.
Differentiating the area-form NEE integral

    L(p) = \\int_light g(y) V(y) dA,   g = f(p,y) Le cos_p cos_l / r^2

with respect to an occluder parameter th moves only the boundary:

    dL/dth = - \\oint_{dB} g(y(s)) (v(s) x T(s)) . n_l ds

where y(s) is the projection of edge point e(s), v = dy/dth (chain rule
through the projection, evaluated with jvp), T = dy/ds the boundary
tangent, and n_l the light plane normal; edges are oriented so the
projected silhouette polygon is counter-clockwise about n_l, making
(T x n_l) the outward normal times |T|.

Two levels:

- `direct_light_boundary_grad`: single-triangle occluder, silhouette =
  all 3 edges, projection assumed inside the light polygon (the round-3
  validation case, kept for its tight analytic tests).
- `mesh_boundary_grad`: MESH occluders. Host-side `build_edge_adjacency`
  extracts the unique edge list with left/right face ids; at runtime the
  view-dependent silhouette (front-facing xor back-facing adjacent
  faces, plus boundary edges) is selected per shading point with dense
  masking, each silhouette edge's projection is CLIPPED against the
  convex light polygon (the projected constraint numerator is linear in
  the edge parameter s — see `_clip_interval` — so clipping is a pair of
  closed-form s-interval clamps, no Sutherland–Hodgman loop), and the
  boundary integral is accumulated over the clipped span.

Scope (documented): one occluder mesh; mutual occlusion between
multiple blockers (a silhouette edge that is itself shadowed by another
object) is not modeled. The estimator is validated against finite
differences of dense numerical integration (tests/test_edge_grad.py),
including a sweep where the silhouette crosses the light boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm


def _project_to_plane(p, e, plane_p, n_l):
    """Project e from center p onto the plane (plane_p, n_l)."""
    denom = vm.dot(e - p, n_l)
    tau = vm.dot(plane_p - p, n_l) / denom
    return p + tau[..., None] * (e - p)


def direct_light_boundary_grad(
    p, ns, albedo, light_p, n_l, Le, occ_tri, u_dir, n_samples: int = 64
):
    """Boundary term of d/dth L_direct(p) for an occluder translating
    along u_dir (th = signed distance along u_dir).

    p, ns: (3,) shading point and normal (Lambert albedo (3,)).
    light_p, n_l, Le: a point on the light plane, its normal, radiance.
    occ_tri: (3, 3) occluder triangle vertices.
    Returns (3,) dL/dth per channel.
    """
    q = jnp.asarray(occ_tri, jnp.float32)

    # orient the projected polygon CCW about n_l so (T x n_l) is outward
    y_v = _project_to_plane(
        jnp.broadcast_to(p, (3, 3)), q,
        jnp.broadcast_to(light_p, (3, 3)), jnp.broadcast_to(n_l, (3, 3)),
    )
    signed2 = vm.dot(jnp.cross(y_v[1] - y_v[0], y_v[2] - y_v[0]), n_l)
    flip = signed2 < 0.0

    def g_fn(y):
        """Integrand of the area-form NEE integral at light point y."""
        to_y = y - p
        r2 = jnp.maximum(vm.dot(to_y, to_y), 1e-12)
        w = to_y / jnp.sqrt(r2)
        cos_p = jnp.maximum(vm.dot(ns, w), 0.0)
        cos_l = jnp.maximum(vm.dot(n_l, -w), 0.0)
        return (albedo / jnp.pi) * Le * cos_p * cos_l / r2

    def edge_term(a, b):
        s = (jnp.arange(n_samples, dtype=jnp.float32) + 0.5) / n_samples

        def y_of(e):
            return _project_to_plane(p, e, light_p, n_l)

        e_pts = a[None, :] * (1.0 - s[:, None]) + b[None, :] * s[:, None]
        # dy/ds via the chain rule through the projection
        de_ds = jnp.broadcast_to(b - a, e_pts.shape)
        du = jnp.broadcast_to(jnp.asarray(u_dir, jnp.float32), e_pts.shape)
        y, T = jax.jvp(y_of, (e_pts,), (de_ds,))
        _, v = jax.jvp(y_of, (e_pts,), (du,))
        # outward-normal sweep rate: (v x T) . n_l  (CCW orientation)
        sweep = vm.dot(jnp.cross(v, T), jnp.broadcast_to(n_l, T.shape))
        g = jax.vmap(g_fn)(y)  # (S, 3)
        return -jnp.mean(sweep[:, None] * g, axis=0)  # ds integral (len 1)

    order = jnp.where(flip, jnp.asarray([0, 2, 1]), jnp.asarray([0, 1, 2]))
    qo = q[order]
    total = (
        edge_term(qo[0], qo[1])
        + edge_term(qo[1], qo[2])
        + edge_term(qo[2], qo[0])
    )
    return total


# ---------------------------------------------------------------------------
# Mesh occluders
# ---------------------------------------------------------------------------


def build_edge_adjacency(faces):
    """Host-side unique-edge extraction for a triangle mesh.

    faces: (F, 3) int vertex indices. Returns dict of numpy arrays:
      ev0, ev1 (E,) edge endpoint vertex ids (ev0 < ev1)
      ef_l, ef_r (E,) adjacent face ids (ef_r = -1 for boundary edges)
    """
    import numpy as np

    F = faces.shape[0]
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    face_of = np.repeat(np.arange(F)[None, :], 3, 0).reshape(-1)
    key = np.sort(e, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    ks = key[order]
    fs = face_of[order]
    uniq = np.ones(ks.shape[0], bool)
    uniq[1:] = (ks[1:] != ks[:-1]).any(axis=1)
    starts = np.flatnonzero(uniq)
    counts = np.diff(np.append(starts, ks.shape[0]))
    ev0 = ks[starts, 0]
    ev1 = ks[starts, 1]
    ef_l = fs[starts]
    ef_r = np.where(counts > 1, fs[np.minimum(starts + 1, ks.shape[0] - 1)],
                    -1)
    return {
        "ev0": ev0.astype(np.int32), "ev1": ev1.astype(np.int32),
        "ef_l": ef_l.astype(np.int32), "ef_r": ef_r.astype(np.int32),
    }


def _clip_interval(p, a, b, light_poly, n_l, k_plane):
    """s-interval [s0, s1] of edge e(s) = a + s(b-a) whose projection
    from p onto the light plane lies inside the convex polygon
    `light_poly` ((L, 3), counter-clockwise about n_l).

    The projected point is y(s) = p + tau(s) (e(s) - p) with
    tau = k / den(s), den(s) = dot(e(s)-p, n_l) linear in s. Each
    polygon half-plane constraint dot(y - q_i, m_i) >= 0 has a rational
    form whose NUMERATOR is linear in s (den * dot(p-q, m) + k *
    dot(e(s)-p, m)); since den keeps one sign for an occluder between p
    and the light, clipping is a closed-form clamp per half-plane."""
    L = light_poly.shape[0]
    den_a = vm.dot(a - p, n_l)
    den_b = vm.dot(b - p, n_l)
    sgn = jnp.sign(den_a + 1e-30)
    s0 = jnp.zeros(())
    s1 = jnp.ones(())
    ok = jnp.ones((), bool)
    for i in range(L):
        q = light_poly[i]
        q2 = light_poly[(i + 1) % L]
        m = jnp.cross(n_l, q2 - q)  # inward normal of the CCW polygon
        ma = vm.dot(a - p, m)
        mb = vm.dot(b - p, m)
        c0 = vm.dot(p - q, m)
        B = c0 * den_a + k_plane * ma
        A = c0 * (den_b - den_a) + k_plane * (mb - ma)
        A = A * sgn
        B = B * sgn
        # constraint A s + B >= 0 on [s0, s1]
        root = -B / jnp.where(jnp.abs(A) < 1e-20, 1e-20, A)
        s0 = jnp.where(A > 0.0, jnp.maximum(s0, root), s0)
        s1 = jnp.where(A < 0.0, jnp.minimum(s1, root), s1)
        ok = ok & jnp.where(jnp.abs(A) < 1e-20, B >= 0.0, True)
    return s0, s1, ok & (s1 > s0)


def mesh_boundary_grad(
    p, ns, albedo, light_poly, n_l, Le, verts, faces, adj, vel,
    n_samples: int = 32,
):
    """Boundary term dL/dth at shading point p for a MESH occluder whose
    vertices move with velocity field `vel` ((V, 3) = dverts/dth).

    light_poly: (L, 3) convex light polygon, CCW about n_l (y(s) inside
    => visible-light side). verts (V, 3), faces (F, 3), adj from
    build_edge_adjacency. Returns (3,) dL/dth.
    """
    verts = jnp.asarray(verts, jnp.float32)
    vel = jnp.asarray(vel, jnp.float32)
    light_poly = jnp.asarray(light_poly, jnp.float32)
    plane_p = light_poly[0]
    k_plane = vm.dot(plane_p - p, n_l)

    fv = verts[faces]  # (F, 3, 3)
    fn = jnp.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    fc = fv.mean(axis=1)
    front = vm.dot(fn, p - fc) > 0.0  # (F,)

    ev0, ev1 = jnp.asarray(adj["ev0"]), jnp.asarray(adj["ev1"])
    ef_l, ef_r = jnp.asarray(adj["ef_l"]), jnp.asarray(adj["ef_r"])
    f_l = front[ef_l]
    f_r = jnp.where(ef_r >= 0, front[jnp.maximum(ef_r, 0)], ~f_l)
    silhouette = f_l != f_r  # (E,)

    def g_fn(y):
        to_y = y - p
        r2 = jnp.maximum(vm.dot(to_y, to_y), 1e-12)
        w = to_y / jnp.sqrt(r2)
        cos_p = jnp.maximum(vm.dot(ns, w), 0.0)
        cos_l = jnp.maximum(vm.dot(n_l, -w), 0.0)
        return (albedo / jnp.pi) * Le * cos_p * cos_l / r2

    def y_of(e):
        return _project_to_plane(p, e, plane_p, n_l)

    def edge_term(a, b, va, vb, active):
        s0, s1, ok = _clip_interval(p, a, b, light_poly, n_l, k_plane)
        span = jnp.maximum(s1 - s0, 0.0)
        s = s0 + (jnp.arange(n_samples, dtype=jnp.float32) + 0.5) \
            / n_samples * span
        e_pts = a[None, :] * (1.0 - s[:, None]) + b[None, :] * s[:, None]
        de_ds = jnp.broadcast_to(b - a, e_pts.shape)
        dth = va[None, :] * (1.0 - s[:, None]) + vb[None, :] * s[:, None]
        y, T = jax.jvp(y_of, (e_pts,), (de_ds,))
        _, v = jax.jvp(y_of, (e_pts,), (dth,))
        sweep = vm.dot(jnp.cross(v, T), jnp.broadcast_to(n_l, T.shape))
        g = jax.vmap(g_fn)(y)
        use = active & ok
        return jnp.where(use, -jnp.mean(sweep[:, None] * g, axis=0)
                         * span, 0.0)

    a = verts[ev0]
    b = verts[ev1]
    va = vel[ev0]
    vb = vel[ev1]
    # orient each silhouette edge so the FRONT face is on its left when
    # the projected polygon is walked CCW about n_l: the front face's
    # winding gives the edge direction. If the left face is back-facing,
    # the right face is the front one and the edge flips.
    # For edge (v0, v1) appearing in face f as (v0 -> v1), CCW winding of
    # the SILHOUETTE about the occluder's projected outline follows the
    # front face's winding; detect whether ef_l uses the edge as v0->v1
    # and whether ef_l is the front face.
    fl = faces[ef_l]  # (E, 3)
    as_fwd = (
        ((fl[:, 0] == ev0) & (fl[:, 1] == ev1))
        | ((fl[:, 1] == ev0) & (fl[:, 2] == ev1))
        | ((fl[:, 2] == ev0) & (fl[:, 0] == ev1))
    )
    use_fwd = as_fwd == f_l  # front face traverses the edge forward
    # projected-silhouette orientation also flips with the side of the
    # light plane normal: make it empirical via the signed area test of
    # the projected front-face winding (matches the triangle-case flip)
    aa = jnp.where(use_fwd[:, None], a, b)
    bb = jnp.where(use_fwd[:, None], b, a)
    vaa = jnp.where(use_fwd[:, None], va, vb)
    vbb = jnp.where(use_fwd[:, None], vb, va)
    # CCW check: project one front face and test its signed area
    f_front = jnp.argmax(front.astype(jnp.int32))
    tri = verts[faces[f_front]]
    y_tri = jax.vmap(lambda e: y_of(e))(tri)
    ccw = vm.dot(jnp.cross(y_tri[1] - y_tri[0], y_tri[2] - y_tri[0]),
                 n_l) >= 0.0
    aa, bb = (jnp.where(ccw, aa, bb), jnp.where(ccw, bb, aa))
    vaa, vbb = (jnp.where(ccw, vaa, vbb), jnp.where(ccw, vbb, vaa))
    terms = jax.vmap(edge_term)(aa, bb, vaa, vbb, silhouette)
    return terms.sum(axis=0)
