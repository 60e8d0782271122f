"""Stochastic progressive photon mapping, wavefront form.

Re-derivation of the reference SPPM (src/GoblinSPPM.cpp) with the mutable
spatial hash grid (linked lists per cell, :197-304) replaced by a
sort-based data-parallel grid:

  per iteration
    1. ray-trace pass: one camera path per pixel — direct lighting (one
       light pick + NEE with MIS sharing the continuation ray) per
       bounce, walk continues through non-diffuse lobes, the first
       diffuse (or last) vertex is recorded as the pixel's visible point
       (:327-389)
    2. grid build: photon DEPOSITS insert (cell-hash, deposit) entries
       for all cells their +-max_r cube overlaps; entries sorted by hash
       and segmented (Teschner hash, cell = 2 * max radius, :240-276)
    3. photon pass, VP-major gather form: every visible point drains
       exactly its own cell's deposit list, accumulating Phi/Mi in its
       own lane — no scatter (same join as the reference's
       per-cell linked-list walk, :391-462)
    4. radius/flux update, alpha = 0.7: N' = N + a*M,
       R' = R*sqrt(N'/(N+M)), Tau' = (Tau + tp*Phi)(R'/R)^2 (:548-567)

  final: L = Ld/iterations + Tau/(N_emitted * pi * R^2) (:586-600)

The reference's per-pixel PermutedHalton sequences map to qmc_uniform:
prime-base radical-inverse streams over the iteration index with a
per-pixel Cranley-Patterson rotation (stateless, bit-reproducible at any
sharding), used for every camera-path dimension.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import film as film_mod
from ..core import vecmath as vm
from ..core.rng import hash_uniform
from ..core.sampling import power_heuristic
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading import bsdf as bx
from .common import DIM_BASE, pixel_samples, spp_grid
from .materials import gather_material
from .path import _area_light_Le, _em_tri_data, _env_le

ALPHA = 0.7

# low-discrepancy bases for the per-iteration camera-path dims — one
# prime per (bounce, dim) pair, like the reference PermutedHalton which
# assigns every declared sample dimension its own prime
# (src/GoblinSampler.cpp:659-748). 64 primes cover 9 bounces of 7 dims
# before reuse; reused pairs are >= 9 bounces apart and additionally
# differ by the per-bounce Cranley-Patterson rotation.
_QMC_PRIMES = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
    59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131,
    137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199,
    211, 223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281,
    283, 293, 307, 311,
)
QMC_N_DIMS = 7  # dims consumed per camera-path bounce


def qmc_table(it, max_len, n_dims=QMC_N_DIMS):
    """Radical inverses of the (traced, scalar) iteration index for every
    (bounce, dim) pair, each in its own prime base — computed once per
    pass outside the bounce scan (the base must be static; the bounce id
    inside a lax.scan is traced). Shape (max_len, n_dims)."""
    from ..core.sampling import radical_inverse

    rows = []
    for b in range(max_len):
        rows.append(jnp.stack([
            radical_inverse(
                it, _QMC_PRIMES[(b * n_dims + d) % len(_QMC_PRIMES)]
            )
            for d in range(n_dims)
        ]))
    return jnp.stack(rows)


def qmc_uniform(seed, pixel_ids, h, dim, salt=0):
    """Per-pixel low-discrepancy stream over the *iteration* axis (the
    progressive dimension SPPM converges along): `h` is the bounce's
    radical inverse from qmc_table, Cranley-Patterson rotated by a
    per-(pixel, salt, dim) hash shift. The rotation preserves each
    stream's stratification across iterations while decorrelating pixels
    and bounces — the stateless analogue of the reference's per-pixel
    digit-permuted Halton (src/GoblinSampler.cpp:659-748)."""
    shift = hash_uniform(seed, pixel_ids, jnp.int32(0x51C) + salt, 0, dim)
    return jnp.mod(h + shift, 1.0)


def _hash_cells(cx, cy, cz, size):
    h = (
        (cx.astype(jnp.uint32) * jnp.uint32(73856093))
        ^ (cy.astype(jnp.uint32) * jnp.uint32(19349663))
        ^ (cz.astype(jnp.uint32) * jnp.uint32(83492791))
    )
    return (h % jnp.uint32(size)).astype(jnp.int32)


def make_ray_pass(scene, meta, seed, max_len, n_grid):
    cam = meta.camera
    spec = cam.film
    lights = scene["lights"]
    tri_data = _em_tri_data(scene)

    @jax.jit
    def ray_pass(pixel_ids, it):
        R = pixel_ids.shape[0]
        x, y = pixel_samples(seed, pixel_ids, spec.x_res, it % (n_grid * n_grid),
                             n_grid)
        ray = cam.generate_ray(x, y)
        frag = scn.intersect(scene, meta, ray["o"], ray["d"], ray["mint"],
                             ray["maxt"])
        Ld = jnp.where(
            frag["hit"][:, None],
            _area_light_Le(scene, frag, frag["wo"]),
            _env_le(scene, meta, ray["d"]),
        )
        vp_init = {
            "p": jnp.zeros((R, 3), jnp.float32),
            "ns": jnp.zeros((R, 3), jnp.float32),
            "dpdu": jnp.zeros((R, 3), jnp.float32),
            "uv": jnp.zeros((R, 2), jnp.float32),
            "mat": jnp.zeros((R,), jnp.int32),
            "wo": jnp.zeros((R, 3), jnp.float32),
            "tp": jnp.zeros((R, 3), jnp.float32),
            "len": jnp.zeros((R,), jnp.int32),
            "valid": jnp.zeros((R,), bool),
        }

        h_tab = qmc_table(it, max_len)

        def body(state, bh):
            b, h = bh
            Ld, tp, frag, active, vp = state
            mat = gather_material(
                scene, meta, frag,
                u_mask=qmc_uniform(seed, pixel_ids, h[0], 0, salt=b),
            )
            ns, wo, p, eps = frag["ns"], frag["wo"], frag["p"], frag["eps"]
            path_len = b + 1

            # --- NEE (one light pick; shares the continuation sample for
            # the bsdf MIS side, PT-style)
            if meta.n_lights > 0:
                u_pick = qmc_uniform(seed, pixel_ids, h[1], 1, salt=b)
                lid, pick_pdf = lt.pick_light(lights, u_pick)
                u1 = qmc_uniform(seed, pixel_ids, h[2], 2, salt=b)
                u2 = qmc_uniform(seed, pixel_ids, h[3], 3, salt=b)
                ls = lt.sample_li(lights, tri_data, lid, p, eps, u1, u2)
                f_l = bx.bsdf_eval(mat, ns, wo, ls["wi"], bx.BSDF_ALL)
                consider = (
                    active & (ls["pdf"] > 0.0)
                    & jnp.any(ls["Li"] > 0.0, -1) & jnp.any(f_l > 0.0, -1)
                )
                occ = scn.occluded(scene, meta, p, ls["wi"], eps,
                                   ls["shadow_maxt"])
                vis = consider & ~occ
                pdf_b_l = bx.bsdf_pdf(mat, ns, wo, ls["wi"], bx.BSDF_ALL)
                w_l = jnp.where(ls["is_delta"], 1.0,
                                power_heuristic(1.0, ls["pdf"], 1.0, pdf_b_l))
                nee = jnp.where(
                    vis[:, None],
                    f_l * ls["Li"] * (vm.absdot(ns, ls["wi"]) * w_l
                                      / jnp.maximum(ls["pdf"], 1e-20))[:, None],
                    0.0,
                )
            else:
                lid = jnp.zeros((R,), jnp.int32)
                pick_pdf = jnp.ones((R,))
                nee = jnp.zeros((R, 3))

            # --- continuation sample (also the bsdf MIS side)
            bs = bx.bsdf_sample(
                mat, ns, frag["dpdu"], wo,
                qmc_uniform(seed, pixel_ids, h[4], 4, salt=b),
                qmc_uniform(seed, pixel_ids, h[5], 5, salt=b),
                qmc_uniform(seed, pixel_ids, h[6], 6, salt=b),
                bx.BSDF_ALL,
            )
            cont_ok = active & bs["valid"] & jnp.any(bs["f"] > 0.0, -1)
            frag2 = scn.intersect(
                scene, meta, p, bs["wi"],
                jnp.where(cont_ok, eps, scn.BIG_T),
                jnp.where(cont_ok, 3.0e37, 0.0),
            )
            if meta.n_lights > 0:
                cos_l = vm.dot(frag2["ns"], -bs["wi"])
                pdf_l_b = lt.pdf_li(lights, lid, p, bs["wi"], frag2["t"],
                                    cos_l, frag2["light"])
                w_b = jnp.where(bs["is_specular"] | bs["is_null"], 1.0,
                                power_heuristic(1.0, bs["pdf"], 1.0, pdf_l_b))
                le2 = _area_light_Le(scene, frag2, -bs["wi"])
                hit_picked = frag2["hit"] & (frag2["light"] == lid)
                nee = nee + jnp.where(
                    (cont_ok & hit_picked)[:, None],
                    bs["f"] * le2 * (vm.absdot(bs["wi"], ns) * w_b
                                     / jnp.maximum(bs["pdf"], 1e-20))[:, None],
                    0.0,
                )
                Ld = Ld + jnp.where(
                    active[:, None],
                    tp * nee / jnp.maximum(pick_pdf, 1e-20)[:, None], 0.0,
                )

            # --- stop at diffuse (record VP) or continue
            lobe = bx.lobe_of(mat["mtype"])
            is_diffuse = (lobe & bx.BSDF_DIFFUSE) != 0
            record = active & (is_diffuse | (path_len == max_len - 1))
            for k in ("p", "ns", "dpdu", "wo"):
                src = {"p": p, "ns": ns, "dpdu": frag["dpdu"], "wo": wo}[k]
                vp[k] = jnp.where(record[:, None], src, vp[k])
            vp["uv"] = jnp.where(record[:, None], frag["uv"], vp["uv"])
            vp["mat"] = jnp.where(record, frag["mat"], vp["mat"])
            vp["tp"] = jnp.where(record[:, None], tp, vp["tp"])
            vp["len"] = jnp.where(record, path_len, vp["len"])
            vp["valid"] = vp["valid"] | record

            tp2 = tp * bs["f"] * (vm.absdot(bs["wi"], ns)
                                  / jnp.maximum(bs["pdf"], 1e-20))[:, None]
            active = active & ~record & cont_ok & frag2["hit"]
            tp = jnp.where(active[:, None], tp2, tp)
            new_frag = jax.tree_util.tree_map(
                lambda a, c: jnp.where(
                    active.reshape(active.shape + (1,) * (a.ndim - 1)), c, a
                ),
                frag, frag2,
            )
            return (Ld, tp, new_frag, active, vp), None

        init = (Ld, jnp.ones((R, 3), jnp.float32), frag, frag["hit"], vp_init)
        (Ld, _, _, _, vp), _ = jax.lax.scan(
            body, init, (jnp.arange(max_len), h_tab)
        )
        return Ld, vp

    return ray_pass


def make_photon_passes(scene, meta, seed, max_len, n_pix):
    """VP-major ("gather-form") photon deposit, replacing a photon-major
    scatter form.

    The photon-major drain did, per while-loop iteration, two scatter-adds
    plus a per-iteration gather_material + texture eval. Inverting the
    join removes all three: photon DEPOSITS are
    hashed into the grid (each into the <= 8 cells its +-max_r cube
    overlaps, clamp-deduped), and every visible point drains exactly its
    own cell, accumulating Phi/Mi in its OWN lane — no scatter at all —
    with its material/BSDF inputs hoisted out of the loop. Same join,
    same estimator as the reference's per-cell linked-list walk
    (src/GoblinSPPM.cpp:391-462): M counts distance-passing deposits,
    flux is conserved, no deposit cap.

    Returns (deposit_chunk, vp_drain):
      deposit_chunk(photon_ids, it, bbox_min, inv_len, max_r)
        -> (rows (N,10) [p, wi, wgt, path_len], entry_hash (8N,) sorted,
            entry_idx (8N,))
      vp_drain(vp, radius, rows, entry_hash, entry_idx, bbox_min,
               inv_len, Phi, Mi) -> (Phi, Mi)
    """
    lights = scene["lights"]

    @jax.jit
    def deposit_chunk(photon_ids, it, bbox_min, inv_len, max_r):
        from ..splatting import _env_le_at, walk_light_paths

        em, verts = walk_light_paths(
            scene, meta, photon_ids, it, seed, max_len + 1,
            mode=bx.MODE_RADIANCE,
        )
        le_scale = lt.eval_emission(
            lights, em["lid"], em["n"], em["dir"],
            env_le=_env_le_at(scene, meta, em["dir"]),
        )
        D = verts["p"].shape[0]
        rows_list = []
        valids = []
        for d in range(D):
            path_len = d + 1
            if path_len <= 1:
                continue  # deposits only for pathLength > 1
            wgt = verts["tp"][d] * le_scale
            rows_list.append(jnp.concatenate([
                verts["p"][d],
                verts["wo_prev"][d],
                wgt,
                jnp.full(wgt.shape[:-1] + (1,), float(path_len),
                         jnp.float32),
            ], axis=-1))
            valids.append(verts["valid"][d])
        rows = jnp.concatenate(rows_list)  # (N, 10)
        valid = jnp.concatenate(valids)
        dp = rows[:, 0:3]
        lo = jnp.floor((dp - max_r - bbox_min) * inv_len).astype(jnp.int32)
        hi = jnp.floor((dp + max_r - bbox_min) * inv_len).astype(jnp.int32)
        N = rows.shape[0]
        idx = jnp.arange(N, dtype=jnp.int32)
        hashes = []
        idxs = []
        seen_cells: list = []
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    cx = jnp.minimum(lo[:, 0] + dx, hi[:, 0])
                    cy = jnp.minimum(lo[:, 1] + dy, hi[:, 1])
                    cz = jnp.minimum(lo[:, 2] + dz, hi[:, 2])
                    dup = jnp.zeros_like(cx, dtype=bool)
                    for (px, py, pz) in seen_cells:
                        dup = dup | ((cx == px) & (cy == py) & (cz == pz))
                    seen_cells.append((cx, cy, cz))
                    h = _hash_cells(cx, cy, cz, n_pix)
                    ok = valid & ~dup
                    hashes.append(jnp.where(ok, h, jnp.int32(0x7FFFFFFF)))
                    idxs.append(idx)
        entry_hash = jnp.concatenate(hashes)
        entry_idx = jnp.concatenate(idxs)
        order = jnp.argsort(entry_hash)
        return rows, entry_hash[order], entry_idx[order]

    @jax.jit
    def vp_drain(vp, radius, rows, entry_hash, entry_idx, bbox_min,
                 inv_len, Phi, Mi):
        p = vp["p"]
        E = entry_hash.shape[0]
        c = jnp.floor((p - bbox_min) * inv_len).astype(jnp.int32)
        h = _hash_cells(c[:, 0], c[:, 1], c[:, 2], n_pix)
        start = jnp.searchsorted(entry_hash, h, side="left")
        end = jnp.searchsorted(entry_hash, h, side="right")
        end = jnp.where(vp["valid"], end, start)
        # hoisted per-VP loop invariants (the old form re-evaluated the
        # material + texture stack EVERY iteration)
        mat_v = gather_material(
            scene, meta, {"mat": vp["mat"], "uv": vp["uv"], "p": p}
        )
        ns = vp["ns"]
        wo = vp["wo"]
        r2 = radius * radius
        budget = (jnp.float32(max_len) - vp["len"].astype(jnp.float32))

        def body(carry):
            k, Phi_c, Mi_c = carry
            idx = entry_idx[jnp.minimum(start + k, E - 1)]
            row = rows[idx]  # ONE fused (n_pix, 10) gather
            ok = (start + k < end)
            dp = row[:, 0:3]
            wi = row[:, 3:6]
            wgt = row[:, 6:9]
            plen = row[:, 9]
            d2 = vm.squared_length(dp - p)
            ok = ok & (d2 <= r2) & (plen <= budget)
            fs = bx.bsdf_eval(mat_v, ns, wo, wi, bx.BSDF_ALL)
            Phi_c = Phi_c + jnp.where(ok[:, None], fs * wgt, 0.0)
            Mi_c = Mi_c + ok.astype(jnp.float32)
            return k + 1, Phi_c, Mi_c

        def cond(carry):
            k = carry[0]
            return jnp.any(start + k < end) & (k < E)

        _, Phi, Mi = jax.lax.while_loop(cond, body, (jnp.int32(0), Phi, Mi))
        return Phi, Mi

    return deposit_chunk, vp_drain


@jax.jit
def vp_cell_meta(vp, radius):
    """Cell layout for an iteration: bbox over valid VPs, cell edge =
    2 * max radius (reference SpatialHashGrids::rebuild,
    src/GoblinSPPM.cpp:240-276)."""
    valid = vp["valid"]
    big = jnp.float32(3e38)
    p = vp["p"]
    pmin = jnp.min(jnp.where(valid[:, None], p, big), axis=0)
    max_r = jnp.max(jnp.where(valid, radius, 0.0))
    cell = 2.0 * jnp.maximum(max_r, 1e-12)
    return pmin - max_r, 1.0 / cell, max_r


def save_sppm_state(path, state):
    """Checkpoint the per-pixel SPPM progress (SURVEY §5: the reference
    has no checkpointing; its per-pixel PixelData is the natural resume
    point). state = dict from render_sppm(return_state=True)."""
    np.savez(path, **{k: np.asarray(v) for k, v in state.items()})


def load_sppm_state(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def render_sppm(scene, meta, chunk_size=1 << 15, iterations=None, seed=None,
                state=None, return_state=False):
    cam = meta.camera
    spec = cam.film
    if iterations is None:
        iterations = int(meta.settings.get("sample_per_pixel", 1))
    if seed is None:
        seed = int(meta.settings.get("seed", 0))
    max_len = max(2, int(meta.settings.get("max_ray_depth", 5)))
    init_radius = float(meta.settings.get("initial_radius", -1.0))

    xs_, xc, ys_, yc = spec.crop_window()
    n_pix = xc * yc
    pixel_ids = jnp.asarray(
        (np.arange(ys_, ys_ + yc)[:, None] * spec.x_res
         + np.arange(xs_, xs_ + xc)[None, :]).reshape(-1).astype(np.int32)
    )
    n_grid = spp_grid(iterations)

    from .common import jit_cache

    ray_pass, (deposit_chunk, vp_drain) = jit_cache(
        meta, ("sppm", id(scene), seed, max_len, n_grid, n_pix),
        lambda: (
            make_ray_pass(scene, meta, seed, max_len, n_grid),
            make_photon_passes(scene, meta, seed + 77, max_len, n_pix),
        ),
    )

    # per-pixel persistent state (resumable: pass back the dict a
    # return_state=True call produced, possibly reloaded from disk via
    # load_sppm_state — iterations CONTINUE from the saved it0 with the
    # same per-iteration QMC streams, so save/resume is bit-identical
    # to an uninterrupted run)
    if state is not None:
        Ld_acc = jnp.asarray(state["Ld_acc"])
        Ni = jnp.asarray(state["Ni"])
        Tau = jnp.asarray(state["Tau"])
        radius = jnp.asarray(state["radius"])
        emitted = int(state["emitted"])
        it0 = int(state["it"])
    else:
        Ld_acc = jnp.zeros((n_pix, 3), jnp.float32)
        Ni = jnp.zeros((n_pix,), jnp.float32)
        Tau = jnp.zeros((n_pix, 3), jnp.float32)
        radius = jnp.full((n_pix,), init_radius, jnp.float32)
        emitted = 0
        it0 = 0

    @jax.jit
    def update(Ni, Tau, radius, Phi, Mi, vp_tp, vp_valid):
        has = vp_valid & (Mi > 0)
        new_n = Ni + ALPHA * Mi
        new_r = radius * jnp.sqrt(new_n / jnp.maximum(Ni + Mi, 1e-12))
        ratio = jnp.where(has, (new_r / jnp.maximum(radius, 1e-20)) ** 2, 1.0)
        new_tau = (Tau + vp_tp * Phi) * ratio[:, None]
        return (
            jnp.where(has, new_n, Ni),
            jnp.where(has[:, None], new_tau, Tau),
            jnp.where(has, new_r, radius),
        )

    for it in range(it0, iterations):
        Ld_it, vp = ray_pass(pixel_ids, jnp.int32(it))
        Ld_acc = Ld_acc + Ld_it
        # initial radius heuristic when unset (reference :241-253),
        # computed on device — no host round trip
        if it == 0 and init_radius <= 0.0:

            @jax.jit
            def auto_radius(vp):
                big = jnp.float32(3e38)
                v = vp["valid"][:, None]
                lo = jnp.min(jnp.where(v, vp["p"], big), axis=0)
                hi = jnp.max(jnp.where(v, vp["p"], -big), axis=0)
                r0 = ((hi - lo).sum() / 3.0) / ((xc + yc) / 2.0) * 2.0
                r0 = jnp.where(
                    jnp.any(vp["valid"]) & (r0 > 0.0), r0, 1e-5
                )
                return jnp.full((n_pix,), r0, jnp.float32)

            radius = auto_radius(vp)
        bbox_min, inv_len, max_r = vp_cell_meta(vp, radius)
        Phi = jnp.zeros((n_pix, 3), jnp.float32)
        Mi = jnp.zeros((n_pix,), jnp.float32)
        # full uniform chunks (keeps one compiled shape); emitted counts
        # the actual number traced
        cs = min(chunk_size, n_pix)
        n_chunks = (n_pix + cs - 1) // cs
        for c in range(n_chunks):
            ids = jnp.arange(emitted + c * cs, emitted + (c + 1) * cs,
                             dtype=jnp.int32)
            rows, e_hash, e_idx = deposit_chunk(
                ids, jnp.int32(it), bbox_min, inv_len, max_r
            )
            Phi, Mi = vp_drain(vp, radius, rows, e_hash, e_idx,
                               bbox_min, inv_len, Phi, Mi)
        emitted += n_chunks * cs
        Ni, Tau, radius = update(Ni, Tau, radius, Phi, Mi, vp["tp"],
                                 vp["valid"])

    L = Ld_acc / max(iterations, 1) + Tau / jnp.maximum(
        emitted * np.pi * radius[:, None] ** 2, 1e-20
    )
    # splat with the film filter at pixel centers (reference final tile)
    color, weight = film_mod.new_film(spec)
    px = (pixel_ids % spec.x_res).astype(jnp.float32) + 0.5
    py = (pixel_ids // spec.x_res).astype(jnp.float32) + 0.5
    color, weight = film_mod.splat(spec, color, weight, px, py, L)
    img = film_mod.to_image(color, weight, normalize=True)
    if return_state:
        return img, {
            "Ld_acc": Ld_acc, "Ni": Ni, "Tau": Tau, "radius": radius,
            "emitted": emitted, "it": iterations,
        }
    return img
