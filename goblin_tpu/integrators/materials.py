"""Per-lane material resolution: gather material rows + evaluate textures.

Bridges the baked scene tables to the BSDF module's per-lane `mat` dict.
Mask materials are flattened here: the lane carries the *inner* material's
parameters plus (alpha, transparent_color) for the null lobe — the
wavefront equivalent of MaskMaterial wrapping
(reference src/GoblinMaterial.cpp:747-811).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..shading.bsdf import MAT_MASK

# below this stack size a masked select-sum (dense elementwise ops over
# every texture) replaces the per-lane take_along_axis gather
_SELECT_SUM_MAX = 16


def _pick(stack, ids):
    """stack (X, R, C) selected per-lane by ids (R,) — select-sum for
    small X, gather otherwise."""
    X = stack.shape[0]
    if X <= _SELECT_SUM_MAX:
        out = jnp.zeros_like(stack[0])
        for x in range(X):
            out = out + jnp.where((ids == x)[:, None], stack[x], 0.0)
        return out
    return jnp.take_along_axis(
        stack, ids[None, :, None].astype(jnp.int32), axis=0
    )[0]


def gather_material(scene, meta, frag, u_mask=None):
    """Per-lane material parameters. The per-material scalar fields come
    from ONE fused row gather of scene["mat_rows"] (ints bitcast through
    f32) instead of ~10 separate jnp.take calls."""
    mid = frag["mat"]

    def bits(col):
        return jax.lax.bitcast_convert_type(col, jnp.int32)

    rows_mid = jnp.take(scene["mat_rows"], mid, axis=0)  # (R, 8)
    mtype_raw = bits(rows_mid[:, 0])
    is_masked = mtype_raw == MAT_MASK
    inner = bits(rows_mid[:, 7])
    eff = jnp.where(is_masked, jnp.maximum(inner, 0), mid)
    rows_eff = jnp.take(scene["mat_rows"], eff, axis=0)

    tex_stack = meta.texture_system.eval_all(
        frag["uv"], atlas=scene.get("tex_atlas"), const=scene.get("tex_const"),
        p=frag.get("p"), duv=frag.get("duv"), duv4=frag.get("duv4"),
    )  # (X, R, 3)
    ftex_stack = meta.float_texture_system.eval_all(
        frag["uv"], atlas=scene.get("ftex_atlas"),
        const=scene.get("ftex_const"), p=frag.get("p"), duv=frag.get("duv"),
        duv4=frag.get("duv4"),
    )

    def gc(ids):
        return _pick(tex_stack, ids)

    def gf(ids):
        return _pick(ftex_stack, ids)[..., 0]

    mat = {
        # static tuple of kinds present in the scene — bsdf dispatch
        # prunes absent-material branches at trace time (bsdf._need)
        "kinds": tuple(getattr(meta, "material_kinds", ()) or ()) or None,
        "mtype": bits(rows_eff[:, 0]),
        "c0": gc(bits(rows_eff[:, 1])),
        "c1": jnp.where(
            is_masked[..., None],
            gc(bits(rows_mid[:, 2])),  # transparent_color
            gc(bits(rows_eff[:, 2])),
        ),
        "f0": gf(bits(rows_eff[:, 3])),
        "eta": rows_eff[:, 5],
        "k": rows_eff[:, 6],
        "is_masked": is_masked,
        "mask_alpha": gf(bits(rows_mid[:, 4])),
    }
    if u_mask is not None:
        mat["mask_u"] = u_mask
    else:
        mat["mask_u"] = jnp.zeros_like(mat["mask_alpha"])
    return mat
