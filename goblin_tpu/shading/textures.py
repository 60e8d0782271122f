"""Texture programs: baked, branch-free texture evaluation.

The reference's Texture class tree (src/GoblinTexture.{h,cpp}) — constant /
checkerboard / scale / image with uv or spherical mappings — becomes a
static per-scene *program*: textures are topologically sorted at bake time
and evaluated in order as dense vectorized ops over the whole wavefront,
each lane then gathers its material's texture value by id. With the
handful of textures a scene declares this avoids per-lane dispatch, and it
keeps control flow static for XLA.

Image data lives in one flat f32 atlas; each image texture stores
(offset, height, width, channels). Filtering: nearest, bilinear,
trilinear over a baked mip pyramid, and an approximated EWA (gaussian
taps marched along the ellipse's major axis) — reference
src/GoblinTexture.cpp:131-271.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..core import vecmath as vm

TEX_CONSTANT = 0
TEX_CHECKERBOARD = 1
TEX_SCALE = 2
TEX_IMAGE = 3

MAP_UV = 0
MAP_SPHERICAL = 1

ADDRESS_REPEAT = 0
ADDRESS_CLAMP = 1
ADDRESS_BORDER = 2

FILTER_NEAREST = 0
FILTER_BILINEAR = 1
FILTER_TRILINEAR = 2
FILTER_EWA = 3

EWA_TAPS = 8  # fixed taps along the footprint's major axis (EWA approx)


def _build_pyramid(img: np.ndarray):
    """Resize to pow2 (bilinear) then 2x2 box-average down to 1x1 — a
    simpler analogue of the reference's gaussian resize + pyramid
    (src/GoblinTexture.cpp:39-128, 524-598). Returns list of (H,W,3)."""

    def pow2(n):
        p = 1
        while p < n:
            p *= 2
        return p

    h, w = img.shape[:2]
    H, W = pow2(h), pow2(w)
    if (H, W) != (h, w):
        ys = (np.arange(H) + 0.5) * h / H - 0.5
        xs = (np.arange(W) + 0.5) * w / W - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = (ys - y0).clip(0, 1)[:, None, None]
        fx = (xs - x0).clip(0, 1)[None, :, None]
        img = (
            img[y0][:, x0] * (1 - fy) * (1 - fx)
            + img[y0][:, x1] * (1 - fy) * fx
            + img[y1][:, x0] * fy * (1 - fx)
            + img[y1][:, x1] * fy * fx
        )
    levels = [img.astype(np.float32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        cur = levels[-1]
        ch, cw = cur.shape[:2]
        nh, nw = max(1, ch // 2), max(1, cw // 2)
        cur = cur[: nh * 2, : nw * 2] if ch > 1 and cw > 1 else cur
        if ch > 1 and cw > 1:
            nxt = cur.reshape(nh, 2, nw, 2, 3).mean(axis=(1, 3))
        elif ch > 1:
            nxt = cur[: nh * 2].reshape(nh, 2, cw, 3).mean(axis=1)
        else:
            nxt = cur[:, : nw * 2].reshape(ch, nw, 2, 3).mean(axis=2)
        levels.append(nxt.astype(np.float32))
    return levels


@dataclass
class TexSpec:
    """Host-side texture description (one node of the program)."""

    kind: int = TEX_CONSTANT
    value: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    # checkerboard / scale children (indices into the same spec list)
    child0: int = -1
    child1: int = -1
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    # uv mapping: uv' = uv * map_scale + map_offset
    map_scale: tuple = (1.0, 1.0)
    map_offset: tuple = (0.0, 0.0)
    # image
    image: np.ndarray | None = None  # (H, W, C) float32
    address: int = ADDRESS_REPEAT
    filter: int = FILTER_NEAREST
    gamma: float = 1.0
    # checkerboard filtering flag (reference box-filtered antialiasing)
    checker_filter: bool = False
    # EWA anisotropy clamp (reference maxAnisotropy, default 10)
    max_anisotropy: float = 10.0
    # mapping kind; spherical uses world_to_tex on the hit position
    mapping: int = MAP_UV
    world_to_tex: np.ndarray | None = None  # (4,4), spherical mapping only


class TextureSystem:
    """Bakes a list of TexSpec into device arrays + an eval program."""

    def __init__(self, specs: list[TexSpec]):
        self.specs = specs
        self.order = self._topo_order()
        # per-spec constant table: TEX_CONSTANT value / TEX_SCALE factor.
        # Lives in the scene pytree (scene["tex_const"]) so gradients flow
        # to material constants (Kd etc.) — the differentiable-parameter
        # analogue of the reference's ConstantTexture values.
        def _const_row(s):
            v = np.asarray(
                s.scale if s.kind == TEX_SCALE else s.value, np.float32
            ).reshape(-1)
            return np.broadcast_to(v[:3] if v.size >= 3 else v[:1], (3,))

        self.const = jnp.asarray(
            np.stack([_const_row(s) for s in specs]).astype(np.float32)
            if specs else np.zeros((0, 3), np.float32)
        )
        # build atlas
        chunks = []
        offset = 0
        self.image_info = {}
        self.mip_info = {}  # spec id -> (offsets, hs, ws) np arrays per level
        for i, s in enumerate(specs):
            if s.kind == TEX_IMAGE and s.image is not None:
                img = np.asarray(s.image, dtype=np.float32)
                if s.gamma != 1.0:
                    img = np.power(np.maximum(img, 0.0), s.gamma)
                h, w = img.shape[:2]
                c = img.shape[2] if img.ndim == 3 else 1
                img = img.reshape(h, w, c)
                if c < 3:
                    img = np.repeat(img[:, :, :1], 3, axis=2)
                img = img[:, :, :3]
                self.image_info[i] = (offset, h, w)
                if s.filter >= FILTER_TRILINEAR:
                    levels = _build_pyramid(img)
                    offs, hs, ws = [], [], []
                    for lv in levels:
                        lh, lw = lv.shape[:2]
                        offs.append(offset)
                        hs.append(lh)
                        ws.append(lw)
                        chunks.append(lv.reshape(-1))
                        offset += lh * lw * 3
                    self.image_info[i] = (offs[0], hs[0], ws[0])
                    self.mip_info[i] = (
                        np.asarray(offs, np.int32),
                        np.asarray(hs, np.int32),
                        np.asarray(ws, np.int32),
                    )
                else:
                    chunks.append(img.reshape(-1))
                    offset += h * w * 3
        self.atlas = (
            jnp.asarray(np.concatenate(chunks))
            if chunks
            else jnp.zeros((3,), jnp.float32)
        )

    def _topo_order(self):
        order, seen = [], set()

        def visit(i):
            if i < 0 or i in seen:
                return
            s = self.specs[i]
            visit(s.child0)
            visit(s.child1)
            seen.add(i)
            order.append(i)

        for i in range(len(self.specs)):
            visit(i)
        return order

    # -- evaluation --------------------------------------------------------

    def _bilinear(self, s, atlas, off, h, w, u, v):
        """Bilinear fetch; off/h/w may be python ints or per-lane arrays
        (the trilinear path gathers them per-lane from the mip tables)."""

        def addr(x, n):
            if s.address == ADDRESS_REPEAT:
                return jnp.mod(x, n)
            return jnp.clip(x, 0, n - 1)

        fx = u * w - 0.5
        fy = v * h - 0.5
        x0 = jnp.floor(fx).astype(jnp.int32)
        y0 = jnp.floor(fy).astype(jnp.int32)
        tx = fx - x0
        ty = fy - y0
        out = 0.0
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                if s.address == ADDRESS_BORDER:
                    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                else:
                    inside = None
                xi, yi = addr(xi, w), addr(yi, h)
                base = off + (yi * w + xi) * 3
                rgb = jnp.stack(
                    [jnp.take(atlas, base + k, mode="clip") for k in range(3)],
                    axis=-1,
                )
                if inside is not None:
                    rgb = jnp.where(inside[..., None], rgb, 0.0)
                wgt = (jnp.where(dx, tx, 1 - tx) * jnp.where(dy, ty, 1 - ty))[
                    ..., None
                ]
                out = out + wgt * rgb
        return out

    def _mip_bilinear(self, s, spec_id, atlas, lvl_i, u, v):
        offs, hs, ws = self.mip_info[spec_id]
        off = jnp.take(jnp.asarray(offs), lvl_i)
        h = jnp.take(jnp.asarray(hs), lvl_i)
        w = jnp.take(jnp.asarray(ws), lvl_i)
        return self._bilinear(s, atlas, off, h, w, u, v)

    def _eval_image(self, spec_id, uv, atlas=None, duv=None, duv4=None):
        s = self.specs[spec_id]
        if atlas is None:
            atlas = self.atlas
        off, h, w = self.image_info[spec_id]
        # uv arrives pre-mapped by _spec_uv (scale/offset or spherical)
        u = uv[..., 0]
        v = uv[..., 1]

        if s.filter == FILTER_NEAREST:
            def addr(x, n):
                if s.address == ADDRESS_REPEAT:
                    return jnp.mod(x, n)
                return jnp.clip(x, 0, n - 1)

            xi = jnp.floor(u * w).astype(jnp.int32)
            yi = jnp.floor(v * h).astype(jnp.int32)
            inside = (
                (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                if s.address == ADDRESS_BORDER
                else None
            )
            xi, yi = addr(xi, w), addr(yi, h)
            base = off + (yi * w + xi) * 3
            rgb = jnp.stack(
                [jnp.take(atlas, base + k, mode="clip") for k in range(3)],
                axis=-1,
            )
            if inside is not None:
                rgb = jnp.where(inside[..., None], rgb, 0.0)
            return rgb

        if s.filter < FILTER_TRILINEAR or spec_id not in self.mip_info \
                or duv is None:
            return self._bilinear(s, atlas, off, h, w, u, v)

        # --- MIPMap paths (reference src/GoblinTexture.cpp:131-271)
        n_levels = len(self.mip_info[spec_id][0])
        su, sv = abs(s.map_scale[0]), abs(s.map_scale[1])
        wu = jnp.abs(duv[..., 0]) * su * w
        wv = jnp.abs(duv[..., 1]) * sv * h

        if s.filter == FILTER_EWA and duv4 is not None:
            # True-ellipse EWA with static shapes: the anisotropy-clamped
            # minor axis picks the mip level (reference lookup,
            # GoblinTexture.cpp:158-193), then a fixed NU x NV quadrature
            # lattice over the ellipse in its own (major, minor) frame
            # accumulates bilinear taps weighted by the reference's
            # gaussian profile exp(-2 r^2) - exp(-2) (initEWALut,
            # :262-271). This integrates the full ellipse AREA — the
            # static-shape equivalent of the reference's per-texel
            # inclusion scan (:195-259), whose data-dependent bbox loop
            # cannot be expressed with fixed shapes.
            axu = duv4[..., 0] * su
            axv = duv4[..., 1] * sv
            ayu = duv4[..., 2] * su
            ayv = duv4[..., 3] * sv
            lx = jnp.sqrt((axu * w) ** 2 + (axv * h) ** 2)
            ly = jnp.sqrt((ayu * w) ** 2 + (ayv * h) ** 2)
            x_major = lx >= ly
            major = jnp.maximum(lx, ly)
            minor = jnp.minimum(lx, ly)
            maj_u = jnp.where(x_major, axu, ayu)
            maj_v = jnp.where(x_major, axv, ayv)
            min_u = jnp.where(x_major, ayu, axu)
            min_v = jnp.where(x_major, ayv, axv)
            # anisotropy clamp: widen the minor axis so major/minor <=
            # maxAnisotropy (reference :166-171)
            max_a = float(getattr(s, "max_anisotropy", 10.0)) or 10.0
            widen = jnp.maximum(1.0, major / jnp.maximum(
                minor * max_a, 1e-12))
            minor = minor * widen
            min_u = min_u * widen
            min_v = min_v * widen
            lvl = jnp.log2(jnp.clip(minor, 1.0, None))
            lvl = jnp.clip(lvl, 0.0, n_levels - 1)
            l0 = lvl.astype(jnp.int32)
            l1 = jnp.minimum(l0 + 1, n_levels - 1)
            f = (lvl - l0)[..., None]
            NU, NV = EWA_TAPS, 3
            out = 0.0
            wsum = 0.0
            for i in range(NU):
                a = (i + 0.5) / NU - 0.5
                for j in range(NV):
                    b = (j + 0.5) / NV - 0.5
                    r2 = (2.0 * a) ** 2 + (2.0 * b) ** 2
                    gw = float(np.exp(-2.0 * r2) - np.exp(-2.0))
                    if gw <= 0.0:
                        continue  # outside the unit ellipse
                    uq = u + a * maj_u + b * min_u
                    vq = v + a * maj_v + b * min_v
                    tap = (1.0 - f) * self._mip_bilinear(
                        s, spec_id, atlas, l0, uq, vq
                    ) + f * self._mip_bilinear(s, spec_id, atlas, l1,
                                               uq, vq)
                    out = out + gw * tap
                    wsum += gw
            return out / wsum

        # trilinear: level from the max footprint extent, lerp two levels
        width = jnp.maximum(jnp.maximum(wu, wv), 1e-6)
        lvl = jnp.clip(jnp.log2(jnp.clip(width, 1.0, None)), 0.0, n_levels - 1)
        l0 = lvl.astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, n_levels - 1)
        f = (lvl - l0)[..., None]
        v0 = self._mip_bilinear(s, spec_id, atlas, l0, u, v)
        v1 = self._mip_bilinear(s, spec_id, atlas, l1, u, v)
        return (1.0 - f) * v0 + f * v1

    def _spec_uv(self, s, uv, p):
        """Per-spec texture coordinates: uv mapping (scale+offset) or
        spherical mapping of the world position (reference
        SphericalMapping, src/GoblinTexture.cpp:293-307)."""
        if s.mapping == MAP_SPHERICAL and p is not None:
            m = np.asarray(s.world_to_tex, np.float32)
            q = vm.mat3_apply(jnp.asarray(m[:3, :3]), p) + m[:3, 3]
            ln = jnp.sqrt(jnp.maximum(jnp.sum(q * q, axis=-1), 1e-30))
            vec = q / ln[..., None]
            theta = jnp.arccos(jnp.clip(vec[..., 2], -1.0, 1.0))
            phi = jnp.arctan2(vec[..., 1], vec[..., 0])
            phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
            return jnp.stack(
                [phi / (2 * jnp.pi), theta / jnp.pi], axis=-1
            )
        return jnp.stack(
            [
                uv[..., 0] * s.map_scale[0] + s.map_offset[0],
                uv[..., 1] * s.map_scale[1] + s.map_offset[1],
            ],
            axis=-1,
        )

    def eval_all(self, uv, atlas=None, const=None, p=None, duv=None,
                 duv4=None):
        """Evaluate every texture at uv (..., 2) -> (X, ..., 3) stack.

        atlas/const: scene-pytree arrays (scene["tex_atlas"] /
        scene["tex_const"]) so texture data sits on the differentiation
        path; defaults to the baked copies. p: world positions for
        spherical mappings. duv: optional (..., 2) uv filter footprint for
        box-filtered checkerboards (reference integrateChecker,
        src/GoblinTexture.cpp:371-416).
        """
        if const is None:
            const = self.const
        n = len(self.specs)
        vals: list = [None] * n
        for i in self.order:
            s = self.specs[i]
            if s.kind == TEX_CONSTANT:
                v = jnp.broadcast_to(const[i], uv.shape[:-1] + (3,))
            elif s.kind == TEX_CHECKERBOARD:
                suv = self._spec_uv(s, uv, p)
                u_, v_ = suv[..., 0], suv[..., 1]
                c0 = vals[s.child0] if s.child0 >= 0 else jnp.ones_like(uv[..., :1])
                c1 = vals[s.child1] if s.child1 >= 0 else jnp.zeros_like(uv[..., :1])
                if s.checker_filter and duv is not None:
                    # analytic box filter: fraction of the [u-w,u+w]x[v-w,v+w]
                    # footprint landing on texture1 (checker "even" squares)
                    wu = jnp.maximum(
                        jnp.abs(duv[..., 0]) * abs(s.map_scale[0]), 1e-8
                    )
                    wv = jnp.maximum(
                        jnp.abs(duv[..., 1]) * abs(s.map_scale[1]), 1e-8
                    )

                    def stair(x):
                        # integral of the 1-period square wave indicator of
                        # "even cell" from 0 to x
                        per = jnp.floor(x / 2.0)
                        r = x - 2.0 * per
                        return per + jnp.minimum(r, 1.0)

                    def frac_even(c, w):
                        return (stair(c + w) - stair(c - w)) / (2.0 * w)

                    fe_u = frac_even(u_, wu)
                    fe_v = frac_even(v_, wv)
                    # even cell <=> (floor(u)+floor(v)) even: prob both even
                    # axes agree
                    w1 = fe_u * fe_v + (1.0 - fe_u) * (1.0 - fe_v)
                    v = w1[..., None] * c0 + (1.0 - w1[..., None]) * c1
                else:
                    even = (
                        jnp.floor(u_).astype(jnp.int32)
                        + jnp.floor(v_).astype(jnp.int32)
                    ) % 2 == 0
                    v = jnp.where(even[..., None], c0, c1)
            elif s.kind == TEX_SCALE:
                base = vals[s.child0]
                v = base * const[i]
            elif s.kind == TEX_IMAGE:
                v = self._eval_image(
                    i, self._spec_uv(s, uv, p), atlas, duv=duv, duv4=duv4
                )
            else:
                raise ValueError(s.kind)
            vals[i] = v
        stacked = jnp.stack(
            [vals[i] if vals[i] is not None else jnp.zeros(uv.shape[:-1] + (3,))
             for i in range(n)],
            axis=0,
        )
        return stacked

    def gather(self, stacked, tex_ids):
        """Per-lane texture value: stacked (X, R, 3), tex_ids (R,) -> (R, 3)."""
        return jnp.take_along_axis(
            stacked, tex_ids[None, :, None].astype(jnp.int32), axis=0
        )[0]
