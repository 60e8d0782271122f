"""Scene bake: host-side scene graph -> flat device-resident SoA arrays.

This is the device-side replacement for the reference's pointer-based scene
graph (Scene/Primitive/Model/InstancedPrimitive, src/GoblinScene.cpp,
GoblinPrimitive.cpp, GoblinModel.cpp): instancing is *flattened at bake
time* — triangles are transformed to world space (normals by
inverse-transpose) and ONE global BVH is built over the whole soup,
replacing the reference's two-level per-model BVHs + per-ray inverse
transforms. Materials/lights become type-id + parameter tables; the
polymorphic Texture tree becomes a static texture program.

Outputs:
- scene:  dict of jnp arrays (a pytree — safe to pass through jit/pjit)
- meta:   SceneMeta with static python config (closed over by jitted code)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..accel.bvh import build_bvh
from ..camera.camera import CameraSpec
from ..lights.lights import LIGHT_AREA, LightsBuild, bake_lights
from ..shading.bsdf import (
    MAT_BLINN,
    MAT_LAMBERT,
    MAT_MASK,
    MAT_MIRROR,
    MAT_SUBSURFACE,
    MAT_TRANSPARENT,
)
from ..shading.bssrdf import fresnel_a as _fresnel_a
from ..shading.textures import TexSpec, TextureSystem


@dataclass
class MatSpec:
    """Host-side material description."""

    kind: int = MAT_LAMBERT
    tex_c0: int = 0  # Kd / Kg / Kr (color texture id)
    tex_c1: int = 0  # Kt / transparent_color
    tex_f0: int = 0  # exponent (float texture id)
    tex_f1: int = 0  # alpha
    eta: float = 1.5
    k: float = -1.0
    inner: int = -1  # mask: wrapped material row
    # subsurface extras (absorb / scatter_prime and g) for BSSRDF
    absorb: tuple = (0.0, 0.0, 0.0)
    scatter_prime: tuple = (0.0, 0.0, 0.0)
    g: float = 0.0
    bump_tex: int = -1
    normal_tex: int = -1


@dataclass
class InstanceRecord:
    geometry: object  # TriangleMesh | ("sphere", r) | ("disk", r)
    material: int  # material row
    to_world: np.ndarray  # (4,4)
    area_light: int = -1  # light row or -1
    is_camera_lens: bool = False


@dataclass
class SceneMeta:
    camera: CameraSpec = None
    settings: dict = field(default_factory=dict)
    volume: object = None  # VolumeSpec or None
    n_tris: int = 0
    n_nodes: int = 0
    n_materials: int = 0
    n_lights: int = 0
    n_spheres: int = 0
    n_disks: int = 0
    has_lens: bool = False  # a camera-lens disk is in the scene
    texture_system: TextureSystem = None
    float_texture_system: TextureSystem = None
    max_leaf: int = 2
    has_perturb: bool = False  # any material carries a bump/normal map
    has_bssrdf: bool = False  # any subsurface material in the scene
    has_null: bool = False  # any mask (BSDF_NULL-capable) material
    has_env: bool = False
    env_light_id: int = -1
    # per-light NEE sample counts (reference Light::getSamplesNum, used
    # by Whitted's multiSampleLd — GoblinRenderer.cpp:474-500)
    light_sample_nums: tuple = ()
    # every scene light is a delta emitter (point/directional/spot) and
    # there is no env: a BSDF ray can never hit a light, so the LAST
    # bounce's continuation trace has zero contribution (PT skips it)
    all_delta_lights: bool = False
    # material kinds present in the scene (Whitted prunes its static
    # specular ray tree with this)
    material_kinds: tuple = ()
    output_path: str = "goblin.exr"
    # ray-trace backend (see default_trace_backend): "kernel" = the GPU
    # trace kernel (ops/trace_kernel), "interpret" = the same kernel in
    # the Pallas interpreter, "jnp" = lockstep skip-link traversal
    # (accel/traverse, the reference)
    trace_backend: str = "jnp"
    trace_compact: bool = False  # stable alive-partition before trace
    trace_sort: bool = False  # morton-sort wavefronts before the trace
    # reorder bounce>=2 continuation wavefronts by a global stable
    # (dead, octant, dominant-axis) sort before the trace
    trace_sort_bounce: bool = False
    world_bounds: tuple = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))


TRACE_BACKENDS = ("kernel", "interpret", "jnp")


def default_trace_backend() -> str:
    """The trace kernel on a GPU, the jnp reference elsewhere.
    GOBLIN_TRACE=kernel|jnp overrides; asking for "kernel" off a GPU fails
    at trace time rather than falling back. "interpret" (the kernel in the
    Pallas interpreter) is for tests, through bake(trace_backend=...)."""
    import os

    env = os.environ.get("GOBLIN_TRACE")
    if env:
        if env not in ("kernel", "jnp"):
            raise ValueError(
                f"GOBLIN_TRACE={env!r}: expected 'kernel' or 'jnp'"
            )
        return env
    import jax

    return "kernel" if jax.default_backend() == "gpu" else "jnp"


def _pack_mat_rows(materials) -> np.ndarray:
    """(M, 8) f32 rows: [mtype, tex_c0, tex_c1, tex_f0, tex_f1, eta, k,
    inner], int columns bitcast (bit-preserving) through f32 so the whole
    material resolves with one row gather."""
    M = len(materials)
    rows = np.zeros((M, 8), np.float32)
    iview = rows.view(np.int32)
    for i, m in enumerate(materials):
        iview[i, 0] = m.kind
        iview[i, 1] = m.tex_c0
        iview[i, 2] = m.tex_c1
        iview[i, 3] = m.tex_f0
        iview[i, 4] = m.tex_f1
        rows[i, 5] = m.eta
        rows[i, 6] = m.k
        iview[i, 7] = m.inner
    return rows


def _transform_mesh(mesh, m):
    """Apply 4x4 to a TriangleMesh -> (v (V,3), n (V,3)|None, uv)."""
    v = mesh.positions @ m[:3, :3].T + m[:3, 3]
    n = None
    if mesh.normals is not None:
        inv_t = np.linalg.inv(m[:3, :3]).T
        n = mesh.normals @ inv_t.T
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(ln, 1e-20)
    return v.astype(np.float32), (None if n is None else n.astype(np.float32)), mesh.uvs


class SceneBuilder:
    """Accumulates world-space primitives then bakes to device arrays."""

    def __init__(self):
        self.instances: list[InstanceRecord] = []
        self.materials: list[MatSpec] = [MatSpec()]  # row 0: magenta-ish default
        self.color_textures: list[TexSpec] = [
            TexSpec(value=np.array([1.0, 0.0, 1.0], np.float32))  # error magenta
        ]
        self.float_textures: list[TexSpec] = [
            TexSpec(value=np.array([0.5, 0.5, 0.5], np.float32))
        ]
        self.lights = LightsBuild()
        self.camera: CameraSpec | None = None
        self.volume = None  # VolumeSpec
        self.vol_grid = None  # numpy density grid (heterogeneous)
        self.settings: dict = {}
        self.output_path = "goblin.exr"
        self.env_light_id = -1
        self.env_image = None
        self.env_filter = np.ones(3, np.float32)
        self.env_orientation = np.array([1.0, 0, 0, 0], np.float32)

    # -- registration helpers ---------------------------------------------

    def add_color_texture(self, spec: TexSpec) -> int:
        self.color_textures.append(spec)
        return len(self.color_textures) - 1

    def add_float_texture(self, spec: TexSpec) -> int:
        self.float_textures.append(spec)
        return len(self.float_textures) - 1

    def add_material(self, spec: MatSpec) -> int:
        self.materials.append(spec)
        return len(self.materials) - 1

    def add_instance(self, rec: InstanceRecord):
        self.instances.append(rec)

    # -- bake --------------------------------------------------------------

    def bake(self, max_leaf: int | None = None,
             trace_backend: str | None = None):
        import os

        if trace_backend is None:
            trace_backend = default_trace_backend()
        elif trace_backend not in TRACE_BACKENDS:
            raise ValueError(f"trace_backend {trace_backend!r}: expected "
                             f"one of {TRACE_BACKENDS}")
        if max_leaf is None:
            # both traversals unroll max_leaf triangle tests per leaf
            # step; 2 beat 4 on the H100 in both bench passes
            max_leaf = int(os.environ.get("GOBLIN_MAX_LEAF", 2))
        trace_compact = os.environ.get("GOBLIN_COMPACT", "0") == "1"
        tri_v = [np.zeros((0, 3, 3), np.float32)]
        tri_n = [np.zeros((0, 3, 3), np.float32)]
        tri_uv = [np.zeros((0, 3, 2), np.float32)]
        tri_mat = [np.zeros(0, np.int32)]
        tri_light = [np.zeros(0, np.int32)]
        spheres = []  # (center, radius, mat, light)

        disks = []  # (center, n, u_dir, radius, mat, light, is_lens)

        for rec in self.instances:
            g = rec.geometry
            if isinstance(g, tuple) and g[0] == "sphere":
                m = rec.to_world
                center = m[:3, 3].copy()
                s = np.linalg.norm(m[:3, 0])
                spheres.append((center, float(g[1]) * float(s), rec.material,
                                rec.area_light))
                continue
            if isinstance(g, tuple) and g[0] == "disk" and rec.area_light < 0:
                # analytic z=0-plane disk (reference GoblinDisk.cpp:12-56)
                # — exact silhouette; used for plain disks and the
                # camera-lens primitive. Disks BACKING AREA LIGHTS keep
                # the triangle-fan path below so the emissive-triangle
                # sampling machinery applies unchanged (documented
                # tessellation approximation).
                m = rec.to_world
                center = m[:3, 3].astype(np.float32)
                n = np.linalg.inv(m[:3, :3]).T @ np.float32([0, 0, 1])
                n = (n / max(np.linalg.norm(n), 1e-20)).astype(np.float32)
                u_dir = m[:3, :3] @ np.float32([1, 0, 0])
                u_dir = u_dir - n * float(u_dir @ n)
                u_dir = (u_dir / max(np.linalg.norm(u_dir), 1e-20)).astype(
                    np.float32
                )
                s = np.linalg.norm(m[:3, 0])
                disks.append((center, n, u_dir, float(g[1]) * float(s),
                              rec.material, rec.area_light,
                              rec.is_camera_lens))
                continue
            if isinstance(g, tuple) and g[0] == "disk":
                # tessellate area-light disks into a triangle fan
                # (64 wedges) so they enter the emissive-triangle tables
                r = float(g[1])
                k = 64
                ang = np.linspace(0, 2 * np.pi, k + 1)
                pts = np.stack(
                    [r * np.cos(ang), r * np.sin(ang), np.zeros(k + 1)], axis=-1
                ).astype(np.float32)
                v = np.zeros((k, 3, 3), np.float32)
                v[:, 1] = pts[:-1]
                v[:, 2] = pts[1:]
                m = rec.to_world
                v = v @ m[:3, :3].T + m[:3, 3]
                n = np.linalg.inv(m[:3, :3]).T @ np.array([0, 0, 1.0], np.float32)
                n = n / np.linalg.norm(n)
                tri_v.append(v.astype(np.float32))
                tri_n.append(np.broadcast_to(n, (k, 3, 3)).astype(np.float32))
                tri_uv.append(np.zeros((k, 3, 2), np.float32))
                tri_mat.append(np.full(k, rec.material, np.int32))
                tri_light.append(np.full(k, rec.area_light, np.int32))
                continue
            # mesh
            v, n, uv = _transform_mesh(g, rec.to_world)
            f = g.faces
            fv = v[f]  # (F, 3, 3)
            if n is not None:
                fn = n[f]
            else:
                e1 = fv[:, 1] - fv[:, 0]
                e2 = fv[:, 2] - fv[:, 0]
                gn = np.cross(e1, e2)
                gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
                fn = np.repeat(gn[:, None, :], 3, axis=1)
            if uv is not None:
                fuv = uv[f]
            else:
                # reference default uvs (0,0) (1,0) (0,1)
                fuv = np.broadcast_to(
                    np.array([[0, 0], [1, 0], [0, 1]], np.float32), (f.shape[0], 3, 2)
                ).copy()
            tri_v.append(fv.astype(np.float32))
            tri_n.append(fn.astype(np.float32))
            tri_uv.append(fuv.astype(np.float32))
            tri_mat.append(np.full(f.shape[0], rec.material, np.int32))
            tri_light.append(np.full(f.shape[0], rec.area_light, np.int32))

        V = np.concatenate(tri_v)
        N = np.concatenate(tri_n)
        UV = np.concatenate(tri_uv)
        MAT = np.concatenate(tri_mat)
        LIGHT = np.concatenate(tri_light)
        T = V.shape[0]
        if T == 0:
            # degenerate empty scene: one far-away dummy triangle
            V = np.full((1, 3, 3), 1e30, np.float32)
            V[0, 1, 0] += 1.0
            V[0, 2, 1] += 1.0
            N = np.broadcast_to(np.float32([0, 0, 1]), (1, 3, 3)).copy()
            UV = np.zeros((1, 3, 2), np.float32)
            MAT = np.zeros(1, np.int32)
            LIGHT = np.full(1, -1, np.int32)
            T = 1

        bvh = build_bvh(V[:, 0], V[:, 1], V[:, 2], max_leaf=max_leaf)
        order = bvh.order
        V, N, UV = V[order], N[order], UV[order]
        MAT, LIGHT = MAT[order], LIGHT[order]

        # world bounds for directional/IBL emission + auto radii —
        # includes analytic spheres and disks (reference scene bbox spans
        # every primitive)
        bmin = V.reshape(-1, 3).min(axis=0)
        bmax = V.reshape(-1, 3).max(axis=0)
        for c_, r_, _m, _l in spheres:
            bmin = np.minimum(bmin, np.asarray(c_) - r_)
            bmax = np.maximum(bmax, np.asarray(c_) + r_)
        for c_, _n, _u, r_, _m, _l, _cl in disks:
            bmin = np.minimum(bmin, np.asarray(c_) - r_)
            bmax = np.maximum(bmax, np.asarray(c_) + r_)
        world_center = 0.5 * (bmin + bmax)
        # reference BBox::getBoundingSphere uses the *full* diagonal length
        # as radius (src/GoblinBBox.h:51-54)
        world_radius = float(np.linalg.norm(bmax - bmin)) or 1.0

        # emissive triangle segments ordered by light id
        em_order = np.argsort(LIGHT + (LIGHT < 0) * (1 << 30), kind="stable")
        em_sel = em_order[LIGHT[em_order] >= 0]
        em_v = V[em_sel]
        e1 = em_v[:, 1] - em_v[:, 0]
        e2 = em_v[:, 2] - em_v[:, 0]
        em_n = np.cross(e1, e2)
        em_area = 0.5 * np.linalg.norm(em_n, axis=-1)
        em_n = em_n / np.maximum(np.linalg.norm(em_n, axis=-1, keepdims=True), 1e-20)

        # per-light world areas for area lights (triangle segments +
        # analytic sphere emitters, reference GeometrySet area CDF,
        # src/GoblinLight.cpp:289-343 + GoblinSphere area 4*pi*r^2)
        L_n = max(1, len(self.lights.types))
        areas = np.zeros(L_n, np.float32)
        sph_l_center = np.zeros((L_n, 3), np.float32)
        sph_l_radius = np.zeros(L_n, np.float32)
        light_is_sphere = np.zeros(L_n, bool)
        for i, t in enumerate(self.lights.types):
            if t == LIGHT_AREA:
                areas[i] = em_area[LIGHT[em_sel] == i].sum()
        for center, radius, _m, lgt in spheres:
            if lgt >= 0:
                # a light must be either triangle-backed or a single
                # sphere: sample_li routes is_sphere lights exclusively
                # through the cone-sampling path, so mixing emitter kinds
                # (or two spheres) under one light id would corrupt the
                # area pdf and silently never sample the other emitters
                if areas[lgt] > 0.0 or light_is_sphere[lgt]:
                    raise ValueError(
                        f"area light {lgt} has multiple emitter "
                        "geometries (sphere + triangles or two spheres); "
                        "declare one light per emitter geometry"
                    )
                areas[lgt] = 4.0 * np.pi * radius * radius
                sph_l_center[lgt] = center
                sph_l_radius[lgt] = radius
                light_is_sphere[lgt] = True
        self.lights.areas = list(areas[: len(self.lights.types)])

        env_power = 0.0
        if self.env_light_id >= 0 and self.env_image is not None:
            # reference ImageBasedLight::power: averageRadiance * PI *
            # (4 PI r^2) on the scene bounding sphere
            # (src/GoblinLight.cpp:610-618)
            img = self.env_image
            lum = 0.212671 * img[..., 0] + 0.715160 * img[..., 1] + 0.072169 * img[..., 2]
            env_power = float(
                lum.mean() * np.pi * 4.0 * np.pi * world_radius ** 2
            )

        lights = bake_lights(
            self.lights, LIGHT[em_sel], em_area, world_center, world_radius,
            env_luminance_power=env_power,
        )
        lights["sph_center"] = jnp.asarray(sph_l_center)
        lights["sph_radius"] = jnp.asarray(sph_l_radius)
        lights["is_sphere"] = jnp.asarray(light_is_sphere)

        tex_sys = TextureSystem(self.color_textures)
        ftex_sys = TextureSystem(self.float_textures)

        M = len(self.materials)
        soup_np = np.concatenate(
            [V[:, 0], V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]], axis=-1
        ).astype(np.float32)
        scene = {
            "node_bounds": jnp.asarray(bvh.bounds),
            "node_meta": jnp.asarray(bvh.meta),
            "tri_soup": jnp.asarray(soup_np),
            "tri_n": jnp.asarray(N),
            "tri_uv": jnp.asarray(UV),
            "tri_mat": jnp.asarray(MAT),
            "tri_light": jnp.asarray(LIGHT),
            "mat_type": jnp.asarray(
                np.asarray([m.kind for m in self.materials], np.int32)
            ),
            "mat_tex_c0": jnp.asarray(
                np.asarray([m.tex_c0 for m in self.materials], np.int32)
            ),
            "mat_tex_c1": jnp.asarray(
                np.asarray([m.tex_c1 for m in self.materials], np.int32)
            ),
            "mat_tex_f0": jnp.asarray(
                np.asarray([m.tex_f0 for m in self.materials], np.int32)
            ),
            "mat_tex_f1": jnp.asarray(
                np.asarray([m.tex_f1 for m in self.materials], np.int32)
            ),
            "mat_eta": jnp.asarray(
                np.asarray([m.eta for m in self.materials], np.float32)
            ),
            "mat_k": jnp.asarray(np.asarray([m.k for m in self.materials], np.float32)),
            "mat_inner": jnp.asarray(
                np.asarray([m.inner for m in self.materials], np.int32)
            ),
            # fused per-material row (one gather in gather_material):
            # [mtype, tex_c0, tex_c1, tex_f0, tex_f1, eta, k, inner]
            # with int columns bitcast through f32
            "mat_rows": jnp.asarray(_pack_mat_rows(self.materials)),
            "mat_bump": jnp.asarray(
                np.asarray([m.bump_tex for m in self.materials], np.int32)
            ),
            "mat_normal": jnp.asarray(
                np.asarray([m.normal_tex for m in self.materials], np.int32)
            ),
            # BSSRDF tables (shading/bssrdf.py); zero rows for non-
            # subsurface materials
            "mat_sigma_a": jnp.asarray(
                np.asarray([m.absorb for m in self.materials], np.float32)
            ),
            "mat_sigma_sp": jnp.asarray(
                np.asarray([m.scatter_prime for m in self.materials],
                           np.float32)
            ),
            "mat_ss_g": jnp.asarray(
                np.asarray([m.g for m in self.materials], np.float32)
            ),
            "mat_ss_A": jnp.asarray(
                np.asarray([_fresnel_a(m.eta) for m in self.materials],
                           np.float32)
            ),
            "lights": lights,
            "em_v0": jnp.asarray(em_v[:, 0] if em_sel.size else np.zeros((0, 3), np.float32)),
            "em_e1": jnp.asarray(e1 if em_sel.size else np.zeros((0, 3), np.float32)),
            "em_e2": jnp.asarray(e2 if em_sel.size else np.zeros((0, 3), np.float32)),
            "em_n": jnp.asarray(em_n if em_sel.size else np.zeros((0, 3), np.float32)),
            # fused emissive-triangle rows [v0, e1, e2, n] — one gather
            # per light sample instead of four
            "em_rows": jnp.asarray(
                np.concatenate([em_v[:, 0], e1, e2, em_n], axis=-1)
                if em_sel.size else np.zeros((0, 12), np.float32)
            ),
            "tex_atlas": tex_sys.atlas,
            "ftex_atlas": ftex_sys.atlas,
            "tex_const": tex_sys.const,
            "ftex_const": ftex_sys.const,
        }
        if self.vol_grid is not None:
            scene["vol_grid"] = jnp.asarray(self.vol_grid)

        if self.env_light_id >= 0 and self.env_image is not None:
            from ..lights.envmap import bake_env

            scene["env"] = bake_env(
                self.env_image, self.env_filter, self.env_orientation
            )

        if spheres:
            scene["sph_center"] = jnp.asarray(
                np.stack([s[0] for s in spheres]).astype(np.float32)
            )
            scene["sph_radius"] = jnp.asarray(
                np.asarray([s[1] for s in spheres], np.float32)
            )
            scene["sph_mat"] = jnp.asarray(
                np.asarray([s[2] for s in spheres], np.int32)
            )
            scene["sph_light"] = jnp.asarray(
                np.asarray([s[3] for s in spheres], np.int32)
            )

        if disks:
            scene["dsk_center"] = jnp.asarray(
                np.stack([d[0] for d in disks]).astype(np.float32)
            )
            scene["dsk_n"] = jnp.asarray(
                np.stack([d[1] for d in disks]).astype(np.float32)
            )
            scene["dsk_u"] = jnp.asarray(
                np.stack([d[2] for d in disks]).astype(np.float32)
            )
            scene["dsk_radius"] = jnp.asarray(
                np.asarray([d[3] for d in disks], np.float32)
            )
            scene["dsk_mat"] = jnp.asarray(
                np.asarray([d[4] for d in disks], np.int32)
            )
            scene["dsk_light"] = jnp.asarray(
                np.asarray([d[5] for d in disks], np.int32)
            )
            scene["dsk_lens"] = jnp.asarray(
                np.asarray([d[6] for d in disks], bool)
            )

        meta = SceneMeta(
            camera=self.camera,
            settings=dict(self.settings),
            volume=self.volume,
            n_tris=T,
            n_nodes=bvh.num_nodes,
            n_materials=M,
            n_lights=len(self.lights.types),
            n_spheres=len(spheres),
            n_disks=len(disks),
            has_lens=any(d[6] for d in disks),
            texture_system=tex_sys,
            float_texture_system=ftex_sys,
            max_leaf=max_leaf,
            has_perturb=any(
                m.bump_tex >= 0 or m.normal_tex >= 0 for m in self.materials
            ),
            has_bssrdf=any(
                m.kind == MAT_SUBSURFACE for m in self.materials
            ),
            has_null=any(m.kind == MAT_MASK for m in self.materials),
            has_env=self.env_light_id >= 0,
            env_light_id=self.env_light_id,
            light_sample_nums=tuple(
                int(n) for n in self.lights.sample_nums
            ),
            all_delta_lights=(
                self.env_light_id < 0
                and all(t in (0, 1, 2) for t in self.lights.types)
            ),
            material_kinds=tuple(sorted({m.kind for m in self.materials})),
            output_path=self.output_path,
            trace_backend=trace_backend,
            trace_compact=trace_compact,
            trace_sort=os.environ.get("GOBLIN_SORT", "0") == "1",
            trace_sort_bounce=os.environ.get("GOBLIN_SORT_BOUNCE", "0")
            == "1",
            world_bounds=(tuple(float(v) for v in bmin),
                          tuple(float(v) for v in bmax)),
        )
        return scene, meta
