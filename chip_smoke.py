#!/usr/bin/env python
"""Smoke test of the renderer's main path on an NVIDIA GPU.

    python chip_smoke.py               phases a-d, one GPU
    python chip_smoke.py --devices 4   phase e alone, four GPUs

Phases:
  a  device check: a GPU or nothing; the card's name and power limit
  b  trace-kernel parity at full-frame widths on wavefronts captured from
     the bunny path tracer (primary, bounce-2 continuation, shadow):
     ops.trace_kernel against accel.traverse.trace on the same card, and a
     4096-ray slice against the same trace on the CPU device
  c  every render method through render.render_context on
     examples/bunny.json at 512x384, checked for finite, non-black images
     with a plausible mean; path tracing and SPPM at 128x96 on the GPU
     against the CPU device by 8x8 block means (SPPM split into its direct
     and photon parts, and its kernel render against the jnp trace's on
     the card); the dot / cuBLAS count of the compiled path-tracing pass
  d  the bench pass (bench.py's path-tracing pass, 4 spp at depth 5, plus
     one SPPM iteration at depth 20) with the trace kernel and with the
     plain jnp trace, alternating kernel, jnp, jnp, kernel
  e  (--devices 4 only) parallel.mesh.render_sharded and
     make_sharded_train_step on a 4-GPU mesh against a 1-device mesh

Exits non-zero on the first failed check. The last line of stdout is one
JSON object naming the device JAX ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

_REPO = os.path.dirname(os.path.abspath(__file__))
BUNNY = os.path.join(_REPO, "examples", "bunny.json")

# (method, spp, depth, expected image mean range). The ranges are 0.5x-2x
# the mean of a CPU render of the same scene at 64x48 and 16 spp (path
# tracing 0.01302, AO 0.8535, Whitted 0.01271, light tracing 0.01263,
# BDPT 0.01307, SPPM 0.01903): the smoke renders few samples at another
# film size, and the band only has to catch a broken image (black, blown
# out, or a method that lost its light). SPPM keeps bunny.json's depth 20;
# the others use bench.py's depth 5 (Whitted's ray tree doubles per level).
RENDERS = (
    ("path_tracing", 4, 5, (0.0065, 0.026)),
    ("ao", 1, 5, (0.43, 1.0)),
    ("whitted", 1, 5, (0.0064, 0.025)),
    ("light_tracing", 1, 5, (0.0063, 0.025)),
    ("bdpt", 1, 5, (0.0065, 0.026)),
    ("sppm", 2, 20, (0.0095, 0.038)),
)
# wavefront trace parity, kernel vs jnp reference on the card: both run
# the same walk in f32 and differ only in how the compilers contract
# products into FMAs, so a lane flips only when a ray grazes a triangle
# edge within a rounding step
MIN_LANE_AGREEMENT = 0.9999
T_RTOL = 1e-5
# GPU against the CPU device on a 4096-ray slice: the same, with the CPU's
# own contraction; at most 4 lanes of 4096
MIN_CPU_LANE_AGREEMENT = 0.999
# GPU against CPU renders, 8x8 block means: the renders draw the same
# samples, but a path can diverge after a float rounding difference (the
# glass bunny's refraction amplifies it) and the film's scatter splats are
# summed by atomics in no fixed order on the GPU. A block passes within 2%
# or 1e-3, and the image means agree to 0.5%. Path tracing and SPPM's
# camera-path part (its direct light) must pass in every block.
BLOCK_RTOL = 0.02
BLOCK_ATOL = 1e-3
MEAN_RTOL = 0.005
# SPPM's photon part alone may leave a few blocks outside. Photon paths
# part under XLA:GPU's and XLA:CPU's rounding, more with every bounce
# (H100 against the CPU on bunny 128x96: 0.8% of photons at their first
# hit, an eighth by the tenth, half by the twentieth), and each carries
# its flux to other pixels. Over 3 seeds at 2 and 8 iterations, 9 to 21
# of the 576 block channels fell outside (at most 3.6%), 5 at 32
# iterations; the kernel's and the jnp trace's renders on the card were
# equal to 1.5e-8, so the trace is not the cause. Two renders of other
# seeds differ in ~40% of the blocks. The bound is twice the worst reading.
SPPM_PHOTON_MAX_BAD_SHARE = 0.075


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str):
    print(msg, flush=True)


@contextmanager
def trace_backend(name: str):
    """Scenes loaded inside bake with this trace backend."""
    old = os.environ.get("GOBLIN_TRACE")
    os.environ["GOBLIN_TRACE"] = name
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("GOBLIN_TRACE")
        else:
            os.environ["GOBLIN_TRACE"] = old


def scene_at(width: int, height: int) -> str:
    """A copy of bunny.json with another film size (model paths made
    absolute), written to a temporary directory."""
    with open(BUNNY) as f:
        doc = json.load(f)
    doc["camera"]["film"]["resolution"] = [width, height]
    for g in doc["geometries"]:
        if "file" in g:
            g["file"] = os.path.join(os.path.dirname(BUNNY), g["file"])
    path = os.path.join(tempfile.mkdtemp(prefix="goblin_smoke_"),
                        f"bunny_{width}x{height}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- phase a


def phase_a(n_devices: int):
    import jax

    from goblin_tpu import runtime

    runtime.require_gpu()
    devs = jax.devices()
    check(len(devs) >= n_devices,
          f"{n_devices} GPUs asked for, {len(devs)} visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log("[a] nvidia-smi name, power.limit:")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    log(f"[a] jax: {len(devs)} x {devs[0].platform} ({devs[0].device_kind}),"
        f" jax {jax.__version__}")
    return devs


# ---------------------------------------------------------------- phase b


def capture_wavefronts(scene, meta, depth=4):
    """Every trace_rays input of one full-frame path-tracing sample
    (tile order, dead lanes included), recorded inside one jit."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from goblin_tpu.core.rng import hash_uniform
    from goblin_tpu.integrators import common
    from goblin_tpu.integrators.path import make_li
    from goblin_tpu.scene import intersect as scn

    spec = meta.camera.film
    xs_, xc, ys_, yc = spec.crop_window()
    row_major = (np.arange(ys_, ys_ + yc)[:, None] * spec.x_res
                 + np.arange(xs_, xs_ + xc)[None, :]).reshape(-1)
    perm, _ = common.tile_permutation(yc, xc)
    pix = jnp.asarray(row_major[perm].astype(np.int32))
    li = make_li(meta, max_depth=depth, unroll=True)
    rec = []
    orig = scn.trace_rays

    def recorder(scene_, meta_, o, d, mint, maxt, any_hit=False, sort=None):
        rec.append((any_hit, (o, d, mint, maxt)))
        return orig(scene_, meta_, o, d, mint, maxt, any_hit=any_hit,
                    sort=sort)

    def run(pix):
        rec.clear()
        s = jnp.int32(0)
        x, y = common.pixel_samples(0, pix, spec.x_res, s, 1)
        lu = hash_uniform(0, pix, s, common.BOUNCE_CAMERA, common.DIM_LENS_U)
        lv = hash_uniform(0, pix, s, common.BOUNCE_CAMERA, common.DIM_LENS_V)
        li(scene, meta, meta.camera.generate_ray(x, y, lu, lv), pix, s, 0)
        return [r[1] for r in rec]

    scn.trace_rays = recorder
    try:
        waves = jax.jit(run)(pix)
    finally:
        scn.trace_rays = orig
    flags = [r[0] for r in rec]
    closest = [w for w, a in zip(waves, flags) if not a]
    shadow = [w for w, a in zip(waves, flags) if a]
    # closest-hit records: primary, bounce-1 continuation, bounce-2 ...
    return {"primary": (closest[0], False),
            "bounce2": (closest[2], False),
            "shadow1": (shadow[0], True)}


def median_time(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def compare_traces(name, got, ref, min_agree):
    import numpy as np

    hk, hr = np.asarray(got.hit), np.asarray(ref.hit)
    tk, tr = np.asarray(got.tri), np.asarray(ref.tri)
    hit_agree = float((hk == hr).mean())
    tri_agree = float((tk == tr).mean())
    same = hk & hr & (tk == tr)
    t_k, t_r = np.asarray(got.t)[same], np.asarray(ref.t)[same]
    rel = np.abs(t_k - t_r) / np.maximum(np.abs(t_r), 1e-30)
    max_rel = float(rel.max()) if rel.size else 0.0
    log(f"    {name}: hit agreement {hit_agree:.6f}, tri agreement "
        f"{tri_agree:.6f}, max t rel diff {max_rel:.3e} over "
        f"{int(same.sum())} common hits")
    check(hit_agree >= min_agree and tri_agree >= min_agree,
          f"{name}: lane agreement below {min_agree}")
    check(max_rel <= T_RTOL, f"{name}: t differs by more than rtol {T_RTOL}")


def phase_b():
    import jax
    import numpy as np

    from goblin_tpu.accel import traverse
    from goblin_tpu.ops import trace_kernel
    from goblin_tpu.scene.loader import load_scene

    with trace_backend("kernel"):
        scene, meta = load_scene(BUNNY, {"render_method": "path_tracing"})
    tables = (scene["node_bounds"], scene["node_meta"], scene["tri_soup"])
    log(f"[b] bunny: {meta.n_tris} triangles, {meta.n_nodes} BVH nodes, "
        f"max_leaf {meta.max_leaf}")
    waves, dt = timed(capture_wavefronts, scene, meta)
    log(f"[b] captured wavefronts in {dt:.1f} s (compile included)")
    cpu = jax.devices("cpu")[0]
    for name, (w, any_hit) in waves.items():
        R = w[0].shape[0]
        alive = float(np.asarray(w[3] > w[2]).mean())
        kw = dict(max_leaf=meta.max_leaf, any_hit=any_hit)
        got = trace_kernel.trace(*tables, *w, **kw)
        ref = traverse.trace(*tables, *w, **kw)
        t_kernel = median_time(
            lambda *a: trace_kernel.trace(*a, **kw), *tables, *w)
        t_jnp = median_time(lambda *a: traverse.trace(*a, **kw), *tables, *w)
        log(f"[b] {name}: {R} rays ({alive:.3f} live), any_hit={any_hit}: "
            f"kernel {t_kernel * 1e3:.3f} ms, jnp {t_jnp * 1e3:.3f} ms "
            "(median of 5)")
        compare_traces(name, got, ref, MIN_LANE_AGREEMENT)
        if name == "primary":
            n = min(R, 4096)
            mid = slice((R - n) // 2, (R + n) // 2)
            args_cpu = [jax.device_put(a, cpu) for a in tables] + [
                jax.device_put(a[mid], cpu) for a in w]
            ref_cpu = traverse.trace(*args_cpu, **kw)
            check(ref_cpu.t.devices() == {cpu}, "CPU trace left the CPU")
            sliced = type(got)(*(v[mid] for v in got))
            compare_traces(f"primary[{n}] GPU kernel vs CPU jnp", sliced,
                           ref_cpu, MIN_CPU_LANE_AGREEMENT)


# ---------------------------------------------------------------- phase c


def block_means(img, b=8):
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))


def count_dots(hlo_text: str):
    n_dot = sum(1 for line in hlo_text.splitlines()
                if " dot(" in line or "= dot(" in line)
    n_blas = hlo_text.count("__cublas")
    return n_dot, n_blas


def compare_blocks(label, got, ref, max_bad_share=0.0):
    """8x8 block means of two images within BLOCK_RTOL or BLOCK_ATOL, in
    all blocks but a share of at most max_bad_share."""
    import numpy as np

    bg, bc = block_means(got), block_means(ref)
    diff = np.abs(bg - bc)
    bad = diff > np.maximum(BLOCK_RTOL * np.abs(bc), BLOCK_ATOL)
    log(f"[c] {label}: max block diff {float(diff.max()):.3e}, blocks "
        f"outside tolerance {int(bad.sum())} of {bad.size} (allowed "
        f"{int(max_bad_share * bad.size)})")
    check(bad.mean() <= max_bad_share, f"{label}: block means differ")


def check_means(method, got, ref):
    import numpy as np

    mg, mr = float(np.mean(got)), float(np.mean(ref))
    log(f"[c] {method} 128x96 image means GPU {mg:.6f}, CPU {mr:.6f}")
    check(abs(mg - mr) <= MEAN_RTOL * abs(mr),
          f"{method}: GPU and CPU image means differ")


def sppm_parts(path, backend, device, iterations=2):
    """SPPM through the same call render_context makes, on one device:
    the image, and the per-pixel radiance before the film filter split
    into its camera-path (direct) and photon parts."""
    import jax
    import numpy as np

    from goblin_tpu.integrators.sppm import render_sppm
    from goblin_tpu.scene.loader import load_scene

    with trace_backend(backend), jax.default_device(device):
        scene, meta = load_scene(path, {
            "render_method": "sppm", "sample_per_pixel": iterations,
            "max_ray_depth": 20})
        img, st = render_sppm(scene, meta, chunk_size=1 << 14,
                              return_state=True)
        img = np.asarray(jax.block_until_ready(img))
    r2 = np.asarray(st["radius"])[:, None] ** 2
    photon = np.asarray(st["Tau"]) / np.maximum(
        st["emitted"] * np.pi * r2, 1e-20)
    return {"image": img,
            "direct": (np.asarray(st["Ld_acc"]) / iterations).reshape(img.shape),
            "photon": photon.reshape(img.shape)}


def bench_pass(backend: str):
    """bench.py's path-tracing pass (4 spp, depth 5, 64k-ray chunks),
    compiled ahead of the timed calls."""
    import jax.numpy as jnp

    from goblin_tpu.camera import film as film_mod
    from goblin_tpu.integrators import common
    from goblin_tpu.integrators.path import make_li
    from goblin_tpu.scene.loader import load_scene

    with trace_backend(backend):
        scene, meta = load_scene(
            BUNNY, {"render_method": "path_tracing", "max_ray_depth": 5})
    render_pass, _ = common.make_render_pass(
        scene, meta, make_li(meta), spp=4, seed=0, chunk_size=1 << 16)
    color, weight = film_mod.new_film(meta.camera.film)
    t0 = time.perf_counter()
    compiled = render_pass.lower(color, weight, jnp.int32(0)).compile()
    return {"compiled": compiled, "compile_s": time.perf_counter() - t0,
            "spec": meta.camera.film}


def phase_c():
    import jax
    import numpy as np

    from goblin_tpu import render

    for method, spp, depth, (lo, hi) in RENDERS:
        overrides = {"render_method": method, "sample_per_pixel": spp,
                     "max_ray_depth": depth}
        t0 = time.perf_counter()
        img, meta = render.render_context(BUNNY, overrides, progress=False)
        img = np.asarray(jax.block_until_ready(img))
        dt = time.perf_counter() - t0
        mean = float(img.mean())
        log(f"[c] {method}: {img.shape[1]}x{img.shape[0]}, spp {spp}, depth "
            f"{depth}, trace {meta.trace_backend}: mean {mean:.6f}, max "
            f"{float(img.max()):.4f}, {dt:.1f} s (compile included)")
        film = meta.camera.film
        check(img.shape == (film.y_res, film.x_res, 3),
              f"{method}: image shape {img.shape}")
        check(bool(np.isfinite(img).all()), f"{method}: non-finite pixels")
        check(float(img.max()) > 0.0, f"{method}: all-black image")
        check(lo <= mean <= hi,
              f"{method}: mean {mean} outside the expected [{lo}, {hi}]")

    small = scene_at(128, 96)
    cpu = jax.devices("cpu")[0]
    overrides = {"render_method": "path_tracing", "sample_per_pixel": 4,
                 "max_ray_depth": 5}
    img_gpu, _ = render.render_context(small, overrides, progress=False)
    with trace_backend("jnp"), jax.default_device(cpu):
        img_cpu, _ = render.render_context(small, overrides, progress=False)
    compare_blocks("path_tracing 128x96 GPU vs CPU", np.asarray(img_gpu),
                   np.asarray(img_cpu))
    check_means("path_tracing", img_gpu, img_cpu)

    sppm = {"kernel": sppm_parts(small, "kernel", jax.devices()[0]),
            "jnp": sppm_parts(small, "jnp", jax.devices()[0]),
            "cpu": sppm_parts(small, "jnp", cpu)}
    for part in ("image", "direct", "photon"):
        compare_blocks(f"sppm 128x96 {part}, GPU kernel vs GPU jnp",
                       sppm["kernel"][part], sppm["jnp"][part])
    compare_blocks("sppm 128x96 direct, GPU vs CPU", sppm["kernel"]["direct"],
                   sppm["cpu"]["direct"])
    compare_blocks("sppm 128x96 photon, GPU vs CPU", sppm["kernel"]["photon"],
                   sppm["cpu"]["photon"], SPPM_PHOTON_MAX_BAD_SHARE)
    check_means("sppm", sppm["kernel"]["image"], sppm["cpu"]["image"])

    bench = bench_pass("kernel")
    n_dot, n_blas = count_dots(bench["compiled"].as_text())
    log(f"[c] compiled path-tracing pass: {n_dot} dot, {n_blas} cuBLAS "
        f"custom-calls ({bench['compile_s']:.1f} s to compile)")
    check(n_dot == 0 and n_blas == 0,
          "the path-tracing pass holds matrix products")
    return bench


# ---------------------------------------------------------------- phase d


def device_bytes(compiled) -> int:
    """Device bytes one call of a compiled program holds at its peak:
    arguments, outputs and XLA's temporaries, less aliased buffers."""
    m = compiled.memory_analysis()
    return (m.argument_size_in_bytes + m.output_size_in_bytes
            + m.temp_size_in_bytes - m.alias_size_in_bytes)


def sppm_stage_bytes(meta) -> int:
    """device_bytes of the largest of an SPPM iteration's three compiled
    stages (ray pass, photon deposit, visible-point drain), read from the
    passes the last render_sppm call built for this scene."""
    import jax
    import jax.numpy as jnp

    (ray_pass, (deposit_chunk, vp_drain)), = meta._jit_cache.values()
    spec = meta.camera.film
    n_pix = spec.x_res * spec.y_res
    sds = jax.ShapeDtypeStruct
    i32 = sds((), jnp.int32)
    f32 = sds((), jnp.float32)
    pix = sds((n_pix,), jnp.int32)
    vec3 = sds((3,), jnp.float32)
    ids = sds((min(1 << 15, n_pix),), jnp.int32)
    _, vp = jax.eval_shape(ray_pass, pix, i32)
    rows, e_hash, e_idx = jax.eval_shape(deposit_chunk, ids, i32, vec3, f32,
                                         f32)
    stages = (
        ray_pass.lower(pix, i32),
        deposit_chunk.lower(ids, i32, vec3, f32, f32),
        vp_drain.lower(vp, sds((n_pix,), jnp.float32), rows, e_hash, e_idx,
                       vec3, f32, sds((n_pix, 3), jnp.float32),
                       sds((n_pix,), jnp.float32)),
    )
    return max(device_bytes(s.compile()) for s in stages)


def phase_d(kernel_bench):
    import jax
    import jax.numpy as jnp

    from goblin_tpu.camera import film as film_mod
    from goblin_tpu.integrators.sppm import render_sppm
    from goblin_tpu.scene.loader import load_scene

    variants = {"kernel": kernel_bench, "jnp": bench_pass("jnp")}
    for name, v in variants.items():
        with trace_backend(name):
            v["sppm_scene"] = load_scene(
                BUNNY, {"render_method": "sppm", "max_ray_depth": 20})
        scene, meta = v["sppm_scene"]
        _, dt = timed(lambda: render_sppm(scene, meta, iterations=1))
        v["sppm_first_s"] = dt
        v["sppm_bytes"] = sppm_stage_bytes(meta)
        v["pt"], v["sppm"] = [], []

    def run(v):
        compiled, spec = v["compiled"], v["spec"]
        color, weight = film_mod.new_film(spec)
        for s in range(4):
            t0 = time.perf_counter()
            color, weight = compiled(color, weight, jnp.int32(s))
            jax.block_until_ready((color, weight))
            v["pt"].append(time.perf_counter() - t0)
        scene, meta = v["sppm_scene"]
        _, dt = timed(lambda: render_sppm(scene, meta, iterations=1))
        v["sppm"].append(dt)

    for name in ("kernel", "jnp", "jnp", "kernel"):
        run(variants[name])
        v = variants[name]
        log(f"[d] {name}: path-tracing passes "
            f"{[round(t, 4) for t in v['pt'][-4:]]} s, SPPM iteration "
            f"{v['sppm'][-1]:.4f} s")
    # the allocator's peak_bytes_in_use cannot be reset between variants,
    # so each variant reports the peak its own compiled programs hold
    summary = {}
    for name, v in variants.items():
        summary[name] = {
            "pt_s_per_pass": statistics.median(v["pt"]),
            "sppm_s_per_iter": statistics.median(v["sppm"]),
            "pt_compile_s": v["compile_s"],
            "sppm_first_call_s": v["sppm_first_s"],
            "pt_peak_bytes": device_bytes(v["compiled"]),
            "sppm_peak_bytes": v["sppm_bytes"],
        }
        log(f"[d] {name}: median {summary[name]['pt_s_per_pass']:.4f} s per "
            f"path-tracing pass, {summary[name]['sppm_s_per_iter']:.4f} s per "
            f"SPPM iteration; path-tracing compile "
            f"{v['compile_s']:.1f} s, first SPPM call (compile included) "
            f"{v['sppm_first_s']:.1f} s; peak bytes of the compiled "
            f"path-tracing pass {summary[name]['pt_peak_bytes']}, of the "
            f"largest SPPM stage {summary[name]['sppm_peak_bytes']}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[d] process peak_bytes_in_use {peak} (all phases)")
    log("[d] summary " + json.dumps(summary))
    for key in ("pt_s_per_pass", "sppm_s_per_iter"):
        faster = summary["kernel"][key] < summary["jnp"][key]
        log(f"[d] {key}: kernel {'faster' if faster else 'NOT faster'} "
            "than jnp")


# ---------------------------------------------------------------- phase e


def phase_e(n: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from goblin_tpu.integrators.path import make_li
    from goblin_tpu.parallel import mesh as pmesh
    from goblin_tpu.scene.loader import load_scene

    scene, meta = load_scene(
        BUNNY, {"render_method": "path_tracing", "max_ray_depth": 5})
    li = make_li(meta)
    spec = meta.camera.film
    n_pix = spec.x_res * spec.y_res
    out = {}
    for k in (n, 1):
        mesh = pmesh.make_mesh(k)
        img, dt = timed(lambda: pmesh.render_sharded(
            scene, meta, li, mesh, spp=1, chunk_size=1 << 16))
        step, scene_sh = pmesh.make_sharded_train_step(scene, meta, li, mesh)
        pix = jax.device_put(jnp.arange(n_pix, dtype=jnp.int32),
                             NamedSharding(mesh, P("rays")))
        params = (scene_sh["lights"]["color"], scene_sh["tex_atlas"])
        (loss, grads), dt_step = timed(step, params, pix, jnp.int32(0))
        out[k] = (np.asarray(img), float(loss),
                  [np.asarray(g) for g in grads])
        log(f"[e] mesh of {k}: render {dt:.1f} s, train step {dt_step:.1f} s"
            f" (compile included), loss {float(loss):.6f}")
    (img_n, loss_n, g_n), (img_1, loss_1, g_1) = out[n], out[1]
    check(img_n.shape == (spec.y_res, spec.x_res, 3), "sharded image shape")
    check(bool(np.isfinite(img_n).all()), "sharded image not finite")
    bn, b1 = block_means(img_n), block_means(img_1)
    diff = float(np.abs(bn - b1).max())
    log(f"[e] image {n} vs 1 device: max 8x8 block-mean diff {diff:.3e}")
    check(bool((np.abs(bn - b1)
                <= np.maximum(BLOCK_RTOL * np.abs(b1), BLOCK_ATOL)).all()),
          "sharded image differs from the 1-device image")
    # every device traces the same rays as the 1-device run; only the
    # order of the cross-device sums differs (f32 reassociation)
    log(f"[e] loss {loss_n:.8f} vs {loss_1:.8f}")
    check(abs(loss_n - loss_1) <= 1e-5 * abs(loss_1) + 1e-9, "loss differs")
    for i, (a, b) in enumerate(zip(g_n, g_1)):
        err = float(np.abs(a - b).max())
        scale = float(np.abs(b).max())
        log(f"[e] grad {i}: max diff {err:.3e}, max |grad| {scale:.3e}")
        check(err <= 1e-4 * scale + 1e-9, f"gradient {i} differs")
    check(sum(float(np.abs(g).sum()) for g in g_1) > 0.0,
          "gradients are identically zero")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, default=1, choices=(1, 4),
                        help="4: run phase e alone on four GPUs")
    args = parser.parse_args(argv)

    # the CPU device is the second reference of phases b and c
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, _REPO)
    try:
        from goblin_tpu import runtime
    except ImportError as e:
        print(f"FAIL: the goblin_tpu package is not next to this script "
              f"({e})", file=sys.stderr)
        return 1
    runtime.enable_compile_cache()
    from goblin_tpu.assets import ensure_bunny_obj

    ensure_bunny_obj(os.path.join(_REPO, "examples", "models", "bunny.obj"))
    t_start = time.perf_counter()
    try:
        devs = phase_a(args.devices)
        if args.devices == 4:
            phase_e(4)
        else:
            phase_b()
            bench = phase_c()
            phase_d(bench)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
