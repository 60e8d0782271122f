#!/usr/bin/env python
"""Benchmark: bunny.json path-trace ray throughput on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", device fields, ...}.
Fails when JAX finds no GPU.

Methodology: times the production render path (common.render — chunked
wavefront + dense filter splat) end-to-end over several full-frame
passes. Per lane-sample the wavefront executes 1 primary closest-hit
plus (max_depth-1) x (1 shadow any-hit + 1 continuation closest-hit)
= 1 + 2*(depth-1) lane-rays; masked-off lanes are dispatched too. The
*useful*-ray count (lanes whose result contributes to the image) is
reported alongside as "useful_mrays" with per-bounce active fractions.
max_ray_depth=5 matches the reference path-tracer default (bunny.json's
depth 20 belongs to its SPPM config).
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from goblin_tpu import runtime
    from goblin_tpu.assets import ensure_bunny_obj
    from goblin_tpu.integrators import common
    from goblin_tpu.integrators.path import make_li
    from goblin_tpu.scene.loader import load_scene

    device = runtime.require_gpu()
    runtime.enable_compile_cache()
    depth = 5
    spp = 4
    chunk = int(os.environ.get('GOBLIN_BENCH_CHUNK', 1 << 16))
    ensure_bunny_obj(os.path.join(_REPO, "examples", "models", "bunny.obj"))
    scene, meta = load_scene(
        os.path.join(_REPO, "examples", "bunny.json"),
        {"render_method": "path_tracing", "max_ray_depth": depth},
    )
    li = make_li(meta)
    spec = meta.camera.film
    n_pix = spec.x_res * spec.y_res

    from goblin_tpu.camera import film as film_mod

    render_pass, _ = common.make_render_pass(
        scene, meta, li, spp=spp, seed=0, chunk_size=chunk
    )
    color, weight = film_mod.new_film(spec)
    # warmup / compile
    color, weight = render_pass(color, weight, jnp.int32(0))
    jax.block_until_ready((color, weight))

    t0 = time.perf_counter()
    for s in range(spp):
        color, weight = render_pass(color, weight, jnp.int32(s))
    jax.block_until_ready((color, weight))
    dt = time.perf_counter() - t0

    # useful-ray census (untimed): per-bounce (shadow rays considered,
    # continuation rays traced). The all-delta last-bounce peel skips
    # its provably-zero continuation trace, so that bounce reports
    # cont=0 while its shadow work still counts
    li_stats = make_li(meta, with_stats=True)
    pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)

    @jax.jit
    def stats_step(pix, s_idx):
        x, y = common.pixel_samples(0, pix, spec.x_res, s_idx, 2)
        ray = meta.camera.generate_ray(x, y)
        _, (n_shadow, n_cont) = li_stats(scene, meta, ray, pix, s_idx, 0)
        return n_shadow, n_cont

    n_shadow, n_cont = jax.device_get(stats_step(pixel_ids, jnp.int32(0)))
    useful_per_sample = n_pix + int(n_shadow.sum()) + int(n_cont.sum())

    rays_per_lane = 1 + 2 * (depth - 1)
    total_rays = spp * n_pix * rays_per_lane
    mrays = total_rays / dt / 1e6
    useful_mrays = spp * useful_per_sample / dt / 1e6
    # dispatched accounting: the all-delta last-bounce peel skips one
    # continuation trace per lane-sample, so the device dispatches one
    # lane-ray fewer than the lane-ray formula of `value` counts
    disp_per_lane = rays_per_lane - (
        1 if getattr(meta, "all_delta_lights", False) else 0
    )
    disp_mrays = spp * n_pix * disp_per_lane / dt / 1e6
    print(
        json.dumps(
            {
                "metric": "bunny_path_trace_throughput",
                "value": round(mrays, 3),
                "unit": "Mrays/s",
                **device,
                "useful_mrays": round(useful_mrays, 3),
                "dispatched_mrays": round(disp_mrays, 3),
                "dispatched_rays_per_lane_sample": disp_per_lane,
                "shadow_fraction_per_bounce": [
                    round(float(a) / n_pix, 4) for a in n_shadow
                ],
                "cont_fraction_per_bounce": [
                    round(float(a) / n_pix, 4) for a in n_cont
                ],
                "trace_backend": meta.trace_backend,
                "max_leaf": meta.max_leaf,
                "spp": spp,
                "depth": depth,
                "seconds_per_pass": round(dt / spp, 4),
            }
        )
    )


if __name__ == "__main__":
    main()
