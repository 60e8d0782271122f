#!/usr/bin/env python
"""Per-method benchmark: SPPM / BDPT / light tracing on bunny, on the GPU
(fails when JAX finds no GPU).

Prints ONE JSON line per method:
  {"metric": "bunny_<method>_throughput", "value": N, "unit": ..., device}

Ray accounting per method (dispatched lane-rays, matching bench.py's
convention):
- sppm: per iteration, camera pass traces 1 + (depth-1) closest-hit +
  depth shadow rays per pixel lane; photon pass traces depth
  closest-hit rays per photon lane (n_photons ~ n_pixels).
- bdpt: per sample, light walk depth + eye walk depth closest-hit
  lane-rays plus (s x t) connection shadow rays ~ depth^2, dominated by
  the (maxPathLength)^2 visibility tests actually dispatched.
- light_tracing (t1): light walk depth closest-hit + depth camera
  connection shadow rays per path lane.
These counts are documented approximations of dispatched lane-rays —
the point is tracking each method's trend, not cross-method comparison.
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)


def main():
    import jax

    from goblin_tpu import runtime
    from goblin_tpu.assets import ensure_bunny_obj
    from goblin_tpu.scene.loader import load_scene

    device = runtime.require_gpu()
    runtime.enable_compile_cache()

    ensure_bunny_obj(os.path.join(_REPO, "examples", "models", "bunny.obj"))
    depth = 5
    spp = 2
    n_pix = 512 * 384
    for method in ("sppm", "bdpt", "light_tracing"):
        scene, meta = load_scene(
            os.path.join(_REPO, "examples", "bunny.json"),
            {"render_method": method, "max_ray_depth": depth,
             "sample_per_pixel": spp,
             "initial_radius": 0.01},
        )
        from goblin_tpu import splatting

        def run():
            return splatting.render_dispatch(scene, meta, method,
                                             chunk_size=1 << 15)

        img = run()  # warmup/compile (first run)
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        img = run()
        jax.block_until_ready(img)
        dt = time.perf_counter() - t0

        if method == "sppm":
            lane_rays = spp * n_pix * ((1 + 2 * (depth - 1)) + depth)
        elif method == "bdpt":
            lane_rays = spp * n_pix * (2 * depth + depth * depth)
        else:
            lane_rays = spp * n_pix * 2 * depth
        mrays = lane_rays / dt / 1e6
        line = {
            "metric": f"bunny_{method}_throughput",
            "value": round(mrays, 3),
            "unit": "Mrays/s",
            "seconds": round(dt, 3),
            "spp": spp,
            "depth": depth,
            **device,
        }
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
