#!/usr/bin/env python
"""Sharding harness: the same path-tracing frame unsharded and on a mesh
of the visible GPUs (fails when JAX finds no GPU).

    python bench_scaling.py

Prints ONE JSON line. `mesh1_overhead` = t(1-device mesh) / t(unsharded)
is what the sharded code path costs on one card; with N > 1 cards,
`efficiency` = t(1-device mesh) / (N * t(N-device mesh)) is the rays/s
scaling efficiency against one card.
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)


def _timed(fn, reps=2):
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from goblin_tpu import runtime
    from goblin_tpu.assets import ensure_bunny_obj
    from goblin_tpu.camera import film as film_mod
    from goblin_tpu.integrators import common
    from goblin_tpu.integrators.path import make_li
    from goblin_tpu.parallel.mesh import make_mesh, make_sharded_render_pass
    from goblin_tpu.parallel.multihost import global_put
    from goblin_tpu.scene.loader import load_scene

    device = runtime.require_gpu()
    runtime.enable_compile_cache()
    depth, spp = 5, 1
    ensure_bunny_obj(os.path.join(_REPO, "examples", "models", "bunny.obj"))
    scene, meta = load_scene(
        os.path.join(_REPO, "examples", "bunny.json"),
        {"render_method": "path_tracing", "max_ray_depth": depth,
         "sample_per_pixel": spp},
    )
    li = make_li(meta)
    spec = meta.camera.film
    rays = spp * spec.x_res * spec.y_res * (1 + 2 * (depth - 1))

    # time PREBUILT passes (the render wrappers re-jit per call, which
    # would measure cache lookups, not work)
    render_pass, _ = common.make_render_pass(scene, meta, li, spp=spp,
                                             seed=0, chunk_size=1 << 16)
    t_plain = _timed(lambda: render_pass(*film_mod.new_film(spec),
                                         jnp.int32(0)))

    def mesh_time(n):
        mesh = make_mesh(n)
        spass, _ = make_sharded_render_pass(scene, meta, li, mesh,
                                            spp=spp, seed=0)
        rep = NamedSharding(mesh, P())

        def run():
            c, w = film_mod.new_film(spec)
            return spass(global_put(c, rep), global_put(w, rep),
                         jnp.int32(0))

        return _timed(run)

    n = device["device_count"]
    t1 = mesh_time(1)
    out = {
        "metric": "sharding", "resolution": [spec.x_res, spec.y_res],
        "spp": spp, "depth": depth, **device,
        "unsharded_mrays": round(rays / t_plain / 1e6, 3),
        "mesh1_mrays": round(rays / t1 / 1e6, 3),
        "mesh1_overhead": round(t1 / t_plain, 4),
    }
    if n > 1:
        tn = mesh_time(n)
        out.update({f"mesh{n}_mrays": round(rays / tn / 1e6, 3),
                    "efficiency": round(t1 / (n * tn), 4)})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
