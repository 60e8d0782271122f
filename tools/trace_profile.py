#!/usr/bin/env python
"""jax.profiler trace of one production path-tracing pass on bunny.

Runs bench.py's pass (512x384, depth 5, 64k-ray chunks) once to compile,
traces the next pass into --trace-dir (default <repo>/profile_trace), and
prints the device time per operation name, largest first, read back from
the trace with jax.profiler.ProfileData. Needs a GPU:

    python tools/trace_profile.py [--trace-dir DIR] [--top N]
"""

import argparse
import collections
import glob
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def device_op_times(trace_dir):
    """{op name: (total ns, count)} over the GPU planes of the newest
    .xplane.pb under trace_dir, and the window the events span (ns)."""
    import jax

    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    data = jax.profiler.ProfileData.from_file(path)
    totals = collections.defaultdict(lambda: [0, 0])
    lo, hi = None, 0
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                totals[ev.name][0] += ev.duration_ns
                totals[ev.name][1] += 1
                lo = ev.start_ns if lo is None else min(lo, ev.start_ns)
                hi = max(hi, ev.start_ns + ev.duration_ns)
    return dict(totals), (hi - lo if lo is not None else 0)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace-dir",
                        default=os.path.join(_REPO, "profile_trace"))
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from goblin_tpu import runtime
    from goblin_tpu.assets import ensure_bunny_obj
    from goblin_tpu.camera import film as film_mod
    from goblin_tpu.integrators import common
    from goblin_tpu.integrators.path import make_li
    from goblin_tpu.scene.loader import load_scene

    device = runtime.require_gpu()
    runtime.enable_compile_cache()
    ensure_bunny_obj(os.path.join(_REPO, "examples", "models", "bunny.obj"))
    scene, meta = load_scene(
        os.path.join(_REPO, "examples", "bunny.json"),
        {"render_method": "path_tracing", "max_ray_depth": 5},
    )
    render_pass, _ = common.make_render_pass(
        scene, meta, make_li(meta), spp=4, seed=0, chunk_size=1 << 16
    )
    color, weight = film_mod.new_film(meta.camera.film)
    color, weight = render_pass(color, weight, jnp.int32(0))
    jax.block_until_ready((color, weight))
    with jax.profiler.trace(args.trace_dir):
        color, weight = render_pass(color, weight, jnp.int32(1))
        jax.block_until_ready((color, weight))

    totals, window = device_op_times(args.trace_dir)
    busy = sum(t for t, _ in totals.values())
    print(f"{device['device_kind']}, trace {meta.trace_backend}: {len(totals)} "
          f"device op names, summed device time {busy / 1e6:.3f} ms over "
          f"a {window / 1e6:.3f} ms window")
    for name, (t, n) in sorted(totals.items(), key=lambda kv: -kv[1][0])[
            :args.top]:
        print(f"{t / 1e6:9.3f} ms {100.0 * t / max(busy, 1):5.1f}% "
              f"x{n:<5d} {name[:100]}")


if __name__ == "__main__":
    main()
