"""Top-level render dispatch: scene file -> image (the RenderContext
equivalent, reference src/GoblinRenderContext.h:7-22 + renderer factory
dispatch GoblinContextLoader.cpp:67-92)."""

from __future__ import annotations

import sys
import time

from .camera import film as film_mod
from .integrators import common
from .scene.loader import load_scene


def make_li(meta):
    """Pick the integrator's batched Li from render_setting."""
    method = meta.settings.get("render_method", "path_tracing")
    if method == "ao":
        from .integrators.ao import make_li as mk

        return mk(int(meta.settings.get("ao_sample_num", 25)))
    if method == "whitted":
        from .integrators.whitted import make_li as mk

        return mk(meta)
    if method in ("path_tracing", "path"):
        from .integrators.path import make_li as mk

        return mk(meta)
    raise ValueError(f"render_method {method!r} not supported yet")


def render_context(path: str, overrides=None, chunk_size=1 << 14,
                   progress=True):
    """Load + render + return (image, meta). Writes nothing."""
    scene, meta = load_scene(path, overrides)
    method = meta.settings.get("render_method", "path_tracing")
    if method in ("light_tracing", "bdpt", "sppm"):
        from . import splatting

        return splatting.render_dispatch(scene, meta, method,
                                         chunk_size=chunk_size), meta
    def report(done, total):
        if progress:
            print(f"\rrender progress: {100.0 * done / total:.1f}%",
                  end="", file=sys.stderr, flush=True)

    import os

    # GOBLIN_REGEN=1 selects the regenerative driver (persistent ray
    # pool that refills finished lanes with new samples); off by default,
    # the chunked scan driver is the production path.
    use_regen = os.environ.get("GOBLIN_REGEN", "0") == "1"
    if method in ("path_tracing", "path") and use_regen:
        from .integrators import wavefront

        if wavefront.supports(meta):
            img = wavefront.render_wavefront(
                scene, meta, pool=max(chunk_size, 1 << 14), report=report
            )
            if progress:
                print(file=sys.stderr)
            return img, meta
    li = make_li(meta)
    img = common.render(scene, meta, li, chunk_size=chunk_size, report=report)
    if progress:
        print(file=sys.stderr)
    return img, meta


def main(argv=None):
    """g_ray-equivalent CLI: python -m goblin_tpu scene.json [method]."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m goblin_tpu <scene.json> [render_method]")
        return 1
    from . import runtime

    runtime.enable_compile_cache()
    overrides = {}
    if len(argv) > 1:
        overrides["render_method"] = argv[1]
    t0 = time.time()
    img, meta = render_context(argv[0], overrides)
    path = film_mod.write_image(meta.camera.film, img)
    print(f"render time: {time.time() - t0:.2f}s -> {path}")
    return 0
