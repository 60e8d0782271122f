"""Process set-up shared by every entry point (CLI, bench scripts,
chip_smoke.py, tests).

Compilation cache: where JAX_COMPILATION_CACHE_DIR is set, JAX reads it
itself and nothing here overrides it. Otherwise the cache lives at a
fixed directory inside the checkout (<repo>/.jax_cache, git-ignored), so
every process run from one checkout shares it.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Configure the persistent cache before the first compile; returns
    its path."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program, however small or quick to compile
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def require_gpu() -> dict:
    """The device a measurement runs on, as JAX reports it. Exits when JAX
    finds no GPU: a timing taken elsewhere is no device metric."""
    import sys

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"needs an NVIDIA GPU; JAX found {len(devs)} "
                 f"{devs[0].platform} device(s)")
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}
