"""Test config: the CPU backend with 8 virtual devices.

Unit tests run on the CPU whatever JAX_PLATFORMS the shell carries;
multi-device sharding is checked on virtual CPU devices
(xla_force_host_platform_device_count) per SURVEY.md §4.5. Checks that
need an NVIDIA GPU carry the `gpu` marker and skip elsewhere. A run that
selects them alone (`python -m pytest tests/ -m gpu`) keeps the platform
JAX would choose, so on the card they run there.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402

from goblin_tpu import runtime  # noqa: E402

# XLA:CPU compiles are slow (~1s per tiny op); the persistent
# compilation cache makes repeat test runs fast
runtime.enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration tests"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on other backends"
    )
    # before any test module touches a device: the platform goes through
    # the live config too, in case jax was imported before this file ran
    if config.getoption("markexpr", "") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (backend is "
                    f"{jax.default_backend()!r})")
