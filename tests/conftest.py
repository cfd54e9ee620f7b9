"""Test env: CPU backend with 8 virtual devices (the standard JAX answer to
testing multi-chip sharding without a cluster) and fp64 enabled for oracles.

The persistent compilation cache stays off (an empty
``JAX_COMPILATION_CACHE_DIR``): the CLI entry point would otherwise turn it
on inside the test workers, which run concurrently.
"""
import os

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_report_header(config):
    return (
        f"jax backend: {jax.default_backend()}, "
        f"devices: {len(jax.devices())}"
    )
