"""Where JAX keeps its persistent compilation cache.

The directory is part of the cache's key: a path that changes from run to
run (a temp dir, a pid, a time) never hits.  So the entry points
(``python -m gpvae_tpu``, ``bench.py``, ``chip_smoke.py``) call
:func:`enable_compile_cache` once at start-up.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache (gitignored)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set (even to the empty string,
    which disables the cache), JAX reads it itself and nothing else is
    set here.  Otherwise the cache goes to the fixed ``.jax_cache/`` at
    the root of the checkout.
    """
    if ENV_VAR in os.environ:
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
