"""Numerical guards.

The reference's de-facto "sanitizer" is casting the KL chain to fp64
(src/Models/syndata/GP_VAE_syn_data.py:218-225) after its fp32 ancestor
underflowed determinants (src/old/VAE_learntime_GP.py:174-183, the
``det + 1e-15`` band-aid at src/old/GP_VAE_syn_data.py:197).  This framework
never forms determinants, but fp32 on an accelerator still deserves guards:

* :func:`enable_nan_debugging` — flips ``jax_debug_nans`` so the first NaN
  raises with a traceback to the producing op;
* :func:`check_finite` / :func:`assert_finite` — pytree-wide finiteness
  checks, jit-compatible via ``jax.debug`` (check) or host round-trip
  (assert).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def enable_nan_debugging(enable: bool = True):
    """First NaN/Inf produced under jit raises immediately (re-runs the
    offending op un-jitted for a precise traceback)."""
    jax.config.update("jax_debug_nans", enable)


def check_finite(tree, name: str = "tree") -> jnp.ndarray:
    """Jit-compatible: returns a scalar bool (all leaves finite) and prints
    a warning from inside the compiled program when violated."""
    leaves = jax.tree_util.tree_leaves(tree)
    finite = jnp.array(True)
    for leaf in leaves:
        if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating):
            finite = jnp.logical_and(finite, jnp.isfinite(leaf).all())
    jax.lax.cond(
        finite,
        lambda: None,
        lambda: jax.debug.print(
            "WARNING: non-finite values detected in {n}", n=name
        ),
    )
    return finite


def assert_finite(tree, name: str = "tree"):
    """Host-side hard check (forces a sync; use outside hot loops)."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        arr = jnp.asarray(leaf)
        if jnp.issubdtype(arr.dtype, jnp.floating) and not bool(
            jnp.isfinite(arr).all()
        ):
            raise FloatingPointError(
                f"non-finite values in {name}{jax.tree_util.keystr(path)}"
            )
