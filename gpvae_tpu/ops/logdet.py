"""Log-determinants via the Cholesky diagonal.

Replaces the reference's ``tf.linalg.logdet``
(src/Models/syndata/GP_VAE_syn_data.py:227-228), the numerically unstable raw
``tf.matrix_determinant`` + ``tf.log`` ancestor
(src/old/VAE_learntime_GP.py:174-179, src/Models/VAE_GPprior_diag_cov.py:84),
and the ``np.linalg.det`` probe in src/determinant_testing_minimal.py:31.

No determinant is ever materialized: ``logdet K = 2 * sum(log(diag(L)))``
stays in log space, which is exactly the fix the reference's fp64 casts and
``det + 1e-15`` band-aids (src/old/GP_VAE_syn_data.py:197) were approximating.
"""
from __future__ import annotations

import jax.numpy as jnp

from gpvae_tpu.ops.chol import cholesky


def logdet_from_chol(l: jnp.ndarray) -> jnp.ndarray:
    """``logdet(K)`` for ``K = L L^T``; L ``[..., T, T]`` -> ``[...]``.

    Masked/identity-padded rows have ``L_ii = 1`` and contribute exactly 0.
    """
    diag = jnp.diagonal(l, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def chol_logdet(k: jnp.ndarray):
    """Factor ``k`` and return ``(L, logdet k)`` in one call."""
    l = cholesky(k)
    return l, logdet_from_chol(l)


def slogdet_psd(k: jnp.ndarray) -> jnp.ndarray:
    """logdet of a PSD matrix via Cholesky (parity harness entry point for
    the reference's determinant_testing_minimal.py probe)."""
    return logdet_from_chol(cholesky(k))
