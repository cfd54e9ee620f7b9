"""Batched Cholesky factorization with an analytic custom VJP.

Replaces the reference's ``tf.cholesky`` call sites
(src/Models/syndata/GP_VAE_syn_data.py:138;
src/Models/Full_GP_VAE_fixed_for_MovMnist.py:133) and the numpy
``np.linalg.cholesky`` oracles
(src/Models/FullGP_and_GPdecoder_dynamic_time_analysis.py:44-55;
src/determinant_testing_minimal.py:33).

The forward is ``jnp.linalg.cholesky``, which XLA lowers to the batched
cuSOLVER ``potrf`` on the GPU.  The backward is the standard
differentiable-Cholesky rule (Murray 2016) written as two batched
triangular solves, so the ELBO differentiates through the factorization
without JAX's generic linearization of the factor.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from gpvae_tpu.ops.trsm import solve_triangular

_HI = jax.lax.Precision.HIGHEST


def _phi(m: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangular with halved diagonal (Murray 2016 backward)."""
    return jnp.tril(m) - 0.5 * jnp.tril(jnp.triu(m))


def cholesky_bwd_from_l(l: jnp.ndarray, l_bar: jnp.ndarray) -> jnp.ndarray:
    """Standard Cholesky reverse-mode: K_bar from (L, L_bar).

    K_bar = (1/2) L^{-T} (phi(L^T L_bar) + phi(L^T L_bar)^T) L^{-1},
    returned symmetrized (valid for K produced by a symmetric constructor,
    as all grams here are).
    """
    p = _phi(jnp.einsum("...ji,...jk->...ik", l, l_bar,
                        preferred_element_type=l.dtype, precision=_HI))
    w = 0.5 * (p + jnp.swapaxes(p, -1, -2))
    # tmp = L^{-T} w  : solve L^T tmp = w
    tmp = solve_triangular(l, w, left_side=True, lower=True, transpose_a=True)
    # kbar = tmp L^{-1} : solve kbar L = tmp
    kbar = solve_triangular(l, tmp, left_side=False, lower=True,
                            transpose_a=False)
    # kbar = L^{-T} sym(phi(L^T Lbar)) L^{-1} is already symmetric — the
    # symmetric-gradient convention jnp.linalg.cholesky uses.
    return kbar


@jax.custom_vjp
def cholesky(k: jnp.ndarray) -> jnp.ndarray:
    """Differentiable batched Cholesky (lower) of PSD ``k [..., T, T]``."""
    return jnp.linalg.cholesky(k)


def _cholesky_fwd(k):
    l = jnp.linalg.cholesky(k)
    return l, l


def _cholesky_bwd(l, l_bar):
    return (cholesky_bwd_from_l(l, l_bar),)


cholesky.defvjp(_cholesky_fwd, _cholesky_bwd)
