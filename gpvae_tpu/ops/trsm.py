"""Batched triangular solves (trsm).

The op that *eliminates* the reference's explicit matrix inverse:
``tf.matrix_inverse(K_p)`` (src/Models/syndata/GP_VAE_syn_data.py:226) and
``np.linalg.solve(L, ...)`` in the imputation path
(src/Models/FullGP_and_GPdecoder_dynamic_time_analysis.py:40-56).  Every
KL/posterior quantity is rewritten in solve form:

* ``tr(K_p^{-1} K_q)  = ||L_p^{-1} L_q||_F^2``
* ``mu^T K_p^{-1} mu  = ||L_p^{-1} mu||^2``
* posterior conditioning uses ``L^{-1} K_*`` and ``L^{-1} z``.

XLA lowers ``triangular_solve`` to the batched cuBLAS ``trsm`` on the GPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def solve_triangular(
    a: jnp.ndarray,
    b: jnp.ndarray,
    *,
    left_side: bool = True,
    lower: bool = True,
    transpose_a: bool = False,
) -> jnp.ndarray:
    """Solve ``op(A) X = B`` (left) or ``X op(A) = B`` (right), A triangular.

    Batched over leading dims.  ``op(A) = A^T`` if ``transpose_a``.
    """
    return jax.lax.linalg.triangular_solve(
        a,
        b,
        left_side=left_side,
        lower=lower,
        transpose_a=transpose_a,
    )
