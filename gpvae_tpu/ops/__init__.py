"""Linear-algebra ops for the GP covariance subsystem.

This package re-owns the native ops the reference delegates to TF 1.x's
bundled C++/Eigen kernels (SURVEY.md §2.3):

* ``tf.cholesky``            -> :func:`cholesky` (``jnp.linalg.cholesky``
                                with an analytic custom VJP)
* ``tf.linalg.logdet``       -> :func:`logdet_from_chol` (from the Cholesky
                                diagonal; no determinant is ever formed)
* ``tf.matrix_inverse``      -> eliminated; :func:`solve_triangular` (trsm)
* ``tf.matrix_determinant``  -> same logdet-via-Cholesky path
* ``L @ eps`` sampling matmul-> one batched einsum in gp.py
"""
from gpvae_tpu.ops.chol import cholesky
from gpvae_tpu.ops.trsm import solve_triangular
from gpvae_tpu.ops.logdet import logdet_from_chol, chol_logdet, slogdet_psd

__all__ = [
    "cholesky",
    "solve_triangular",
    "logdet_from_chol",
    "chol_logdet",
    "slogdet_psd",
]
