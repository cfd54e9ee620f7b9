"""Sparse inducing-point GP prior (FITC) for long sequences.

BASELINE.json config 4: T=4096 sequences under an m=64 inducing-point GP
prior.  The reference's dense path is O(T^3) per (sequence, latent) and its
author abandoned a max_time=1000 attempt (src/old/GP_VAE_syn_data.py:226,
SURVEY.md §5 long-context); FITC makes the prior KL O(T m^2).

Approximation: p(z) = N(0, Q + D) with
    Q = K_tm K_mm^{-1} K_mt          (Nystrom low-rank part)
    D = diag(K_tt - diag(Q))         (FITC diagonal correction + jitter)

All KL terms against a diagonal posterior N(mu, diag v) use the Woodbury
identity and the matrix-determinant lemma through Cholesky factors of
``A = K_mm + K_mt D^{-1} K_tm`` — never materializing a T x T matrix:

    logdet(Q+D)       = logdet A - logdet K_mm + sum_i log d_i
    (Q+D)^{-1}        = D^{-1} - D^{-1} K_tm A^{-1} K_mt D^{-1}
    tr((Q+D)^{-1} diag v) = sum_i v_i / d_i - sum_i v_i [W^T W]_ii,
                            W = L_A^{-1} K_mt D^{-1}
    mu^T (Q+D)^{-1} mu    = sum_i mu_i^2 / d_i - ||W mu||^2

Everything is batched ``[B, Z]``: the only big ops are
``[T, m]`` matmuls.  Masked timesteps get d=1, zeroed K_tm rows, and
neutral mu/v, contributing exactly zero (same convention as gp.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from gpvae_tpu import kernels as kernels_lib
from gpvae_tpu.ops import cholesky, logdet_from_chol, solve_triangular

_HI = jax.lax.Precision.HIGHEST


def _resolve_jitter(jitter, dtype) -> float:
    """RBF inducing grams are savagely ill-conditioned; the jitter that
    keeps chol(K_mm) finite depends on the working precision (1e-6 is a
    fp64 habit — fp32 needs ~1e-4)."""
    if jitter is not None:
        return jitter
    return 1e-6 if jnp.dtype(dtype).itemsize >= 8 else 1e-4


def uniform_inducing_times(t_min: float, t_max: float, m: int) -> jnp.ndarray:
    """Default inducing grid: m points spread over the time range."""
    return jnp.linspace(t_min, t_max, m)


def fitc_prior_parts(
    times: jnp.ndarray,
    inducing_times: jnp.ndarray,
    lengthscales: jnp.ndarray,
    *,
    mask: jnp.ndarray | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: jnp.ndarray | float = 1.0,
    jitter: float | None = None,
):
    """Shared FITC quantities.

    Returns (l_mm [B?,Z,m,m] chol of K_mm, k_tm [B,Z,T,m], d [B,Z,T]).
    ``inducing_times`` is ``[m]`` (shared) or ``[B, m]``.
    """
    b, t = times.shape
    jitter = _resolve_jitter(jitter, times.dtype)
    if inducing_times.ndim == 1:
        s = jnp.broadcast_to(inducing_times[None], (b, inducing_times.shape[0]))
    else:
        s = inducing_times
    m = s.shape[-1]
    # signal covariance carries the gram's (1-noise) scale consistently:
    # K_mm, K_tm, and diag(K_tt) are all the noise-free signal part, and the
    # iid noise returns on D's diagonal below (cross_gram applies (1-noise))
    k_mm = kernels_lib.cross_gram(
        s, s, lengthscales, kernel=kernel, noise=noise, variance=variance,
    ) + jitter * jnp.eye(m)
    k_tm = kernels_lib.cross_gram(
        times, s, lengthscales, kernel=kernel, noise=noise,
        variance=variance, mask_a=mask,
    )
    l_mm = cholesky(k_mm)
    # diag(Q) = row-wise ||L_mm^{-1} k_m(t_i)||^2
    v_m = solve_triangular(l_mm, jnp.swapaxes(k_tm, -1, -2))  # [B,Z,m,T]
    q_diag = jnp.sum(v_m * v_m, axis=-2)                      # [B,Z,T]
    variance = jnp.asarray(variance, q_diag.dtype)
    if variance.ndim == 1:
        k_tt_diag = (1.0 - noise) * variance[None, :, None]
    else:
        k_tt_diag = jnp.broadcast_to(
            (1.0 - noise) * variance, q_diag.shape
        )
    d = jnp.maximum(k_tt_diag - q_diag, 0.0) + noise
    if mask is not None:
        mm = mask.astype(d.dtype)[:, None, :]
        d = d * mm + (1.0 - mm)  # masked -> d = 1
    return l_mm, k_tm, d


def fitc_diag_kl(
    mu: jnp.ndarray,
    log_var: jnp.ndarray,
    times: jnp.ndarray,
    inducing_times: jnp.ndarray,
    lengthscales: jnp.ndarray,
    *,
    mask: jnp.ndarray | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: jnp.ndarray | float = 1.0,
    jitter: float | None = None,
) -> jnp.ndarray:
    """KL( N(mu, diag v) || N(0, Q + D) ) -> ``[B, Z]`` in O(T m^2).

    The sparse counterpart of :func:`gpvae_tpu.gp.gp_prior_diag_kl`.
    ``mu``/``log_var`` are ``[B, T, Z]``.
    """
    t = mu.shape[-2]
    jitter = _resolve_jitter(jitter, times.dtype)
    if mask is not None:
        m_ = mask.astype(mu.dtype)[..., None]
        mu = mu * m_
        log_var = log_var * m_  # masked -> v = 1
    l_mm, k_tm, d = fitc_prior_parts(
        times, inducing_times, lengthscales, mask=mask, kernel=kernel,
        noise=noise, variance=variance, jitter=jitter,
    )
    mu_bz = jnp.swapaxes(mu, -1, -2)          # [B, Z, T]
    v_bz = jnp.exp(jnp.swapaxes(log_var, -1, -2))
    d_inv = 1.0 / d

    # Whitened form (the fp32-robust one): with
    #   V0 = L_mm^{-1} K_mt D^{-1/2},   B = I + V0 V0^T
    # B is I + PSD, so its Cholesky never loses positive-definiteness to
    # rounding — unlike A = K_mm + K_mt D^{-1} K_tm, whose ~1e6-magnitude
    # entries swamp any additive jitter in fp32.  Identities:
    #   logdet A - logdet K_mm = logdet B
    #   D^{-1} K_tm A^{-1} K_mt D^{-1} = Wt^T Wt,  Wt = L_B^{-1} V0 D^{-1/2}
    d_isqrt = jnp.sqrt(d_inv)
    v0 = solve_triangular(
        l_mm, jnp.swapaxes(k_tm, -1, -2)
    ) * d_isqrt[..., None, :]                                # [B,Z,m,T]
    m = v0.shape[-2]
    b_mat = jnp.eye(m) + jnp.einsum(
        "bzmt,bznt->bzmn", v0, v0, precision=_HI
    )
    l_b = cholesky(b_mat)
    w = solve_triangular(l_b, v0) * d_isqrt[..., None, :]    # Wt [B,Z,m,T]

    ld_p = logdet_from_chol(l_b) + jnp.sum(jnp.log(d), axis=-1)
    # tr((Q+D)^{-1} diag v)
    tr = jnp.sum(v_bz * d_inv, axis=-1) - jnp.einsum(
        "bzmt,bzmt,bzt->bz", w, w, v_bz, precision=_HI
    )
    # quad form
    wmu = jnp.einsum("bzmt,bzt->bzm", w, mu_bz, precision=_HI)
    quad = jnp.sum(mu_bz * mu_bz * d_inv, axis=-1) - jnp.sum(
        wmu * wmu, axis=-1
    )
    sum_log_v = jnp.sum(jnp.swapaxes(log_var, -1, -2), axis=-1)
    return 0.5 * (tr + quad - t + ld_p - sum_log_v)


def fitc_prior_sample(
    key: jax.Array,
    times: jnp.ndarray,
    inducing_times: jnp.ndarray,
    lengthscales: jnp.ndarray,
    num_samples: int = 1,
    *,
    mask: jnp.ndarray | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: jnp.ndarray | float = 1.0,
    jitter: float | None = None,
) -> jnp.ndarray:
    """Draw from the FITC prior in O(T m): z = K_tm K_mm^{-1} L_mm eps_m
    + sqrt(D) eps_t = K_tm L_mm^{-T} eps_m + sqrt(D) eps_t.
    Returns ``[S, B, T, Z]``."""
    l_mm, k_tm, d = fitc_prior_parts(
        times, inducing_times, lengthscales, mask=mask, kernel=kernel,
        noise=noise, variance=variance, jitter=jitter,
    )
    b, z, t, m = k_tm.shape
    k1, k2 = jax.random.split(key)
    eps_m = jax.random.normal(k1, (num_samples, b, z, m))
    eps_t = jax.random.normal(k2, (num_samples, b, z, t))
    # K_tm L_mm^{-T} = (L_mm^{-1} K_mt)^T
    v_m = solve_triangular(l_mm, jnp.swapaxes(k_tm, -1, -2))  # [B,Z,m,T]
    low_rank = jnp.einsum(
        "bzmt,sbzm->sbzt", v_m, eps_m, precision=_HI
    )
    out = low_rank + jnp.sqrt(d)[None] * eps_t
    return jnp.swapaxes(out, -1, -2)  # [S, B, T, Z]
