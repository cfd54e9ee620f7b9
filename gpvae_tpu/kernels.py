"""Stationary GP kernel functions and batched gram construction.

Batched JAX re-design of the reference's covariance construction
(`tf_kernel` / `build_kernels` / `approx_kernels` / `prior_kernels`,
reference: src/Models/syndata/GP_VAE_syn_data.py:41-145 and the numpy copy
`kernel_matrix` at src/Models/VAE_GPprior_diag_cov.py:153-165).

Differences from the reference, by design:

* The reference builds grams with two nested Python loops (over batch and
  latent dim), pads the flattened results to ``max_T**2`` and re-slices them
  per item.  Here the whole bank is one batched XLA op over ``[B, Z, T, T]``
  built from broadcast outer time differences — static shapes, no ragged
  slicing.
* Irregular (per-sequence) time grids are handled with a boolean mask instead
  of ragged unrolling: masked rows/columns of the gram are replaced by the
  identity, which leaves the Cholesky well-posed and makes masked timesteps
  contribute exactly zero to the KL (see gp.py).
* The kernel family is extensible (RBF / Matérn 1/2, 3/2, 5/2 / Cauchy /
  Cosine) where the reference hardcodes the scaled-RBF form
  ``K = (1-s)*exp(-dt^2/(2 l^2)) + s*I`` (GP_VAE_syn_data.py:129-137).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

# Diagonal jitter / noise weight used throughout the reference
# (``sigma_n = 1e-3`` at src/Models/syndata/GP_VAE_syn_data.py:128,137).
DEFAULT_NOISE = 1e-3

KernelFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


# ---------------------------------------------------------------------------
# Stationary kernel functions k(dt; lengthscale) with k(0) = 1.
# ---------------------------------------------------------------------------

def rbf(dt: jnp.ndarray, lengthscale: jnp.ndarray) -> jnp.ndarray:
    """Squared-exponential kernel, the reference default.

    Matches ``exp(-(t_i - t_j)**2 / (2 l**2))``
    (src/Models/syndata/GP_VAE_syn_data.py:133-136).
    """
    z = dt / lengthscale
    return jnp.exp(-0.5 * z * z)


def matern12(dt: jnp.ndarray, lengthscale: jnp.ndarray) -> jnp.ndarray:
    """Matérn ν=1/2 (Ornstein–Uhlenbeck / exponential)."""
    return jnp.exp(-jnp.abs(dt) / lengthscale)


def matern32(dt: jnp.ndarray, lengthscale: jnp.ndarray) -> jnp.ndarray:
    """Matérn ν=3/2."""
    z = jnp.sqrt(3.0) * jnp.abs(dt) / lengthscale
    return (1.0 + z) * jnp.exp(-z)


def matern52(dt: jnp.ndarray, lengthscale: jnp.ndarray) -> jnp.ndarray:
    """Matérn ν=5/2."""
    z = jnp.sqrt(5.0) * jnp.abs(dt) / lengthscale
    return (1.0 + z + z * z / 3.0) * jnp.exp(-z)


def cauchy(dt: jnp.ndarray, lengthscale: jnp.ndarray) -> jnp.ndarray:
    """Rational-quadratic/Cauchy kernel (the GP-VAE paper's choice for
    Healing-MNIST; the reference repo itself only uses RBF + Cosine)."""
    z = dt / lengthscale
    return 1.0 / (1.0 + z * z)


def cosine(dt: jnp.ndarray, lengthscale: jnp.ndarray) -> jnp.ndarray:
    """Cosine kernel, as used by the toy-data generator's second latent
    (gpflow Cosine(lengthscale=3), reference
    src/gen_data/simulate_toy_data.py:24-28)."""
    return jnp.cos(dt / lengthscale)


KERNELS: dict[str, KernelFn] = {
    "rbf": rbf,
    "matern12": matern12,
    "matern32": matern32,
    "matern52": matern52,
    "cauchy": cauchy,
    "cosine": cosine,
}


def get_kernel(name: str) -> KernelFn:
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r}; available: {sorted(KERNELS)}"
        ) from None


# ---------------------------------------------------------------------------
# Gram construction
# ---------------------------------------------------------------------------

def gram(
    times: jnp.ndarray,
    lengthscale: jnp.ndarray,
    *,
    kernel: str | KernelFn = "rbf",
    noise: float = DEFAULT_NOISE,
    variance: jnp.ndarray | float = 1.0,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Single gram matrix ``K[T, T]`` over a time vector.

    Reproduces the reference form ``K = (1-noise)*k(dt) + noise*I`` scaled by
    ``variance`` (src/Models/syndata/GP_VAE_syn_data.py:129-137 uses
    variance=1).  With ``mask`` given (True = observed), masked rows/cols are
    identity-padded: ``K = M K M + (I - diag(m))`` so the factorization stays
    well-posed and masked entries contribute zero to logdet.
    """
    kfn = get_kernel(kernel) if isinstance(kernel, str) else kernel
    dt = times[..., :, None] - times[..., None, :]
    k = variance * kfn(dt, lengthscale)
    t = times.shape[-1]
    eye = jnp.eye(t, dtype=k.dtype)
    k = (1.0 - noise) * k + noise * eye
    if mask is not None:
        m = mask.astype(k.dtype)
        mm = m[..., :, None] * m[..., None, :]
        k = k * mm + (1.0 - m[..., :, None]) * eye
    return k


def gram_bank(
    times: jnp.ndarray,
    lengthscales: jnp.ndarray,
    *,
    kernel: str | KernelFn = "rbf",
    noise: float = DEFAULT_NOISE,
    variance: jnp.ndarray | float = 1.0,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Batched per-latent gram bank ``K[B, Z, T, T]``.

    Replaces the reference's double Python loop + pad/slice machinery
    (``approx_kernels``/``prior_kernels``,
    src/Models/syndata/GP_VAE_syn_data.py:41-122) with one vectorized op:

    * ``times``        ``[B, T]``   per-sequence observation times
      (right-padded arbitrarily where masked).
    * ``lengthscales`` ``[Z]`` or ``[B, Z]`` per-latent-dim lengthscales
      (learnable in the posterior bank, reference :51).
    * ``mask``         ``[B, T]`` bool, True where observed.  Masked
      rows/cols are identity-padded.

    Returns ``[B, Z, T, T]`` in the dtype of ``times``.
    """
    if times.ndim != 2:
        raise ValueError(f"times must be [B, T], got {times.shape}")
    kfn = get_kernel(kernel) if isinstance(kernel, str) else kernel
    dt = times[:, None, :, None] - times[:, None, None, :]  # [B,1,T,T]
    if lengthscales.ndim == 1:
        ls = lengthscales[None, :, None, None]  # [1,Z,1,1]
    elif lengthscales.ndim == 2:
        ls = lengthscales[:, :, None, None]  # [B,Z,1,1]
    else:
        raise ValueError(
            f"lengthscales must be [Z] or [B, Z], got {lengthscales.shape}"
        )
    variance = jnp.asarray(variance, dtype=dt.dtype)
    if variance.ndim == 1:  # per-latent variance
        variance = variance[None, :, None, None]
    k = variance * kfn(dt, ls)
    t = times.shape[-1]
    eye = jnp.eye(t, dtype=k.dtype)
    k = (1.0 - noise) * k + noise * eye
    if mask is not None:
        m = mask.astype(k.dtype)[:, None, :]  # [B,1,T]
        mm = m[..., :, None] * m[..., None, :]  # [B,1,T,T]
        k = k * mm + (1.0 - m[..., :, None]) * eye
    return k


def cross_gram(
    times_a: jnp.ndarray,
    times_b: jnp.ndarray,
    lengthscales: jnp.ndarray,
    *,
    kernel: str | KernelFn = "rbf",
    noise: float = DEFAULT_NOISE,
    variance: jnp.ndarray | float = 1.0,
    mask_a: jnp.ndarray | None = None,
    mask_b: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Rectangular cross-covariance ``K[B, Z, Ta, Tb]`` between two time
    grids: ``(1-noise) * variance * k(dt)`` — the *signal* part of the square
    gram, with no noise diagonal.

    Used by GP-posterior conditioning (the numpy ``kernel_matrix`` blocks in
    src/Models/FullGP_and_GPdecoder_dynamic_time_analysis.py:16-22,43-50;
    note that file's ``kernel_function`` omits the (1-noise) signal scale its
    own training graph applies — we keep the training-graph semantics so the
    conditioned process is exactly the prior's).  Masked rows/cols are zeroed
    so unobserved points contribute nothing.
    """
    kfn = get_kernel(kernel) if isinstance(kernel, str) else kernel
    dt = times_a[:, None, :, None] - times_b[:, None, None, :]  # [B,1,Ta,Tb]
    if lengthscales.ndim == 1:
        ls = lengthscales[None, :, None, None]
    else:
        ls = lengthscales[:, :, None, None]
    variance = jnp.asarray(variance, dtype=dt.dtype)
    if variance.ndim == 1:
        variance = variance[None, :, None, None]
    k = (1.0 - noise) * variance * kfn(dt, ls)
    if mask_a is not None:
        k = k * mask_a.astype(k.dtype)[:, None, :, None]
    if mask_b is not None:
        k = k * mask_b.astype(k.dtype)[:, None, None, :]
    return k


def toeplitz_row(
    t: int,
    step: jnp.ndarray | float,
    lengthscales: jnp.ndarray,
    *,
    kernel: str | KernelFn = "rbf",
    noise: float = DEFAULT_NOISE,
    variance: jnp.ndarray | float = 1.0,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """First row(s) ``[Z, T]`` of the Toeplitz gram for a *uniform* grid.

    On uniform grids (all the reference MNIST configs use times ``1..20``,
    src/Models/Full_GP_VAE_fixed_for_MovMnist.py:280) the gram is symmetric
    Toeplitz: it is fully described by its first row.  The O(T) representation
    feeds the long-sequence (T=1024) path, where materializing ``[B,Z,T,T]``
    grams would waste HBM bandwidth (BASELINE.json config 3).
    """
    kfn = get_kernel(kernel) if isinstance(kernel, str) else kernel
    lags = jnp.arange(t, dtype=dtype) * jnp.asarray(step, dtype=dtype)
    variance = jnp.asarray(variance, dtype=dtype)
    if variance.ndim == 1:
        variance = variance[:, None]
    row = variance * kfn(lags[None, :], lengthscales[:, None])
    unit = jnp.zeros((t,), dtype=dtype).at[0].set(1.0)
    return (1.0 - noise) * row + noise * unit[None, :]


def toeplitz_to_dense(row: jnp.ndarray) -> jnp.ndarray:
    """Expand first-row representation ``[..., T]`` to dense ``[..., T, T]``."""
    t = row.shape[-1]
    idx = jnp.abs(jnp.arange(t)[:, None] - jnp.arange(t)[None, :])
    return row[..., idx]


@functools.partial(jax.jit, static_argnames=("kernel",))
def reference_gram(times, lengthscale, kernel="rbf"):
    """Exact reference scaled-RBF gram for parity tests
    (src/Models/syndata/GP_VAE_syn_data.py:124-137)."""
    return gram(times, lengthscale, kernel=kernel, noise=DEFAULT_NOISE)
