"""Linalg ops (Cholesky / trsm / logdet) and the gram-bank factorization
vs fp64 oracles, incl. the custom VJPs."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpvae_tpu import gp, kernels
from gpvae_tpu.ops import (
    cholesky,
    logdet_from_chol,
    slogdet_psd,
    solve_triangular,
)
from gpvae_tpu.ops.chol import cholesky_bwd_from_l


def random_psd(rng, n, t, cond_scale=1.0):
    a = rng.standard_normal((n, t, t)) * cond_scale
    k = a @ np.swapaxes(a, -1, -2) + t * np.eye(t)
    return k.astype(np.float64)


# the shapes the covariance path runs at: the toy/MNIST regime (T <= 64)
# through the long-sequence presets
CHOL_T = [4, 20, 45, 64, 96, 128, 200, 256, 384, 520]


@pytest.mark.parametrize("t", CHOL_T)
def test_cholesky_vs_oracle(t):
    rng = np.random.default_rng(t)
    k = random_psd(rng, 3, t)
    got = np.asarray(cholesky(jnp.asarray(k, jnp.float32)))
    want = np.linalg.cholesky(k)
    assert got.dtype == np.float32
    # fp32 factor of a well-conditioned K: relative to the factor's scale
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 5e-6 * max(1.0, t / 64), err
    np.testing.assert_array_equal(got, np.tril(got))


@pytest.mark.parametrize("t", CHOL_T)
def test_cholesky_vjp_fp32_vs_fp64_grad(t):
    """The fp32 custom VJP against fp64 ``jax.grad`` through JAX's own
    Cholesky rule, for a cotangent on every lower entry."""
    rng = np.random.default_rng(100 + t)
    k = random_psd(rng, 2, t)
    w = np.tril(rng.standard_normal((t, t)))

    def loss(chol, kk):
        return jnp.sum(chol(kk) * jnp.asarray(w, kk.dtype))

    got = np.asarray(jax.grad(lambda kk: loss(cholesky, kk))(
        jnp.asarray(k, jnp.float32)))
    want = np.asarray(jax.grad(lambda kk: loss(jnp.linalg.cholesky, kk))(
        jnp.asarray(k, jnp.float64)))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, err


@pytest.mark.parametrize("t", [3, 12, 45, 130])
def test_cholesky_vjp_rule_exact_in_fp64(t):
    """In fp64 the analytic rule must reproduce JAX's differentiated
    Cholesky to rounding: K_bar symmetric, equal to grad after
    symmetrization."""
    rng = np.random.default_rng(200 + t)
    k = jnp.asarray(random_psd(rng, 2, t))
    l = jnp.linalg.cholesky(k)
    l_bar = jnp.asarray(np.tril(rng.standard_normal((2, t, t))))
    got = np.asarray(cholesky_bwd_from_l(l, l_bar))
    _, vjp = jax.vjp(jnp.linalg.cholesky, k)
    want = np.asarray(vjp(l_bar)[0])
    want = 0.5 * (want + np.swapaxes(want, -1, -2))
    np.testing.assert_allclose(got, np.swapaxes(got, -1, -2), rtol=0,
                               atol=1e-12 * np.abs(got).max())
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


def _gram_bank_inputs(masked, b=3, t=16, z=2):
    rng = np.random.default_rng(7)
    times = np.sort(rng.uniform(0, 30, (b, t)), -1)
    mask = None
    if masked:
        mask = np.arange(t)[None, :] < np.array([[t], [11], [6]])
    return times, mask


# noise 1e-2 keeps every kernel (the rank-2 cosine one included) well
# enough conditioned for an fp32-vs-fp64 comparison
_GB_NOISE = 1e-2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kernel", sorted(kernels.KERNELS))
def test_chol_gram_bank_forward_vs_fp64(kernel, masked):
    times, mask = _gram_bank_inputs(masked)
    ls = np.array([2.5, 6.0])
    got = np.asarray(gp.chol_gram_bank(
        jnp.asarray(times, jnp.float32), jnp.asarray(ls, jnp.float32),
        mask=None if mask is None else jnp.asarray(mask), kernel=kernel,
        noise=_GB_NOISE, variance=1.3,
    ))
    k64 = np.asarray(kernels.gram_bank(
        jnp.asarray(times), jnp.asarray(ls),
        mask=None if mask is None else jnp.asarray(mask), kernel=kernel,
        noise=_GB_NOISE, variance=1.3,
    ))
    want = np.linalg.cholesky(k64)
    assert np.abs(got - want).max() < 5e-5 * np.abs(want).max()
    if mask is not None:
        # masked rows/cols are identity-padded
        dead = ~mask
        for i in range(mask.shape[0]):
            d = np.flatnonzero(dead[i])
            np.testing.assert_array_equal(
                got[i][:, d, d], np.ones((got.shape[1], d.size), np.float32)
            )


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kernel", sorted(kernels.KERNELS))
def test_chol_gram_bank_grads_vs_fp64(kernel, masked):
    """Lengthscale and per-latent variance gradients through the custom
    VJP (fp32) against fp64 ``jax.grad`` of the composed gram+Cholesky."""
    times, mask = _gram_bank_inputs(masked)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 2, 16, 16))
    mk = None if mask is None else jnp.asarray(mask)

    def loss(ls, var, dtype, fn):
        l = fn(jnp.asarray(times, dtype), ls, var)
        return (jnp.sum(l * jnp.asarray(w, dtype))
                + jnp.sum(jnp.log(jnp.diagonal(l, axis1=-2, axis2=-1))))

    def ours(tt, ls, var):
        return gp.chol_gram_bank(tt, ls, mask=mk, kernel=kernel,
                                 noise=_GB_NOISE, variance=var)

    def composed(tt, ls, var):
        return jnp.linalg.cholesky(kernels.gram_bank(
            tt, ls, mask=mk, kernel=kernel, noise=_GB_NOISE, variance=var))

    ls0, var0 = np.array([2.5, 6.0]), np.array([1.3, 0.7])
    got = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(ls0, jnp.float32), jnp.asarray(var0, jnp.float32),
        jnp.float32, ours)
    want = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(ls0), jnp.asarray(var0), jnp.float64, composed)
    for g, wnt in zip(got, want):
        g, wnt = np.asarray(g), np.asarray(wnt)
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, wnt, rtol=2e-3,
                                   atol=2e-4 * np.abs(wnt).max())


@pytest.mark.parametrize(
    "left_side,lower,transpose_a",
    list(itertools.product([True, False], repeat=3)),
)
def test_solve_triangular_combinations(left_side, lower, transpose_a):
    rng = np.random.default_rng(9)
    t, m = 24, 5
    a = np.linalg.cholesky(random_psd(rng, 2, t))
    if not lower:
        a = np.swapaxes(a, -1, -2)
    b = rng.standard_normal((2, t, m) if left_side else (2, m, t))
    x = np.asarray(solve_triangular(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
        left_side=left_side, lower=lower, transpose_a=transpose_a,
    ))
    op = np.swapaxes(a, -1, -2) if transpose_a else a
    want = (np.linalg.solve(op, b) if left_side
            else np.swapaxes(np.linalg.solve(np.swapaxes(op, -1, -2),
                                             np.swapaxes(b, -1, -2)), -1, -2))
    np.testing.assert_allclose(x, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("t", [1, 7, 45, 128])
def test_logdet_from_chol_vs_slogdet(t):
    rng = np.random.default_rng(t)
    k = random_psd(rng, 4, t)
    l = jnp.asarray(np.linalg.cholesky(k), jnp.float32)
    got = np.asarray(logdet_from_chol(l))
    sign, want = np.linalg.slogdet(k)
    assert np.all(sign > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(slogdet_psd(jnp.asarray(k, jnp.float32))), want,
        rtol=1e-5,
    )


def test_cholesky_gram_conditioning_regime():
    # the reference's actual regime: scaled-RBF gram, T=20, l=1, cond~60
    # (SURVEY.md §6, measured logdet ~ -12.576)
    times = jnp.arange(1.0, 21.0)[None]
    k = kernels.gram_bank(times, jnp.array([1.0]))
    ld = slogdet_psd(jnp.asarray(k, jnp.float32))
    assert abs(float(ld[0, 0]) - (-12.576)) < 1e-2


def test_cholesky_near_singular_probe():
    # generalization of determinant_testing_minimal.py: long lengthscale on a
    # dense grid -> near-singular gram whose raw determinant (~3e-110) is far
    # below fp32 underflow (~1e-38) — the failure mode that forced the
    # reference's fp64 casts; logdet-via-Cholesky stays finite in fp32.
    times = jnp.linspace(0.0, 45.0, 45)[None]
    k = kernels.gram_bank(times, jnp.array([9.0]))
    assert np.linalg.det(np.asarray(k[0, 0])) < 1e-38
    ld = slogdet_psd(jnp.asarray(k, jnp.float32))
    assert np.isfinite(float(ld[0, 0]))
    ld64 = np.linalg.slogdet(np.asarray(k[0, 0]))[1]
    assert abs(float(ld[0, 0]) - ld64) / abs(ld64) < 1e-3


def test_cholesky_custom_vjp_matches_jax_native():
    rng = np.random.default_rng(3)
    k = random_psd(rng, 2, 12)
    k32 = jnp.asarray(k, jnp.float32)

    def loss_custom(k):
        l = cholesky(k)
        return jnp.sum(jnp.log(jnp.diagonal(l, axis1=-2, axis2=-1))) + jnp.sum(
            l * jnp.cos(jnp.arange(12.0, dtype=k.dtype))
        )

    def loss_native(k):
        l = jnp.linalg.cholesky(k)
        return jnp.sum(jnp.log(jnp.diagonal(l, axis1=-2, axis2=-1))) + jnp.sum(
            l * jnp.cos(jnp.arange(12.0, dtype=k.dtype))
        )

    g_custom = jax.grad(loss_custom)(k32)
    g_native = jax.grad(loss_native)(jnp.asarray(k))
    np.testing.assert_allclose(
        np.asarray(g_custom), np.asarray(g_native), rtol=1e-3, atol=1e-4
    )


def test_solve_triangular_roundtrip():
    rng = np.random.default_rng(4)
    k = random_psd(rng, 5, 30)
    l = np.linalg.cholesky(k)
    b = rng.standard_normal((5, 30, 4))
    x = solve_triangular(jnp.asarray(l), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(jnp.einsum("nij,njk->nik",
                                                     jnp.asarray(l), x)),
                               b, atol=1e-8)


def test_logdet_from_chol_masked_padding_contributes_zero():
    times = jnp.arange(10.0)[None]
    mask = jnp.array([[True] * 6 + [False] * 4])
    k_masked = kernels.gram_bank(times, jnp.array([2.0]), mask=mask)
    k_short = kernels.gram_bank(times[:, :6], jnp.array([2.0]))
    ld_m = logdet_from_chol(jnp.linalg.cholesky(k_masked))
    ld_s = logdet_from_chol(jnp.linalg.cholesky(k_short))
    np.testing.assert_allclose(
        np.asarray(ld_m), np.asarray(ld_s), atol=1e-10
    )
