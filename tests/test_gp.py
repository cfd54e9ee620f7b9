"""GP layer: KL closed forms vs fp64 oracles, properties, sampling stats,
posterior conditioning vs the reference's numpy math."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpvae_tpu import gp, kernels


def rand_chol(rng, shape_t, scale=1.0):
    a = rng.standard_normal(shape_t) * scale
    k = a @ np.swapaxes(a, -1, -2) + shape_t[-1] * np.eye(shape_t[-1])
    return np.linalg.cholesky(k), k


def kl_oracle_full(mu, kq, kp):
    """fp64 closed-form KL(N(mu,Kq)||N(0,Kp)) — the reference gp_kl_div
    formula (src/Models/syndata/GP_VAE_syn_data.py:230-236)."""
    t = kq.shape[-1]
    kp_inv = np.linalg.inv(kp)
    tr = np.trace(kp_inv @ kq)
    quad = mu @ kp_inv @ mu
    ld = np.linalg.slogdet(kp)[1] - np.linalg.slogdet(kq)[1]
    return 0.5 * (tr + quad - t + ld)


def test_gp_kl_vs_oracle():
    rng = np.random.default_rng(0)
    b, z, t = 3, 2, 15
    lq, kq = rand_chol(rng, (b, z, t, t), 0.4)
    lp, kp = rand_chol(rng, (b, z, t, t), 0.6)
    mu = rng.standard_normal((b, t, z))
    got = gp.gp_kl(jnp.asarray(mu), jnp.asarray(lq), jnp.asarray(lp))
    for i in range(b):
        for j in range(z):
            want = kl_oracle_full(mu[i, :, j], kq[i, j], kp[i, j])
            assert abs(float(got[i, j]) - want) < 1e-8 * max(1, abs(want))


@pytest.mark.parametrize("case", ["per_seq", "per_seq_masked", "shared"])
def test_gp_kl_fp32_vs_fp64_oracle(case):
    """The fp32 production KL (gram bank -> Cholesky -> solves) against the
    fp64 explicit-inverse oracle, with per-sequence factors (ragged mask or
    none) or factors shared across the batch (leading dim 1)."""
    rng = np.random.default_rng(11)
    b, z, t = 4, 2, 20
    times = np.sort(rng.uniform(0, 45, (b, t)), -1)
    mask = np.ones((b, t), bool)
    if case == "per_seq_masked":
        mask[1, 13:] = False
        mask[3, 7:] = False
    mu = rng.standard_normal((b, t, z)) * mask[..., None]
    ls_q, ls_p = np.array([4.0, 2.0]), np.array([9.0, 3.0])
    shared_q = shared_p = case == "shared"
    tq = times[:1] if shared_q else times
    tp = times[:1] if shared_p else times
    mk = jnp.asarray(mask) if case == "per_seq_masked" else None
    l_q = gp.chol_gram_bank(jnp.asarray(tq, jnp.float32),
                            jnp.asarray(ls_q, jnp.float32), mask=mk)
    l_p = gp.chol_gram_bank(jnp.asarray(tp, jnp.float32),
                            jnp.asarray(ls_p, jnp.float32), mask=mk)
    got = np.asarray(gp.gp_kl(jnp.asarray(mu, jnp.float32), l_q, l_p, mk))
    assert got.shape == (b, z)
    for i in range(b):
        keep = mask[i]
        for j in range(z):
            ti_q = (tq[0] if shared_q else tq[i])[keep]
            ti_p = (tp[0] if shared_p else tp[i])[keep]
            kq = np.asarray(kernels.gram_bank(
                jnp.asarray(ti_q[None]), jnp.asarray(ls_q[j:j + 1])))[0, 0]
            kp = np.asarray(kernels.gram_bank(
                jnp.asarray(ti_p[None]), jnp.asarray(ls_p[j:j + 1])))[0, 0]
            want = kl_oracle_full(mu[i, keep, j], kq, kp)
            assert abs(got[i, j] - want) <= 1e-4 * max(1.0, abs(want)), (
                case, i, j, got[i, j], want)


def test_gp_kl_properties():
    rng = np.random.default_rng(1)
    l, k = rand_chol(rng, (2, 3, 10, 10))
    mu0 = jnp.zeros((2, 10, 3))
    # KL(p || p) = 0
    same = gp.gp_kl(mu0, jnp.asarray(l), jnp.asarray(l))
    np.testing.assert_allclose(np.asarray(same), 0.0, atol=1e-6)
    # KL >= 0 for arbitrary pairs
    l2, _ = rand_chol(rng, (2, 3, 10, 10), 0.5)
    mu = jnp.asarray(rng.standard_normal((2, 10, 3)))
    kl = gp.gp_kl(mu, jnp.asarray(l2), jnp.asarray(l))
    assert np.all(np.asarray(kl) >= 0)


def test_gp_kl_masked_equals_truncated():
    """The static-shape masked KL must equal the reference's ragged
    per-sequence KL computed on the truncated arrays."""
    rng = np.random.default_rng(2)
    t_full, t_obs, z = 12, 7, 2
    times = jnp.asarray(np.sort(rng.uniform(0, 45, (1, t_full)), -1))
    mask = jnp.asarray((np.arange(t_full) < t_obs)[None])
    ls_q = jnp.array([2.0, 5.0])
    ls_p = jnp.array([9.0, 3.0])
    mu = rng.standard_normal((1, t_full, z))
    mu[:, t_obs:, :] = 0.0
    mu = jnp.asarray(mu)

    kq_m = kernels.gram_bank(times, ls_q, mask=mask)
    kp_m = kernels.gram_bank(times, ls_p, mask=mask)
    kl_masked = gp.gp_kl(
        mu, jnp.linalg.cholesky(kq_m), jnp.linalg.cholesky(kp_m), mask=mask
    )

    kq_s = kernels.gram_bank(times[:, :t_obs], ls_q)
    kp_s = kernels.gram_bank(times[:, :t_obs], ls_p)
    kl_trunc = gp.gp_kl(
        mu[:, :t_obs], jnp.linalg.cholesky(kq_s), jnp.linalg.cholesky(kp_s)
    )
    np.testing.assert_allclose(
        np.asarray(kl_masked), np.asarray(kl_trunc), rtol=1e-10
    )


def test_gp_prior_diag_kl_vs_oracle():
    rng = np.random.default_rng(3)
    b, z, t = 2, 3, 20
    lp, kp = rand_chol(rng, (b, z, t, t), 0.3)
    mu = rng.standard_normal((b, t, z))
    log_var = rng.standard_normal((b, t, z)) * 0.3
    got = gp.gp_prior_diag_kl(
        jnp.asarray(mu), jnp.asarray(log_var), jnp.asarray(lp)
    )
    for i in range(b):
        for j in range(z):
            v = np.exp(log_var[i, :, j])
            kp_inv = np.linalg.inv(kp[i, j])
            want = 0.5 * (
                np.sum(np.diag(kp_inv) * v)
                + mu[i, :, j] @ kp_inv @ mu[i, :, j]
                - t
                + np.linalg.slogdet(kp[i, j])[1]
                - np.sum(np.log(v))
            )
            assert abs(float(got[i, j]) - want) < 1e-8 * max(1, abs(want))


def test_standard_kl_vs_oracle():
    rng = np.random.default_rng(4)
    mu = rng.standard_normal((3, 8, 5))
    log_var = rng.standard_normal((3, 8, 5)) * 0.5
    mask = np.ones((3, 8), bool)
    mask[1, 5:] = False
    got = gp.standard_kl(
        jnp.asarray(mu), jnp.asarray(log_var), jnp.asarray(mask)
    )
    v = np.exp(log_var)
    want = -0.5 * np.sum(
        (1 + log_var - mu ** 2 - v) * mask[..., None], axis=(1, 2)
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10)


def test_recog_gp_kl_vs_oracle():
    rng = np.random.default_rng(5)
    b, z, t = 2, 2, 10
    lq, _ = rand_chol(rng, (b, z, t, t), 0.4)
    mu = rng.standard_normal((b, t, z))
    log_var = rng.standard_normal((b, t, z)) * 0.3
    got = gp.recog_gp_kl(
        jnp.asarray(mu), jnp.asarray(log_var), jnp.asarray(lq)
    )
    for i in range(b):
        for j in range(z):
            c = lq[i, j] + np.diag(np.exp(0.5 * log_var[i, :, j]))
            sig = c @ c.T
            want = 0.5 * (
                np.trace(sig)
                + mu[i, :, j] @ mu[i, :, j]
                - t
                - np.linalg.slogdet(sig)[1]
            )
            assert abs(float(got[i, j]) - want) < 1e-7 * max(1, abs(want))
    assert np.all(np.asarray(got) >= -1e-9)


def test_gp_sample_statistics():
    rng = np.random.default_rng(6)
    t = 6
    lq, kq = rand_chol(rng, (1, 1, t, t), 0.5)
    mu = jnp.asarray(rng.standard_normal((1, t, 1)))
    zs = gp.gp_sample(jax.random.key(0), mu, jnp.asarray(lq), 40000)
    zs = np.asarray(zs)[:, 0, :, 0]
    emp_mean = zs.mean(0)
    emp_cov = np.cov(zs.T)
    np.testing.assert_allclose(emp_mean, np.asarray(mu)[0, :, 0], atol=0.05)
    np.testing.assert_allclose(emp_cov, kq[0, 0], atol=0.15)


def test_chol_gram_bank_grad_matches_unfused():
    rng = np.random.default_rng(7)
    b, t = 2, 9
    times = jnp.asarray(
        np.sort(rng.uniform(0, 45, (b, t)), -1), jnp.float32
    )
    mask = jnp.asarray(np.arange(t)[None, :] < np.array([[7], [9]]))
    ls = jnp.array([3.0, 8.0], jnp.float32)

    def loss_fused(ls):
        l = gp.chol_gram_bank(times, ls, mask=mask)
        return jnp.sum(jnp.log(jnp.diagonal(l, axis1=-2, axis2=-1) ** 2))

    def loss_unfused(ls):
        k = kernels.gram_bank(times, ls, mask=mask)
        l = jnp.linalg.cholesky(k)
        return jnp.sum(jnp.log(jnp.diagonal(l, axis1=-2, axis2=-1) ** 2))

    g1 = jax.grad(loss_fused)(ls)
    g2 = jax.grad(loss_unfused)(ls)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-3)


def test_posterior_conditional_vs_numpy_reference():
    """Oracle re-derivation of sample_given_part_latent
    (src/Models/FullGP_and_GPdecoder_dynamic_time_analysis.py:40-56)."""
    rng = np.random.default_rng(8)
    t_obs, t_all, ls = 8, 12, 3.0
    times_obs = np.sort(rng.uniform(0, 20, t_obs))
    times_all = np.linspace(0, 20, t_all)
    z_obs = rng.standard_normal(t_obs)

    def k_np(a, b):
        dt = a[:, None] - b[None, :]
        return np.exp(-(dt ** 2) / (2 * ls ** 2))

    noise = 1e-3
    jitter = 1e-6
    k_oo = (1 - noise) * k_np(times_obs, times_obs) + (noise + jitter) * np.eye(t_obs)
    k_oa = (1 - noise) * k_np(times_obs, times_all)
    k_aa = (1 - noise) * k_np(times_all, times_all) + noise * np.eye(t_all)
    l = np.linalg.cholesky(k_oo)
    lk = np.linalg.solve(l, k_oa)
    want_mean = lk.T @ np.linalg.solve(l, z_obs)
    want_cov = k_aa - lk.T @ lk

    post = gp.posterior_conditional(
        jnp.asarray(times_obs)[None],
        jnp.asarray(z_obs)[None, :, None],
        jnp.asarray(times_all)[None],
        jnp.array([ls]),
        jitter=jitter,
    )
    got_mean = np.asarray(post.mean)[0, :, 0]
    got_cov = np.asarray(post.cov)[0, 0]
    # cross-gram: note the reference applies (1-noise) scaling inside
    # tf_kernel; our cross_gram does the same via gram without noise term
    np.testing.assert_allclose(got_mean, want_mean, atol=1e-6)
    np.testing.assert_allclose(got_cov, want_cov, atol=1e-6)


def test_posterior_mean_interpolates_observed_points():
    # property: with small noise, the posterior mean at an observed time
    # reproduces the observed value
    # well-separated grid (cond(K) small): with tiny noise the identity is
    # near-exact; an ill-conditioned RBF gram would amplify noise*cond(K)
    rng = np.random.default_rng(9)
    t_obs = 6
    times_obs = np.arange(t_obs) * 2.0
    z_obs = rng.standard_normal(t_obs)
    post = gp.posterior_conditional(
        jnp.asarray(times_obs)[None],
        jnp.asarray(z_obs)[None, :, None],
        jnp.asarray(times_obs)[None],
        jnp.array([1.0]),
        noise=1e-6,
        jitter=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(post.mean)[0, :, 0], z_obs, atol=1e-4
    )


def test_posterior_conditional_masked_matches_dense():
    rng = np.random.default_rng(10)
    t_full, t_obs = 10, 6
    times = np.sort(rng.uniform(0, 20, t_full))
    z = rng.standard_normal((t_full, 1))
    z[t_obs:] = 0
    mask = np.arange(t_full) < t_obs
    tq = np.linspace(0, 20, 8)
    post_m = gp.posterior_conditional(
        jnp.asarray(times)[None],
        jnp.asarray(z)[None],
        jnp.asarray(tq)[None],
        jnp.array([3.0]),
        mask_obs=jnp.asarray(mask)[None],
    )
    post_t = gp.posterior_conditional(
        jnp.asarray(times[:t_obs])[None],
        jnp.asarray(z[:t_obs])[None],
        jnp.asarray(tq)[None],
        jnp.array([3.0]),
    )
    np.testing.assert_allclose(
        np.asarray(post_m.mean), np.asarray(post_t.mean), atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(post_m.cov), np.asarray(post_t.cov), atol=1e-8
    )
