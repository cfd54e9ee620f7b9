"""Accuracy at the SHIPPED presets' own conditioning (VERDICT r4 weak #4 /
next #6).

Earlier accuracy bands were quoted at bench conditioning (ls=5, noise
1e-2); the presets users actually run are harder: the t1024 presets put
ls=[9, 3] on a 0..60 grid (spacing 0.0586 — the lengthscale spans ~150
grid steps, cond(K) ~ 1/noise ~ 1e3 eigenvalue spread with a long
near-null tail), healing runs a Cauchy kernel, sparse_t4096 an ls=256
RBF over 0..4095.  This script measures, ON THE CHIP, at each preset's
exact grid:

* max Cholesky factor error vs the fp64 oracle,
* KL relative error vs an fp64 re-derivation of the reference formulas
  (explicit inverse + logdet, src/Models/syndata/GP_VAE_syn_data.py:
  216-236, generalized to any kernel in ``_kl64``),
* posterior-lengthscale gradient relative error vs an fp64 central
  difference through the same fp64 KL (h=1e-5 in log-lengthscale:
  truncation O(h^2), fp64 roundoff O(eps/h) ~ 1e-11 relative — the
  difference is therefore chip-fp32 error, not harness error).

Grid semantics match the presets exactly: the toy rows use the real
45-point uniform 0..60 grid with scattered Poisson-style hiding (the
reference's masked subsets of a REGULAR grid, min spacing 1.36 —
NOT sorted uniform draws, whose near-duplicate timestamps are a regime
no preset produces), per src/gen_data/simulate_toy_data.py:31,52-55.

Output: one markdown table (pasted into BASELINE.md) + a JSON line.
"""
from __future__ import annotations

import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


# ---------------------------------------------------------------------------
# fp64 oracles (numpy)
# ---------------------------------------------------------------------------

def _k64(dt, ls, kind):
    if kind == "rbf":
        return np.exp(-(dt ** 2) / (2.0 * ls ** 2))
    if kind == "cauchy":
        z = dt / ls
        return 1.0 / (1.0 + z * z)
    raise ValueError(kind)


def _gram64(times, ls, kind, noise):
    dt = times[:, None] - times[None, :]
    return (1.0 - noise) * _k64(dt, ls, kind) + noise * np.eye(len(times))


def _kl64(times, mask, mu, ls_q, ls_p, kind, noise):
    """Reference KL formulas in fp64 per sequence (ragged mask slicing)."""
    out = []
    for b_ in range(mu.shape[0]):
        m = np.asarray(mask[b_])
        tt = np.asarray(times[b_], np.float64)[m]
        t = len(tt)
        total = 0.0
        for d in range(mu.shape[-1]):
            kq = _gram64(tt, float(ls_q[d]), kind, noise)
            kp = _gram64(tt, float(ls_p[d]), kind, noise)
            kp_inv = np.linalg.inv(kp)
            muv = np.asarray(mu[b_], np.float64)[m][:, d]
            total += 0.5 * (
                np.trace(kp_inv @ kq) - t
                + np.linalg.slogdet(kp)[1] - np.linalg.slogdet(kq)[1]
                + muv @ kp_inv @ muv
            )
        out.append(total)
    return np.asarray(out)


def _grad64(times, mask, mu, ls_q, ls_p, kind, noise, h=1e-5):
    """Central difference d(sum KL)/d(log ls_q) in fp64."""
    g = np.zeros(len(ls_q))
    for d in range(len(ls_q)):
        for s, sign in ((h, 1.0), (-h, -1.0)):
            lsq = np.asarray(ls_q, np.float64).copy()
            lsq[d] = np.exp(np.log(lsq[d]) + s)
            g[d] += sign * _kl64(times, mask, mu, lsq, ls_p, kind, noise).sum()
    return g / (2 * h)


# ---------------------------------------------------------------------------
# device path (fp32 covariance route)
# ---------------------------------------------------------------------------

def _kl_chip(times, mask, mu, ls_q, ls_p, kernel, noise):
    import jax
    import jax.numpy as jnp

    from gpvae_tpu import gp

    @jax.jit
    def f(mu, log_ls_q):
        l_q = gp.chol_gram_bank(
            times, jnp.exp(log_ls_q), mask=mask, kernel=kernel, noise=noise
        )
        l_p = gp.chol_gram_bank(
            times, ls_p, mask=mask, kernel=kernel, noise=noise
        )
        kl = gp.gp_kl(mu, l_q, l_p, mask=mask)
        return jnp.sum(kl), (kl, l_q)

    (tot, (kl, l_q)), grad = jax.value_and_grad(f, argnums=1, has_aux=True)(
        mu, jnp.log(ls_q)
    )
    return np.asarray(kl), np.asarray(l_q), np.asarray(grad)


def run_dense(cfg) -> dict:
    """factor / KL / grad errors for a dense-gram preset row."""
    from gpvae_tpu import kernels as kernels_lib

    noise = cfg.get("noise", 1e-3)
    kl_chip, l_chip, grad_chip = _kl_chip(
        cfg["times"], cfg["mask"], cfg["mu"], cfg["ls_q"], cfg["ls_p"],
        cfg["kernel"], noise,
    )
    # factor error vs fp64 (numpy chol of the fp64 masked gram)
    k = np.asarray(kernels_lib.gram_bank(
        cfg["times"], cfg["ls_q"], mask=cfg["mask"], kernel=cfg["kernel"],
        noise=noise,
    ), np.float64)
    l64 = np.linalg.cholesky(k)
    out = {"factor_err": float(np.abs(l_chip - l64).max())}

    kl64 = _kl64(cfg["times"], cfg["mask"], cfg["mu"],
                 np.asarray(cfg["ls_q"]), np.asarray(cfg["ls_p"]),
                 cfg["kernel"], noise)
    out["kl_rel"] = float(
        np.abs(kl_chip.sum(-1) - kl64).max() / np.abs(kl64).max()
    )
    g64 = _grad64(cfg["times"], cfg["mask"], cfg["mu"],
                  np.asarray(cfg["ls_q"]), np.asarray(cfg["ls_p"]),
                  cfg["kernel"], noise)
    out["grad_rel"] = float(np.abs(grad_chip - g64).max() / np.abs(g64).max())
    return out


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

def _smooth_mu(times, ls, rng, scale=1.0, noise=1e-3):
    """Latent means drawn from the prior GP (fp64 chol), matching what
    trained encoders actually emit — smooth functions of smooth data.
    An iid-random mu instead lies mostly in the gram's near-null space and
    the mu^T K^{-1} mu term gets amplified by 1/noise; that adversarial
    regime is reported separately in BASELINE.md, not as the headline."""
    b, t = times.shape
    z = len(ls)
    mu = np.zeros((b, t, z))
    for d in range(z):
        l64 = np.linalg.cholesky(
            _gram64(np.asarray(times[0], np.float64), float(ls[d]),
                    "rbf", noise)
        )
        mu[:, :, d] = (l64 @ rng.standard_normal((t, b))).T * scale
    return mu.astype(np.float32)

def preset_toy():
    """syn_data: the REAL toy grid — 45 uniform points on 0..60, scattered
    Poisson-with-replacement hiding (simulate_toy_data.py:31,52-55)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    b, t, z = 20, 45, 2
    grid = np.linspace(0.0, 60.0, t).astype(np.float32)
    times = jnp.broadcast_to(jnp.asarray(grid), (b, t))
    keep = np.ones((b, t), bool)
    for i in range(b):
        hide = rng.integers(0, t, size=rng.poisson(0.7 * t))
        keep[i, np.unique(hide)] = False
        keep[i, rng.integers(0, t)] = True  # never fully empty
    mask = jnp.asarray(keep)
    mu = jnp.asarray(
        _smooth_mu(times, [9.0, 3.0], rng) * keep[..., None]
    )
    # ls_q at a representative trained point: the learnable posterior
    # lengthscales hover near the generative [9, 3] (BASELINE.md toy
    # reproduction) — measuring at a large q/p mismatch would inflate the
    # trace term into a regime training never visits.
    return dict(times=times, mask=mask, mu=mu,
                ls_q=jnp.asarray([8.5, 3.2]), ls_p=jnp.asarray([9.0, 3.0]),
                kernel="rbf", name="toy (45-grid, scattered hiding)")


def preset_t1024(noise=1e-3):
    """t1024_toeplitz / dense: shared 0..60 grid, ls=[9,3]."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    b, t, z = 4, 1024, 2
    times = jnp.broadcast_to(
        jnp.linspace(0.0, 60.0, t, dtype=jnp.float32), (b, t)
    )
    mask = jnp.ones((b, t), bool)
    mu = jnp.asarray(_smooth_mu(times, [9.0, 3.0], rng, noise=noise))
    return dict(times=times, mask=mask, mu=mu,
                ls_q=jnp.asarray([8.5, 3.2]), ls_p=jnp.asarray([9.0, 3.0]),
                kernel="rbf", noise=noise,
                name=f"t1024 (0..60 grid, ls=[9,3], noise={noise:g})")


def preset_healing():
    """healing_mnist: T=10 grid 0..9, Cauchy ls=2."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    b, t, z = 16, 10, 4
    times = jnp.broadcast_to(jnp.arange(t, dtype=jnp.float32), (b, t))
    mask = jnp.ones((b, t), bool)
    mu = jnp.asarray(_smooth_mu(times, [2.0] * z, rng))
    # ls_q != ls_p: at ls_q == ls_p the true lengthscale gradient is ~0
    # (trace+logdet stationary point) and a relative error is undefined.
    return dict(times=times, mask=mask, mu=mu,
                ls_q=jnp.asarray([1.6, 2.5, 1.9, 2.2]),
                ls_p=jnp.asarray([2.0, 2.0, 2.0, 2.0]),
                kernel="cauchy", name="healing (T=10, Cauchy ls=2)")


def run_sparse() -> dict:
    """sparse_t4096: FITC m=64 diag-posterior KL + grad vs the dense fp64
    oracle (same 1e-4 jitter the fp32 chip path resolves — the comparison
    isolates precision, not the jitter choice)."""
    import jax
    import jax.numpy as jnp

    from gpvae_tpu import sparse

    rng = np.random.default_rng(3)
    b, t, z = 2, 4096, 1
    jitter = 1e-4
    ls = 256.0
    times = jnp.broadcast_to(
        jnp.arange(t, dtype=jnp.float32), (b, t)
    )
    s = np.linspace(0.0, 4096.0, 64)
    mu = _smooth_mu(times, [ls], rng)
    log_var = (rng.standard_normal((b, t, z)) * 0.3 - 0.5).astype(np.float32)

    @jax.jit
    def f(mu, log_var, log_ls):
        kl = sparse.fitc_diag_kl(
            mu, log_var, times, jnp.asarray(s, jnp.float32),
            jnp.exp(log_ls), jitter=jitter,
        )
        return jnp.sum(kl), kl

    (tot, kl_chip), grad_chip = jax.value_and_grad(
        f, argnums=2, has_aux=True
    )(jnp.asarray(mu), jnp.asarray(log_var), jnp.log(jnp.asarray([ls])))

    def oracle(ls_val):
        from tests.test_sparse import dense_fitc_oracle

        out = np.zeros(b)
        for b_ in range(b):
            for d in range(z):
                out[b_] += dense_fitc_oracle(
                    np.arange(t, dtype=np.float64), s.astype(np.float64),
                    float(ls_val), mu[b_, :, d].astype(np.float64),
                    np.exp(log_var[b_, :, d].astype(np.float64)),
                    jitter=jitter,
                )
        return out

    kl64 = oracle(ls)
    h = 1e-5
    g64 = (oracle(np.exp(np.log(ls) + h)).sum()
           - oracle(np.exp(np.log(ls) - h)).sum()) / (2 * h)
    return {
        "kl_rel": float(
            np.abs(np.asarray(kl_chip).sum(-1) - kl64).max()
            / np.abs(kl64).max()
        ),
        "grad_rel": float(abs(float(grad_chip[0]) - g64) / abs(g64)),
    }


def main():
    rows = {}
    for mk in (preset_toy, preset_t1024, preset_healing):
        cfg = mk()
        rows[cfg["name"]] = run_dense(cfg)
        print(cfg["name"], rows[cfg["name"]], flush=True)
    cfg = preset_t1024(noise=1e-2)
    rows[cfg["name"]] = run_dense(cfg)
    print(cfg["name"], rows[cfg["name"]], flush=True)
    rows["sparse_t4096 (FITC m=64, ls=256)"] = run_sparse()
    print("sparse_t4096 (FITC m=64, ls=256)",
          rows["sparse_t4096 (FITC m=64, ls=256)"], flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
