#!/usr/bin/env python3
"""Run gpvae_tpu's training path on one GPU and check what comes out.

    python chip_smoke.py            # one card: op parity + three presets
    python chip_smoke.py --chips 4  # only the data-parallel step, 4 vs 1 card

One card, four phases, each raising on failure:

1. the covariance ops at real widths against fp64 numpy/CPU oracles
   (Cholesky factor, ``gp.gp_kl``, the gram-bank lengthscale gradient,
   the Toeplitz prior KL, the FITC KL at the ``sparse_t4096`` shape);
2. ``syn_data`` through ``train.fit`` (device-resident path), its first
   loss against ``utils.reference_math.fp64_elbo``, then checkpoint,
   restore and resume;
3. ``full_gp_dynamic`` at its published width through ``train.fit``, its
   loss against the same program on the host CPU;
4. ``t1024_toeplitz`` through ``train.fit`` with the Toeplitz and the dense
   prior.

``--chips 4`` runs only ``dp_scale`` at its published global batch (4096
sequences x T=1024): one ``make_parallel_train_step`` step on a 4-card
mesh, and its loss, gradients and updated parameters against
``train.make_train_step`` on the same batch on one card.

Every phase prints its compile seconds, its time per step or per call and
each error beside its tolerance.  Exits non-zero, with no result line,
when JAX finds no GPU, when the package is not beside this script, or when
a check fails.  The last line of stdout is the result JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import numpy as np

NOISE = 1e-3  # kernels.DEFAULT_NOISE, the presets' noise


class SmokeFailure(RuntimeError):
    pass


def check(label: str, err: float, tol: float) -> None:
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"  {label}: {err:.3e} (tolerance {tol:.1e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{label}: {err:.3e} > {tol:.1e}")


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def timed(fn, *args, reps: int = 5):
    """(result, compile+first-call seconds, steady ms per call)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return out, first, (time.perf_counter() - t0) / reps * 1e3


def np_rbf_bank(times, ls, mask=None, noise=NOISE):
    """fp64 ``kernels.gram_bank`` for the RBF kernel: [B, Z, T, T]."""
    t = times.shape[-1]
    dt = times[:, None, :, None] - times[:, None, None, :]
    k = np.exp(-dt ** 2 / (2.0 * np.asarray(ls)[None, :, None, None] ** 2))
    k = (1.0 - noise) * k + noise * np.eye(t)
    if mask is not None:
        m = mask.astype(np.float64)[:, None, :]
        k = k * (m[..., :, None] * m[..., None, :]) + (
            1.0 - m[..., :, None]) * np.eye(t)
    return k


def np_gp_kl(mu, kq, kp):
    """fp64 explicit-solve KL(N(mu, Kq) || N(0, Kp)) -> [B, Z]."""
    b, t, z = mu.shape
    out = np.zeros((b, z))
    for i in range(b):
        for j in range(z):
            kpi = kp[min(i, kp.shape[0] - 1), j]
            kqi = kq[min(i, kq.shape[0] - 1), j]
            m = mu[i, :, j]
            out[i, j] = 0.5 * (
                np.trace(np.linalg.solve(kpi, kqi))
                + m @ np.linalg.solve(kpi, m) - t
                + np.linalg.slogdet(kpi)[1] - np.linalg.slogdet(kqi)[1]
            )
    return out


def np_fitc_diag_kl(mu, log_var, times, s_times, ls, noise, jitter):
    """fp64 FITC KL in the plain (non-whitened) Woodbury form:
    KL(N(mu, diag v) || N(0, Q + D)), Q = K_ts K_ss^-1 K_st."""
    b, t, z = mu.shape
    m = s_times.shape[0]
    out = np.zeros((b, z))

    def k(a, c, l):
        return (1.0 - noise) * np.exp(
            -(a[:, None] - c[None, :]) ** 2 / (2.0 * l * l))

    for j in range(z):
        k_ss = k(s_times, s_times, ls[j]) + jitter * np.eye(m)
        for i in range(b):
            k_ts = k(times[i], s_times, ls[j])
            q_diag = np.einsum("tm,tm->t", k_ts,
                               np.linalg.solve(k_ss, k_ts.T).T)
            d = np.maximum((1.0 - noise) - q_diag, 0.0) + noise
            a = k_ss + (k_ts.T / d) @ k_ts
            v = np.exp(log_var[i, :, j])
            mu_i = mu[i, :, j]
            u = k_ts.T @ (mu_i / d)
            quad = np.sum(mu_i ** 2 / d) - u @ np.linalg.solve(a, u)
            c = np.linalg.solve(a, (k_ts / d[:, None]).T)  # [m, T]
            tr = np.sum(v / d) - np.sum(v * np.einsum(
                "tm,mt->t", k_ts / d[:, None], c))
            ld = (np.linalg.slogdet(a)[1] - np.linalg.slogdet(k_ss)[1]
                  + np.sum(np.log(d)))
            out[i, j] = 0.5 * (tr + quad - t + ld - np.sum(log_var[i, :, j]))
    return out


# ---------------------------------------------------------------------------
# Phase 1: op parity
# ---------------------------------------------------------------------------

def phase_ops(cpu, *, t_long=1024, b_long=8, t_sparse=4096):
    import jax
    import jax.numpy as jnp

    from gpvae_tpu import configs, gp, kernels, sparse

    print("phase 1: covariance ops vs fp64 oracles", flush=True)
    rng = np.random.default_rng(0)
    f32 = jnp.float32
    ls_p, ls_q = np.array([9.0, 3.0]), np.array([5.0, 2.0])

    def kl_fn(mu, tt, mk, lsq, lsp):
        l_q = gp.chol_gram_bank(tt, lsq, mask=mk, noise=NOISE)
        l_p = gp.chol_gram_bank(tt, lsp, mask=mk, noise=NOISE)
        return gp.gp_kl(mu, l_q, l_p, mk)

    bank = jax.jit(lambda tt, ls, mk: gp.chol_gram_bank(
        tt, ls, mask=mk, noise=NOISE))
    kl_jit = jax.jit(kl_fn)
    kl_grad = jax.jit(jax.grad(lambda lsq, mu, tt, mk, lsp: jnp.sum(
        kl_fn(mu, tt, mk, lsq, lsp))))

    def cpu_kl_grad64(mu, tt, mk, lsq, lsp):
        """fp64 jax.grad on the CPU through JAX's own Cholesky rule."""
        def loss(lsq, mu, tt, lsp):
            mk_ = None if mk is None else jnp.asarray(mk)
            kq = kernels.gram_bank(tt, lsq, mask=mk_, noise=NOISE)
            kp = kernels.gram_bank(tt, lsp, mask=mk_, noise=NOISE)
            return jnp.sum(gp.gp_kl(mu, jnp.linalg.cholesky(kq),
                                    jnp.linalg.cholesky(kp), mk_))

        with jax.enable_x64(True), jax.default_device(cpu):
            args = [jnp.asarray(a, jnp.float64) for a in (lsq, mu, tt, lsp)]
            return np.asarray(jax.jit(jax.grad(loss))(*args))

    shapes = [
        # toy bank: B=20, T=45, Z=2, irregular masked times.  cond(K_p)
        # reaches 1.9e4 here, so the KL's trace term tr(K_p^-1 K_q) may
        # carry up to cond * u = 1.2e-3 of fp32 error (1.04e-4 measured on
        # a CPU, just over the 1e-4 first tried)
        ("toy T=45 B=20", 20, 45, True, 5e-5, "abs", 3e-4, 1e-4),
        # presets' long uniform grid: cond(K) ~ 3.5e5 at noise 1e-3, so an
        # fp32 factor carries ~sqrt(cond) * T * u of forward error
        # (1.6e-4 measured on a CPU) and the KL's trace term up to
        # cond * u; the gradient band is the measured one at this noise
        (f"T={t_long} N={2 * b_long}", b_long, t_long, False, 1e-3, "rel",
         1e-3, 3.1e-3),
    ]
    for label, b, t, masked, tol_l, kind, tol_kl, tol_g in shapes:
        if masked:
            times = np.sort(rng.uniform(0, 60, (b, t)), -1)
            mask = np.arange(t)[None] < rng.integers(25, t + 1, b)[:, None]
        else:
            times = np.broadcast_to(np.linspace(0, 60, t), (b, t)).copy()
            mask = None
        mu = rng.standard_normal((b, t, 2))
        if mask is not None:
            mu *= mask[..., None]
        tj = jnp.asarray(times, f32)
        mj = None if mask is None else jnp.asarray(mask)
        l, c_s, ms = timed(bank, tj, jnp.asarray(ls_p, f32), mj)
        k64 = np_rbf_bank(times.astype(np.float32).astype(np.float64), ls_p,
                          mask)
        l64 = np.linalg.cholesky(k64)
        print(f" {label}: gram+Cholesky compile {c_s:.2f} s, {ms:.3f} ms",
              flush=True)
        err = (float(np.abs(np.asarray(l, np.float64) - l64).max())
               if kind == "abs" else rel_err(l, l64))
        check(f"{label} Cholesky factor vs fp64 ({kind})", err, tol_l)

        kl, c_s, ms = timed(kl_jit, jnp.asarray(mu, f32), tj, mj,
                            jnp.asarray(ls_q, f32), jnp.asarray(ls_p, f32))
        kq64 = np_rbf_bank(times.astype(np.float32).astype(np.float64),
                           ls_q, mask)
        kl64 = np_gp_kl(mu.astype(np.float32).astype(np.float64), kq64, k64)
        print(f" {label}: gp_kl (2 banks + KL) compile {c_s:.2f} s, "
              f"{ms:.3f} ms", flush=True)
        check(f"{label} gp_kl vs fp64 (rel)", rel_err(kl, kl64), tol_kl)

        g, c_s, ms = timed(kl_grad, jnp.asarray(ls_q, f32),
                           jnp.asarray(mu, f32), tj, mj,
                           jnp.asarray(ls_p, f32))
        g64 = cpu_kl_grad64(mu.astype(np.float32), times.astype(np.float32),
                            mask, ls_q, ls_p)
        print(f" {label}: d KL / d lengthscale (custom VJP) compile "
              f"{c_s:.2f} s, {ms:.3f} ms", flush=True)
        check(f"{label} lengthscale gradient vs fp64 jax.grad (rel)",
              rel_err(g, g64), tol_g)

    # Toeplitz prior KL vs the dense prior KL on the uniform grid
    t, b = t_long, b_long
    times = np.broadcast_to(np.linspace(0, 60, t), (b, t)).astype(np.float32)
    mu = jnp.asarray(rng.standard_normal((b, t, 2)), f32)

    @jax.jit
    def toep_vs_dense(mu, tt, lsq, lsp):
        l_q = gp.chol_gram_bank(tt[:1], lsq, noise=NOISE)
        row = kernels.toeplitz_row(t, tt[0, 1] - tt[0, 0], lsp, noise=NOISE)
        dense = gp.gp_kl(mu, l_q, gp.chol_gram_bank(tt[:1], lsp,
                                                     noise=NOISE))
        return gp.gp_kl_toeplitz_prior(mu, l_q, row), dense

    (kt, kd), c_s, ms = timed(toep_vs_dense, mu, jnp.asarray(times),
                              jnp.asarray(ls_q, f32), jnp.asarray(ls_p, f32))
    print(f" T={t}: Toeplitz + dense prior KL compile {c_s:.2f} s, "
          f"{ms:.3f} ms", flush=True)
    check(f"T={t} Toeplitz prior KL vs dense gp_kl (rel)", rel_err(kt, kd),
          1e-3)

    # FITC at the sparse_t4096 shape
    cfg = configs.get("sparse_t4096").model
    b, z = configs.get("sparse_t4096").batch_size, cfg.latent_dim
    t = t_sparse
    times = np.broadcast_to(np.arange(t, dtype=np.float32), (b, t))
    s_times = np.linspace(0.0, float(t), cfg.num_inducing)
    mu = rng.standard_normal((b, t, z)).astype(np.float32)
    log_var = (0.3 * rng.standard_normal((b, t, z)) - 1.0).astype(np.float32)
    ls = np.full((z,), cfg.prior_lengthscales[0])
    jitter = 1e-4  # sparse's fp32 default, passed to the oracle too
    fitc = jax.jit(lambda mu, lv, tt, st, ls: sparse.fitc_diag_kl(
        mu, lv, tt, st, ls, noise=cfg.noise, jitter=jitter))
    kf, c_s, ms = timed(fitc, jnp.asarray(mu), jnp.asarray(log_var),
                        jnp.asarray(times), jnp.asarray(s_times, f32),
                        jnp.asarray(ls, f32))
    kf64 = np_fitc_diag_kl(mu.astype(np.float64), log_var.astype(np.float64),
                           times.astype(np.float64),
                           s_times.astype(np.float32).astype(np.float64),
                           ls, cfg.noise, jitter)
    print(f" sparse_t4096 B={b} T={t} Z={z} m={cfg.num_inducing}: "
          f"fitc_diag_kl compile {c_s:.2f} s, {ms:.3f} ms", flush=True)
    check("FITC KL vs fp64 Woodbury oracle (rel)", rel_err(kf, kf64), 1e-4)


# ---------------------------------------------------------------------------
# Phases 2-4: presets through train.fit
# ---------------------------------------------------------------------------

def fit_report(label, model, batcher, train_cfg, state=None):
    """train.fit with one log row per call: row 0 holds the compile."""
    from gpvae_tpu import train as train_lib

    k = train_cfg.resolved_steps_per_call(device_resident=True)
    train_cfg = dataclasses.replace(train_cfg, log_every=k)
    t0 = time.perf_counter()
    state, log = train_lib.fit(model, batcher, train_cfg, state=state,
                               verbose=False)
    wall = time.perf_counter() - t0
    losses = np.array([r["loss"] for r in log.rows])
    if not np.all(np.isfinite(losses)):
        raise SmokeFailure(f"{label}: non-finite loss {losses}")
    steady = [r["steps_per_sec"] for r in log.rows[1:]]
    sps = float(np.median(steady)) if steady else float("nan")
    first = k / log.rows[0]["steps_per_sec"]
    compile_s = first - (k / sps if steady else 0.0)
    print(f" {label}: {int(state.step)} steps, k={k} per call, compile "
          f"~{compile_s:.2f} s, {sps:.1f} steps/s steady, fit wall "
          f"{wall:.2f} s, losses {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)
    return state, log


def phase_syn_data(*, num_seqs=2000, steps=1024):
    import jax
    import jax.numpy as jnp

    from gpvae_tpu import configs, train as train_lib
    from gpvae_tpu.data import Batcher, generate_toy_data, toy_to_masked_batch
    from gpvae_tpu.models import GPVAE
    from gpvae_tpu.utils import reference_math

    print("phase 2: syn_data through train.fit", flush=True)
    preset = configs.get("syn_data")
    model = GPVAE(preset.model)
    data = generate_toy_data(jax.random.key(0), num_seqs)
    arrays = toy_to_masked_batch({k: np.asarray(v) for k, v in data.items()})
    batch0 = {k: v[: preset.batch_size] for k, v in arrays.items()}
    cfg = dataclasses.replace(preset.train, num_steps=steps)

    # first-step loss against the fp64 reference math, same params + draw
    state0, _ = train_lib.create_train_state(model, batch0, cfg)
    beta = float(cfg.beta(jnp.asarray(0)))
    apply = jax.jit(lambda p, x, t, m, key: model.apply(
        {"params": p}, x, t, m, beta=beta, rngs={"sample": key}))
    out, c_s, ms = timed(apply, state0.params, jnp.asarray(batch0["x"]),
                         jnp.asarray(batch0["times"]),
                         jnp.asarray(batch0["mask"]), jax.random.key(7))
    ref = reference_math.fp64_elbo(
        state0.params, batch0["x"], batch0["times"], batch0["mask"],
        np.asarray(out.latent_sample[0]), beta,
        prior_lengthscales=preset.model.prior_lengthscales,
        noise=preset.model.noise,
    )
    print(f" forward ELBO compile {c_s:.2f} s, {ms:.3f} ms", flush=True)
    b = batch0["x"].shape[0]
    check("first-step loss vs fp64_elbo (rel)",
          rel_err(out.loss, ref["loss"]), 1e-4)
    check("first-step KL vs fp64 (rel)",
          rel_err(np.sum(np.asarray(out.kl)), ref["kl"]), 1e-4)
    check("first-step NLL vs fp64 (rel)",
          rel_err(np.mean(np.asarray(out.nll)) * b, ref["nll"]), 1e-4)

    batcher = Batcher(arrays, preset.batch_size, seed=0)
    state, _ = fit_report("syn_data", model, batcher, cfg)
    probe = jax.random.key(11)
    l0 = float(train_lib.eval_step(model, state0.params, batch0, probe,
                                   beta)["loss"])
    l1 = float(train_lib.eval_step(model, state.params, batch0, probe,
                                   beta)["loss"])
    print(f" eval loss on a fixed batch: {l0:.4f} at init -> {l1:.4f} after "
          f"{int(state.step)} steps", flush=True)
    if not l1 < 0.9 * l0:
        raise SmokeFailure(f"syn_data loss did not fall: {l0} -> {l1}")

    with tempfile.TemporaryDirectory() as d:
        half = dataclasses.replace(cfg, num_steps=steps // 2,
                                   checkpoint_dir=d,
                                   checkpoint_every=steps // 4)
        t0 = time.perf_counter()
        s1, _ = train_lib.fit(model, Batcher(arrays, preset.batch_size),
                              half, verbose=False)
        mgr = train_lib.CheckpointManager(d)
        restored = mgr.restore_latest(s1)
        diffs = [float(np.abs(np.asarray(a) - np.asarray(c)).max())
                 for a, c in zip(
                     jax.tree_util.tree_leaves((s1.params, s1.opt_state)),
                     jax.tree_util.tree_leaves((restored.params,
                                                restored.opt_state)))]
        check(f"checkpoint at step {mgr.latest_step()} restore (max abs)",
              max(diffs), 0.0)
        more = dataclasses.replace(half, num_steps=steps // 2 + steps // 4)
        s2, _ = train_lib.fit(model, Batcher(arrays, preset.batch_size),
                              more, verbose=False)
        print(f" checkpoint/resume: saved {mgr.steps()}, resumed to step "
              f"{int(s2.step)} in {time.perf_counter() - t0:.2f} s",
              flush=True)
        if int(s2.step) != more.num_steps or mgr.latest_step() != int(
                s2.step):
            raise SmokeFailure("resume did not continue from the checkpoint")


def phase_conv(cpu, *, num_seqs=40, steps=16):
    import jax
    import jax.numpy as jnp

    from gpvae_tpu import configs, train as train_lib
    from gpvae_tpu.data import MovingMNIST, synthetic_moving_mnist
    from gpvae_tpu.models import GPVAE

    print("phase 3: full_gp_dynamic (64x64x1, T=20, Z=100, B=5)", flush=True)
    preset = configs.get("full_gp_dynamic")
    cfg = preset.model
    model = GPVAE(cfg)
    vids = synthetic_moving_mnist(num_seqs, t=cfg.time_len,
                                  size=cfg.image_shape[0], seed=0)
    ds = MovingMNIST(data=vids, batch_size=preset.batch_size)
    batcher = ds.batchers["train"]
    batch0 = {k: v[: preset.batch_size] for k, v in batcher.arrays.items()}
    state0, _ = train_lib.create_train_state(model, batch0, preset.train)

    def loss(p, x, t, m, key):
        return model.apply({"params": p}, x, t, m, beta=1.0,
                           rngs={"sample": key}).loss

    args = (state0.params, jnp.asarray(batch0["x"]),
            jnp.asarray(batch0["times"], jnp.float32),
            jnp.asarray(batch0["mask"]), jax.random.key(3))
    l_gpu, c_s, ms = timed(jax.jit(loss), *args)
    with jax.default_matmul_precision("highest"):
        l_hi = jax.jit(loss)(*args)
    with jax.default_device(cpu):
        l_cpu = jax.jit(loss)(*jax.device_put(args, cpu))
    print(f" forward loss compile {c_s:.2f} s, {ms:.3f} ms; loss gpu "
          f"{float(l_gpu):.6f} gpu-highest {float(l_hi):.6f} cpu "
          f"{float(l_cpu):.6f}", flush=True)
    # the conv nets run at the backend default, TF32 on the card: 10
    # mantissa bits, unit roundoff 2^-11 = 4.9e-4 per operation; the loss
    # sums 409,600 Bernoulli pixel terms whose rounding errors average out
    check("conv loss, card default vs CPU fp32 (rel)",
          rel_err(l_gpu, l_cpu), 1e-3)
    check("conv loss, card at HIGHEST vs CPU fp32 (rel)",
          rel_err(l_hi, l_cpu), 1e-4)
    train_cfg = dataclasses.replace(preset.train, num_steps=steps)
    fit_report("full_gp_dynamic", model, batcher,
               dataclasses.replace(train_cfg, steps_per_call=steps // 2))


def phase_t1024(*, t=1024, num_seqs=64, steps=8):
    import jax

    from gpvae_tpu import configs
    from gpvae_tpu.data import Batcher, generate_toy_data, toy_to_masked_batch
    from gpvae_tpu.models import GPVAE

    print("phase 4: t1024_toeplitz (T=1024, B=8, Z=2, uniform grid)",
          flush=True)
    preset = configs.get("t1024_toeplitz")
    data = generate_toy_data(jax.random.key(1), num_seqs, t=t,
                             hide_fraction=0.0)
    arrays = toy_to_masked_batch({k: np.asarray(v) for k, v in data.items()})
    for prior in ("toeplitz", "dense"):
        cfg = dataclasses.replace(preset.model, time_len=t,
                                  structured_prior=prior)
        train_cfg = dataclasses.replace(preset.train, num_steps=steps,
                                        steps_per_call=steps // 2)
        fit_report(f"t1024 {prior} prior", GPVAE(cfg),
                   Batcher(arrays, preset.batch_size), train_cfg)


# ---------------------------------------------------------------------------
# --chips 4: dp_scale, one sharded step vs one card
# ---------------------------------------------------------------------------

def phase_data_parallel(n_devices=4, *, global_batch=None, t=None):
    import jax

    from gpvae_tpu import configs, train as train_lib
    from gpvae_tpu.data import generate_toy_data, toy_to_masked_batch
    from gpvae_tpu.models import GPVAE
    from gpvae_tpu.parallel import (
        make_mesh, make_parallel_train_step, replicate, shard_batch,
    )

    preset = configs.get("dp_scale")
    global_batch = global_batch or preset.batch_size
    t = t or preset.model.time_len
    cfg = dataclasses.replace(preset.model, time_len=t)
    print(f"data-parallel: dp_scale global batch {global_batch} x T={t} on "
          f"{n_devices} devices vs 1", flush=True)
    model = GPVAE(cfg)
    data = generate_toy_data(jax.random.key(2), global_batch, t=t,
                             hide_fraction=0.0)
    batch = toy_to_masked_batch({k: np.asarray(v) for k, v in data.items()})
    batch = {k: batch[k] for k in ("x", "times", "mask")}
    mb = sum(v.nbytes for v in batch.values()) / 2 ** 20
    state, tx = train_lib.create_train_state(model, batch, preset.train)

    def run_twice(step, make_args):
        """(outputs of the first call, its seconds, seconds of a second)."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(*make_args()))
        first = time.perf_counter() - t0
        args = make_args()
        t0 = time.perf_counter()
        jax.block_until_ready(step(*args))
        return out, first, time.perf_counter() - t0

    one = jax.devices()[0]
    step1 = train_lib.make_train_step(model, tx, preset.train.beta,
                                      donate=False)
    (s1, m1), c1, dt1 = run_twice(step1, lambda: (
        jax.device_put(state, one),
        jax.device_put(train_lib._device_batch(batch), one)))
    print(f" one device: train step compile+run {c1:.2f} s, step "
          f"{dt1 * 1e3:.1f} ms ({mb:.0f} MiB of inputs)", flush=True)

    mesh = make_mesh(n_devices)
    stepn = make_parallel_train_step(model, tx, preset.train.beta, mesh)
    sharded = shard_batch(train_lib._device_batch(batch), mesh)
    # the parallel step donates its state: hand it a fresh copy each call
    (sn, mn), cn, dtn = run_twice(stepn, lambda: (
        replicate(jax.tree_util.tree_map(lambda a: a.copy(), state), mesh),
        sharded))
    print(f" {n_devices} devices: make_parallel_train_step compile+run "
          f"{cn:.2f} s, step {dtn * 1e3:.1f} ms, step counter "
          f"{int(sn.step)}", flush=True)
    # the shards compute the same per-sequence terms; only the order of
    # the batch-mean and gradient all-reduce sums differs (fp32 rounding
    # ~1e-7 per sum over 4096 sequences)
    check("train-step loss, sharded vs one device (rel)",
          rel_err(mn["loss"], m1["loss"]), 1e-5)
    # Adam's first moment after one step from zero is (1 - b1) * grad, so
    # the two optimizer states carry the two gradients.  The net leaves
    # differ only by the order of the batch sums.  The lengthscale leaf
    # is the one gradient that passes through the T=1024 Cholesky VJP of
    # the shared posterior factor: the batch-summed factor cotangent
    # differs in its last bits between the two programs, and the VJP's
    # triangular solves amplify that by the factor's conditioning
    # (cond(K) ~3.5e5 at noise 1e-3), so it gets the T=1024 gradient band
    # of phase 1.
    errs = {}
    for (path, g_n), g_1 in zip(
            jax.tree_util.tree_flatten_with_path(sn.opt_state[0].mu)[0],
            jax.tree_util.tree_leaves(s1.opt_state[0].mu)):
        errs[jax.tree_util.keystr(path)] = rel_err(g_n, g_1)
    for name, err in errs.items():
        print(f"    {name}: {err:.3e}", flush=True)
    ls_leaves = [n for n in errs if "_log_ls" in n]
    check("net gradients (Adam first moment), sharded vs one device "
          "(max rel per leaf)",
          max(e for n, e in errs.items() if n not in ls_leaves), 1e-4)
    check("lengthscale gradients through the T=1024 Cholesky VJP, sharded "
          "vs one device (rel)",
          max([errs[n] for n in ls_leaves] or [0.0]), 3.1e-3)
    check("updated params, sharded vs one device (max rel per leaf)",
          max(rel_err(a, b) for a, b in zip(
              jax.tree_util.tree_leaves(sn.params),
              jax.tree_util.tree_leaves(s1.params))), 1e-4)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4),
                        help="4: run only the data-parallel check")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"JAX found {len(devices)}", file=sys.stderr)
        return 2

    from gpvae_tpu.utils import card_info, enable_compile_cache

    cache = enable_compile_cache()
    print(card_info(), flush=True)
    print(f"jax {jax.__version__}; {len(devices)} x {devices[0].device_kind}; "
          f"compile cache {cache or 'off'}", flush=True)
    t0 = time.perf_counter()
    if args.chips == 4:
        phase_data_parallel(4)
        count = 4
    else:
        cpu = jax.devices("cpu")[0]
        for phase in (lambda: phase_ops(cpu), phase_syn_data,
                      lambda: phase_conv(cpu), phase_t1024):
            t1 = time.perf_counter()
            phase()
            print(f" phase done in {time.perf_counter() - t1:.1f} s",
                  flush=True)
        count = 1
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
