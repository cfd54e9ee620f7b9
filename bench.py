"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: ELBO train steps/sec on one GPU on the reference toy workload
(B=20, T=45, Z=2, irregular masked times — the exact
src/Models/syndata/GP_VAE_syn_data.py configuration, SURVEY.md §6).
``extra`` carries the secondary BASELINE.json metrics (batched
Cholesky+logdet TFLOP/s at T=256/1024) and the other preset workloads,
plus the device (platform, kind, count) and the card's name and power
limit.

Steps are timed device-side (a lax.scan of train steps over pre-staged
batches).  Every timing ends in ``jax.block_until_ready`` on a result that
depends on the full computation; the median of three trials is reported.
The harness refuses to run without a GPU: a CPU number is not a device
number.
"""
from __future__ import annotations

import json
import statistics
import time

import numpy as np


def timed_median(run_once, reps: int, *, outer: int = 3) -> float:
    """Median over ``outer`` trials of (reps executions, then one wait for
    the device) / reps.  ``run_once()`` must return a device array that
    depends on the full computation."""
    import jax

    jax.block_until_ready(run_once())  # warm + settle
    trials = []
    for _ in range(outer):
        t0 = time.perf_counter()
        v = None
        for _ in range(reps):
            v = run_once()
        jax.block_until_ready(v)
        trials.append((time.perf_counter() - t0) / reps)
    return statistics.median(trials)


def _toy_arrays(t: int, batch: int, n_stack: int):
    rng = np.random.default_rng(0)
    x = (rng.random((n_stack, batch, t, 15)) < 0.4).astype(np.float32)
    times = np.sort(rng.uniform(0, 60, (n_stack, batch, t)), -1).astype(
        np.float32
    )
    mask = np.arange(t)[None, None] < rng.integers(
        25, t + 1, (n_stack, batch)
    )[..., None]
    x *= mask[..., None]
    return x, times, mask


def time_train(t: int = 45, batch: int = 20,
               n_stack: int = 256, n_rounds: int = 12,
               verbose: bool = False) -> float:
    """Toy-config train steps/s: ``n_stack`` scanned steps per call,
    ``n_rounds`` calls per timed trial."""
    import jax
    import jax.numpy as jnp
    import optax

    from gpvae_tpu import elbo as elbo_lib
    from gpvae_tpu.models import GPVAE, GPVAEConfig
    from gpvae_tpu.train import TrainConfig, TrainState, create_train_state

    cfg = GPVAEConfig(
        latent_dim=2, obs_dim=15, time_len=t,
        prior="gp", posterior="gp",
        prior_lengthscales=(9.0, 3.0), posterior_lengthscales=(9.0, 3.0),
        encoder="dense", decoder="dense",
    )
    model = GPVAE(cfg)
    x, times, mask = _toy_arrays(t, batch, n_stack)

    batch0 = {"x": x[0], "times": times[0], "mask": mask[0]}
    state, tx = create_train_state(model, batch0, TrainConfig())
    sched = elbo_lib.BetaSchedule()

    def one_step(state, b):
        rng_key, sample_key = jax.random.split(state.rng)
        beta = sched(state.step)

        def loss_fn(params):
            out = model.apply(
                {"params": params}, b["x"], b["times"], b["mask"],
                beta=beta, rngs={"sample": sample_key},
            )
            return out.loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(
            params=optax.apply_updates(state.params, updates),
            opt_state=opt_state, step=state.step + 1, rng=rng_key,
        ), loss

    @jax.jit
    def run_chunk(state, xs):
        state, losses = jax.lax.scan(one_step, state, xs)
        return state, losses[-1]

    stacked = {
        "x": jnp.asarray(x), "times": jnp.asarray(times),
        "mask": jnp.asarray(mask),
    }
    t0 = time.perf_counter()
    state, loss = run_chunk(state, stacked)  # compile + warm
    assert np.isfinite(float(loss)), "non-finite training loss in bench"
    if verbose:
        print(f"[bench] toy B={batch} compile+warm "
              f"{time.perf_counter()-t0:.1f}s", flush=True)

    # the state threads through the chunk; time chunks back-to-back and wait
    # on the returned loss scalar
    box = {"state": state}

    def run_once():
        box["state"], loss = run_chunk(box["state"], stacked)
        return loss

    dt_chunk = timed_median(run_once, n_rounds)
    return n_stack / dt_chunk


def time_train_conv(t: int = 20, batch: int = 5, n_stack: int = 64,
                    n_rounds: int = 8, verbose: bool = False) -> float:
    """MovingMNIST conv config steps/sec (B=5 seqs, T=20, Z=100, shared
    fixed grid — src/Models/Full_GP_VAE_fixed_for_MovMnist.py workload)."""
    import jax
    import jax.numpy as jnp
    import optax

    from gpvae_tpu import elbo as elbo_lib
    from gpvae_tpu.models import GPVAE, GPVAEConfig
    from gpvae_tpu.train import TrainConfig, TrainState, create_train_state

    cfg = GPVAEConfig(
        latent_dim=100, obs_dim=64 * 64, time_len=t,
        prior="gp", posterior="gp",
        prior_lengthscales=(1.0,), learn_prior_lengthscales=True,
        posterior_lengthscales=(1.0,),
        encoder="conv", decoder="conv", image_shape=(64, 64, 1),
        shared_time_grid=True,
    )
    model = GPVAE(cfg)
    rng = np.random.default_rng(0)
    x = (rng.random((n_stack, batch, t, 64, 64, 1)) < 0.3).astype(np.float32)
    times = np.broadcast_to(
        np.arange(1.0, t + 1.0, dtype=np.float32), (n_stack, batch, t)
    ).copy()
    mask = np.ones((n_stack, batch, t), bool)

    batch0 = {"x": x[0], "times": times[0], "mask": mask[0]}
    state, tx = create_train_state(model, batch0, TrainConfig())
    sched = elbo_lib.BetaSchedule()

    def one_step(state, b):
        rng_key, sample_key = jax.random.split(state.rng)
        beta = sched(state.step)

        def loss_fn(params):
            out = model.apply(
                {"params": params}, b["x"], b["times"], b["mask"],
                beta=beta, rngs={"sample": sample_key},
            )
            return out.loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(
            params=optax.apply_updates(state.params, updates),
            opt_state=opt_state, step=state.step + 1, rng=rng_key,
        ), loss

    @jax.jit
    def run_chunk(state, xs):
        state, losses = jax.lax.scan(one_step, state, xs)
        return state, losses[-1]

    stacked = {
        "x": jnp.asarray(x), "times": jnp.asarray(times),
        "mask": jnp.asarray(mask),
    }
    t0 = time.perf_counter()
    state, loss = run_chunk(state, stacked)
    assert np.isfinite(float(loss)), "non-finite conv training loss"
    if verbose:
        print(f"[bench] conv compile+warm {time.perf_counter()-t0:.1f}s",
              flush=True)
    box = {"state": state}

    def run_once():
        box["state"], loss = run_chunk(box["state"], stacked)
        return loss

    dt_chunk = timed_median(run_once, n_rounds)
    return n_stack / dt_chunk


def time_cholesky(t: int, n: int, reps: int = 6, inner: int | None = None,
                  verbose: bool = False) -> float:
    """Batched Cholesky+logdet TFLOP/s at size t (the BASELINE metric).

    Inputs are RBF grams built on device (the framework's actual workload;
    host-side PSD generation at these sizes costs minutes of numpy matmul).
    The timed iteration is exactly the op, with the factor forced to
    materialize by a barrier and only its O(N*T) log-diagonal consumed.
    The ``optimization_barrier((k, acc))`` chain makes each iteration's
    input data-dependent on the previous result — hoist-, CSE- and
    overlap-proof.
    """
    import jax
    import jax.numpy as jnp
    from gpvae_tpu import kernels as kernels_lib
    from gpvae_tpu.ops import chol_logdet

    if inner is None:
        inner = 256 if t <= 512 else 96
    rng = np.random.default_rng(1)
    times = jnp.asarray(
        np.sort(rng.uniform(0, t, (n, t)), -1).astype(np.float32)
    )
    kd = jax.jit(
        lambda tt: kernels_lib.gram_bank(
            tt, jnp.array([5.0], jnp.float32), noise=1e-2
        )[:, 0]
    )(times)
    jax.block_until_ready(kd)

    @jax.jit
    def run(kd):
        def body(_, acc):
            k, _a = jax.lax.optimization_barrier((kd, acc))
            l, ld = chol_logdet(k)
            # the logdet is the production consume; barrier + an O(T)
            # read force the full factor to materialize
            l = jax.lax.optimization_barrier(l)
            return acc + ld.sum() + jnp.sum(l[..., 0, :1])
        return jax.lax.fori_loop(0, inner, body, jnp.float32(0.0))

    t0 = time.perf_counter()
    jax.block_until_ready(run(kd))
    if verbose:
        print(f"[bench] chol T={t} compile+warm {time.perf_counter()-t0:.1f}s",
              flush=True)
    dt = timed_median(lambda: run(kd), reps) / inner
    return n * (t ** 3) / 3.0 / dt / 1e12


def time_train_t1024(n_stack: int = 64, n_rounds: int = 3,
                     verbose: bool = False,
                     structured: str = "toeplitz") -> float:
    """BASELINE config 3 training throughput: T=1024 uniform shared grid,
    full ELBO + VJP, device-side scan.  ``structured`` picks the prior
    path: "toeplitz" (the ``t1024_toeplitz`` preset / explicit structured
    option) or "dense" (what ``auto`` resolves to)."""
    import jax
    import jax.numpy as jnp
    import optax

    from gpvae_tpu import elbo as elbo_lib
    from gpvae_tpu.models import GPVAE, GPVAEConfig
    from gpvae_tpu.train import TrainConfig, TrainState, create_train_state

    t, batch = 1024, 8
    cfg = GPVAEConfig(
        latent_dim=2, obs_dim=15, time_len=t,
        prior="gp", posterior="gp",
        prior_lengthscales=(9.0, 3.0), posterior_lengthscales=(9.0, 3.0),
        encoder="dense", decoder="dense",
        shared_time_grid=True, structured_prior=structured,
    )
    model = GPVAE(cfg)
    rng = np.random.default_rng(0)
    x = (rng.random((n_stack, batch, t, 15)) < 0.4).astype(np.float32)
    times = np.broadcast_to(
        np.arange(t, dtype=np.float32) * (60.0 / t), (n_stack, batch, t)
    ).copy()
    mask = np.ones((n_stack, batch, t), bool)

    batch0 = {"x": x[0], "times": times[0], "mask": mask[0]}
    state, tx = create_train_state(model, batch0, TrainConfig())
    sched = elbo_lib.BetaSchedule()

    def one_step(state, b):
        rng_key, sample_key = jax.random.split(state.rng)
        beta = sched(state.step)

        def loss_fn(params):
            out = model.apply(
                {"params": params}, b["x"], b["times"], b["mask"],
                beta=beta, rngs={"sample": sample_key},
            )
            return out.loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(
            params=optax.apply_updates(state.params, updates),
            opt_state=opt_state, step=state.step + 1, rng=rng_key,
        ), loss

    @jax.jit
    def run_chunk(state, xs):
        state, losses = jax.lax.scan(one_step, state, xs)
        return state, losses[-1]

    stacked = {
        "x": jnp.asarray(x), "times": jnp.asarray(times),
        "mask": jnp.asarray(mask),
    }
    t0 = time.perf_counter()
    state, loss = run_chunk(state, stacked)
    assert np.isfinite(float(loss)), "non-finite t1024 training loss"
    if verbose:
        print(f"[bench] t1024 compile+warm {time.perf_counter()-t0:.1f}s",
              flush=True)
    box = {"state": state}

    def run_once():
        box["state"], loss = run_chunk(box["state"], stacked)
        return loss

    dt_chunk = timed_median(run_once, n_rounds)
    return n_stack / dt_chunk


def time_toeplitz_kl(t: int = 1024, b: int = 8, z: int = 2,
                     reps: int = 4, inner: int = 128,
                     verbose: bool = False) -> dict:
    """Structured-prior KL vs dense-prior KL on a uniform grid (BASELINE
    config 3): one Durbin scan + GS-inverse FFT applications vs a dense
    prior factorization.  Returns ms for both paths.

    Both arms take the prior lengthscales and times as traced,
    barrier-chained arguments: closed over as constants, the dense arm's
    factorization, trace and logdet terms would fold at compile time."""
    import jax
    import jax.numpy as jnp
    from gpvae_tpu import gp, kernels

    rng = np.random.default_rng(0)
    times = jnp.broadcast_to(
        jnp.arange(t, dtype=jnp.float32) * (60.0 / t), (b, t)
    )
    mu = jnp.asarray(rng.standard_normal((b, t, z)), jnp.float32)
    ls_q = jnp.asarray([5.0, 2.0], jnp.float32)[:z]
    ls_p = jnp.asarray([9.0, 3.0], jnp.float32)[:z]
    l_q = gp.chol_gram_bank(times[:1], ls_q)  # shared posterior factor

    @jax.jit
    def dense(times, ls_p, mu):
        def body(_, acc):
            tt, ls, m_, _a = jax.lax.optimization_barrier(
                (times, ls_p, mu, acc)
            )
            l_p = gp.chol_gram_bank(tt[:1], ls)
            return acc + jnp.sum(gp.gp_kl(m_, l_q, l_p))
        return jax.lax.fori_loop(0, inner, body, jnp.float32(0.0))

    @jax.jit
    def toep(times, ls_p, mu):
        def body(_, acc):
            tt, ls, m_, _a = jax.lax.optimization_barrier(
                (times, ls_p, mu, acc)
            )
            row = kernels.toeplitz_row(t, tt[0, 1] - tt[0, 0], ls)
            return acc + jnp.sum(gp.gp_kl_toeplitz_prior(m_, l_q, row))
        return jax.lax.fori_loop(0, inner, body, jnp.float32(0.0))

    jax.block_until_ready((dense(times, ls_p, mu), toep(times, ls_p, mu)))
    dt_dense = timed_median(lambda: dense(times, ls_p, mu), reps) / inner
    dt_toep = timed_median(lambda: toep(times, ls_p, mu), reps) / inner
    if verbose:
        print(f"[bench] toeplitz KL T={t}: dense={dt_dense*1e3:.2f}ms "
              f"toeplitz={dt_toep*1e3:.2f}ms", flush=True)
    return {"dense_ms": dt_dense * 1e3, "toeplitz_ms": dt_toep * 1e3}


def time_sparse_t4096(n_stack: int = 64, n_rounds: int = 4,
                      kl_inner: int = 128, kl_reps: int = 4,
                      verbose: bool = False) -> dict:
    """BASELINE config 4 evidence: the ``sparse_t4096`` preset shape
    (B=8, T=4096, Z=8, FITC m=64 inducing points, diag posterior) —
    training steps/s (full ELBO + VJP, device-side scan) and the FITC
    prior-KL forward in ms (barrier-chained fori_loop)."""
    import jax
    import jax.numpy as jnp
    import optax

    from gpvae_tpu import configs, elbo as elbo_lib, sparse
    from gpvae_tpu.models import GPVAE
    from gpvae_tpu.train import TrainConfig, TrainState, create_train_state

    preset = configs.get("sparse_t4096")
    cfg = preset.model
    t, batch, z = cfg.time_len, preset.batch_size, cfg.latent_dim
    model = GPVAE(cfg)
    rng = np.random.default_rng(0)
    x = (rng.random((n_stack, batch, t, 15)) < 0.4).astype(np.float32)
    times = np.broadcast_to(
        np.arange(t, dtype=np.float32), (n_stack, batch, t)
    ).copy()
    mask = np.ones((n_stack, batch, t), bool)

    batch0 = {"x": x[0], "times": times[0], "mask": mask[0]}
    state, tx = create_train_state(model, batch0, TrainConfig())
    sched = elbo_lib.BetaSchedule()

    def one_step(state, b):
        rng_key, sample_key = jax.random.split(state.rng)
        beta = sched(state.step)

        def loss_fn(params):
            out = model.apply(
                {"params": params}, b["x"], b["times"], b["mask"],
                beta=beta, rngs={"sample": sample_key},
            )
            return out.loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(
            params=optax.apply_updates(state.params, updates),
            opt_state=opt_state, step=state.step + 1, rng=rng_key,
        ), loss

    @jax.jit
    def run_chunk(state, xs):
        state, losses = jax.lax.scan(one_step, state, xs)
        return state, losses[-1]

    stacked = {
        "x": jnp.asarray(x), "times": jnp.asarray(times),
        "mask": jnp.asarray(mask),
    }
    t0 = time.perf_counter()
    state, loss = run_chunk(state, stacked)
    assert np.isfinite(float(loss)), "non-finite sparse_t4096 training loss"
    if verbose:
        print(f"[bench] sparse_t4096 compile+warm "
              f"{time.perf_counter()-t0:.1f}s", flush=True)
    box = {"state": state}

    def run_once():
        box["state"], loss = run_chunk(box["state"], stacked)
        return loss

    dt_chunk = timed_median(run_once, n_rounds)
    steps_per_sec = n_stack / dt_chunk

    # FITC prior-KL forward, barrier-chained saturated loop.  Every array
    # operand (times, inducing grid, lengthscales, log-var, mu) is traced
    # AND barrier-chained: closing over any of them as jit constants lets
    # XLA hoist the mu-independent FITC work (Kuu cholesky, whitening,
    # B factor, logdet/trace terms — the dominant cost) out of the loop.
    tt = jnp.asarray(times[0])
    mu = jnp.asarray(rng.standard_normal((batch, t, z)), jnp.float32)
    log_var = jnp.zeros((batch, t, z), jnp.float32)
    ls = jnp.full((z,), float(cfg.prior_lengthscales[0]), jnp.float32)
    s_times = jnp.linspace(*cfg.inducing_time_range, cfg.num_inducing)

    @jax.jit
    def kl_run(mu, log_var, tt, s_times, ls):
        def body(_, acc):
            m_, lv, tt_, st, ls_, _a = jax.lax.optimization_barrier(
                (mu, log_var, tt, s_times, ls, acc)
            )
            kl = sparse.fitc_diag_kl(
                m_, lv, tt_, st, ls_, kernel=cfg.kernel,
                noise=cfg.noise,
            )
            return acc + jnp.sum(kl)
        return jax.lax.fori_loop(0, kl_inner, body, jnp.float32(0.0))

    jax.block_until_ready(kl_run(mu, log_var, tt, s_times, ls))
    dt_kl = timed_median(
        lambda: kl_run(mu, log_var, tt, s_times, ls), kl_reps
    ) / kl_inner
    if verbose:
        print(f"[bench] sparse_t4096: {steps_per_sec:.1f} steps/s, "
              f"KL {dt_kl*1e3:.3f} ms", flush=True)
    return {"steps_per_sec": steps_per_sec, "fitc_kl_ms": dt_kl * 1e3}


def main(verbose: bool = False):
    import jax

    from gpvae_tpu.utils import card_info, enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    card = card_info()
    # any failing phase raises: the exit code is non-zero and no JSON
    # line is printed
    sps = time_train(verbose=verbose)
    sps_256 = time_train(batch=256, n_stack=64, n_rounds=8, verbose=verbose)
    sps_conv = time_train_conv(verbose=verbose)
    sps_t1024 = time_train_t1024(verbose=verbose)
    sps_t1024_dense = time_train_t1024(verbose=verbose, structured="dense")
    tflops_256 = time_cholesky(256, 512, reps=6, verbose=verbose)
    tflops_1024 = time_cholesky(1024, 128, reps=4, verbose=verbose)
    toep = time_toeplitz_kl(verbose=verbose)
    sp4096 = time_sparse_t4096(verbose=verbose)

    def r(x, nd=2):
        return round(x, nd)

    out = {
        "metric": "ELBO train steps/sec (toy config B=20,T=45,Z=2)",
        "value": r(sps),
        "unit": "steps/sec",
        "extra": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "scaled_B256_steps_per_sec": r(sps_256),
            "mnist_conv_steps_per_sec": r(sps_conv),
            "t1024_toeplitz_steps_per_sec": r(sps_t1024),
            "t1024_dense_steps_per_sec": r(sps_t1024_dense),
            "chol_logdet_tflops_T256_N512": r(tflops_256, 4),
            "chol_logdet_tflops_T1024_N128": r(tflops_1024, 4),
            "toeplitz_prior_kl_T1024_ms": r(toep["toeplitz_ms"]),
            "dense_prior_kl_T1024_ms": r(toep["dense_ms"]),
            "sparse_t4096_steps_per_sec": r(sp4096["steps_per_sec"]),
            "sparse_t4096_fitc_kl_ms": r(sp4096["fitc_kl_ms"], 3),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    import sys

    main(verbose="-v" in sys.argv)
