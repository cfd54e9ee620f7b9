"""Round-2 fixes: reference pickle ingestion, finite-iterator training,
feature_mask threading through the train loop, recog-sampler noise
independence, prefetcher bounds, and the gram-bank times gradient."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpvae_tpu import elbo as elbo_lib, gp, kernels, train as train_lib
from gpvae_tpu.data import (
    Batcher, generate_toy_data, load_toy_file, make_healing_batch,
    toy_to_masked_batch,
)
from gpvae_tpu.models import GPVAE, GPVAEConfig


# ---------------------------------------------------------------------------
# Reference joblib pickle ingestion (VERDICT r1 missing #4)
# ---------------------------------------------------------------------------

def _reference_style_pickle(path, n=12, t=10):
    """Mimic src/gen_data/simulate_toy_data.py:70-71: a joblib dump of
    {'x': list of [obs_dim, T] sentinel arrays, 'f', 'time', 'p'}."""
    import joblib
    rng = np.random.default_rng(0)
    xs, fs, ps = [], [], []
    grid = np.linspace(0.0, 60.0, t)
    for _ in range(n):
        x = (rng.random((15, t)) < 0.4).astype(np.float64)
        hidden = rng.random(t) < 0.3
        x[:, hidden] = -1.0
        xs.append(x)
        fs.append(rng.standard_normal((2, t)))
        ps.append(rng.random((3, t)))
    joblib.dump({"x": xs, "f": fs, "time": grid, "p": ps}, path)


def test_load_reference_pickle_roundtrip(tmp_path):
    path = str(tmp_path / "toy_data_v3.pkl")
    _reference_style_pickle(path, n=12, t=10)
    data = load_toy_file(path)
    assert data["x"].shape == (12, 15, 10)
    batch = toy_to_masked_batch(data)
    assert batch["x"].shape == (12, 10, 15)
    assert batch["times"].shape == (12, 10)
    assert batch["mask"].dtype == bool
    # hidden timesteps are masked out and zero-filled
    assert np.all(batch["x"][~batch["mask"]] == 0.0)
    assert set(np.unique(batch["x"])) <= {0.0, 1.0}


def test_cli_train_from_reference_pickle(tmp_path, capsys):
    from gpvae_tpu.__main__ import main

    path = str(tmp_path / "toy_data_v3.pkl")
    _reference_style_pickle(path, n=24, t=10)
    main([
        "train", "--preset", "syn_data", "--data", path,
        "--time-len", "10", "--steps", "4", "--log-every", "2",
    ])
    assert "done at step 4" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Train-loop fixes (ADVICE r1)
# ---------------------------------------------------------------------------

def _toy_model_and_batch(num_seqs=8, t=10):
    data = generate_toy_data(jax.random.key(0), num_seqs, t=t)
    batch = toy_to_masked_batch({k: np.asarray(v) for k, v in data.items()})
    cfg = GPVAEConfig(
        latent_dim=2, obs_dim=15, time_len=t,
        prior="gp", posterior="gp",
        prior_lengthscales=(9.0, 3.0), posterior_lengthscales=(9.0, 3.0),
    )
    return GPVAE(cfg), batch


def test_fit_consumes_finite_iterator_exactly():
    """A finite iterator with exactly num_steps batches must complete
    (the loop previously fetched one batch too many and died in
    StopIteration before the final checkpoint/save)."""
    model, batch = _toy_model_and_batch()
    batches = iter([
        {k: v[i % 2 * 4:(i % 2) * 4 + 4] for k, v in batch.items()}
        for i in range(5)
    ])
    config = train_lib.TrainConfig(
        num_steps=5, log_every=100, steps_per_call=1,
    )
    state, _ = train_lib.fit(model, batches, config, verbose=False)
    assert int(state.step) == 5


def test_feature_mask_threads_through_train_step():
    """The healing-MNIST regime: the jitted step must evaluate the NLL only
    on observed pixels (ADVICE r1 medium)."""
    batch = make_healing_batch(4, t=4, size=28, missing_fraction=0.5)
    cfg = GPVAEConfig(
        latent_dim=4, obs_dim=28 * 28, time_len=4,
        prior="gp", posterior="gp", encoder="conv", decoder="conv",
        image_shape=(28, 28, 1),
        prior_lengthscales=(2.0,), posterior_lengthscales=(2.0,),
    )
    model = GPVAE(cfg)
    config = train_lib.TrainConfig(steps_per_call=1)
    state, tx = train_lib.create_train_state(model, batch, config)
    step_fn = train_lib.make_train_step(
        model, tx, elbo_lib.BetaSchedule(), donate=False
    )
    dev = train_lib._device_batch(batch)
    assert "feature_mask" in dev
    _, with_mask = step_fn(state, dev)
    dev_nomask = {k: v for k, v in dev.items() if k != "feature_mask"}
    _, without_mask = step_fn(state, dev_nomask)
    # masking out ~half the pixels must change the NLL (the old loop
    # silently dropped the mask, training on the zero fill)
    assert not np.isclose(
        float(with_mask["nll"]), float(without_mask["nll"])
    )
    assert float(with_mask["nll"]) < float(without_mask["nll"])

    # and the value must equal a direct masked apply with the same key
    rng, sample_key = jax.random.split(state.rng)
    out = model.apply(
        {"params": state.params}, dev["x"], dev["times"], dev["mask"],
        beta=elbo_lib.BetaSchedule()(state.step),
        feature_mask=dev["feature_mask"],
        rngs={"sample": sample_key},
    )
    np.testing.assert_allclose(
        float(with_mask["loss"]), float(out.loss), rtol=1e-6
    )


def test_fit_multistep_carries_feature_mask():
    batch = make_healing_batch(8, t=4, size=28, missing_fraction=0.5)
    cfg = GPVAEConfig(
        latent_dim=2, obs_dim=28 * 28, time_len=4,
        prior="gp", posterior="gp", encoder="conv", decoder="conv",
        image_shape=(28, 28, 1),
        prior_lengthscales=(2.0,), posterior_lengthscales=(2.0,),
    )
    model = GPVAE(cfg)
    train_keys = ("x", "times", "mask", "feature_mask")
    batcher = Batcher({k: batch[k] for k in train_keys}, 4)
    config = train_lib.TrainConfig(num_steps=4, steps_per_call=2,
                                   log_every=2)
    state, log = train_lib.fit(model, iter(batcher), config, verbose=False)
    assert int(state.step) == 4
    assert np.isfinite([r["loss"] for r in log.rows]).all()


def test_auto_steps_per_call_resolution():
    cfg = train_lib.TrainConfig(num_steps=1000)
    # on the CPU test backend auto resolves to 1; explicit values win
    # (the per-platform table is pinned in tests/test_train.py)
    assert cfg.resolved_steps_per_call() == 1
    assert train_lib.TrainConfig(
        num_steps=1000, steps_per_call=7
    ).resolved_steps_per_call() == 7


# ---------------------------------------------------------------------------
# recog_sample noise independence with a shared factor (ADVICE r1)
# ---------------------------------------------------------------------------

def test_recog_sample_shared_factor_distinct_noise():
    key = jax.random.key(0)
    b, z, t = 4, 2, 6
    mu = jnp.zeros((b, t, z))
    log_var = jnp.full((b, t, z), -1.0)
    l_q = jnp.broadcast_to(jnp.eye(t), (1, z, t, t))  # shared leading-1
    out = gp.recog_sample(key, mu, log_var, l_q, num_samples=1)
    assert out.shape == (1, b, t, z)
    flat = np.asarray(out[0]).reshape(b, -1)
    for i in range(b):
        for j in range(i + 1, b):
            assert not np.allclose(flat[i], flat[j]), (
                "sequences received identical latent noise"
            )


# ---------------------------------------------------------------------------
# Native prefetcher bounds (ADVICE r1)
# ---------------------------------------------------------------------------

def test_prefetcher_rejects_batch_larger_than_dataset():
    from gpvae_tpu.data import native

    if not native.have_native():
        pytest.skip("native library unavailable")
    data = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError):
        native.NativePrefetcher(data, batch_size=5)


# ---------------------------------------------------------------------------
# Gram-bank times gradient is real (opt-in)
# ---------------------------------------------------------------------------

def test_chol_gram_bank_times_gradient_matches_unfused():
    times = jnp.asarray(
        np.sort(np.random.default_rng(2).uniform(0, 10, (2, 8)), -1),
        jnp.float32,
    )
    ls = jnp.asarray([3.0, 1.5], jnp.float32)
    var = jnp.asarray(1.0, jnp.float32)

    def fused_sum(tt, diff_times):
        l = gp._chol_gram_bank_p(tt, ls, None, var, "rbf", 1e-3, diff_times)
        return jnp.sum(l * jnp.cos(jnp.arange(l.size).reshape(l.shape)))

    def unfused_sum(tt):
        k = kernels.gram_bank(tt, ls, noise=1e-3, variance=var)
        l = jnp.linalg.cholesky(k)
        return jnp.sum(l * jnp.cos(jnp.arange(l.size).reshape(l.shape)))

    # opt-in: the true times cotangent matches the unfused autodiff
    g_fused = jax.grad(lambda tt: fused_sum(tt, True))(times)
    g_unfused = jax.grad(unfused_sum)(times)
    assert not np.allclose(np.asarray(g_fused), 0.0)
    np.testing.assert_allclose(
        np.asarray(g_fused), np.asarray(g_unfused), rtol=2e-3, atol=2e-4
    )
    # default: explicit zero (documented contract — times are data in
    # every shipped model)
    g_default = jax.grad(lambda tt: fused_sum(tt, False))(times)
    assert np.allclose(np.asarray(g_default), 0.0)
