"""Data layer: toy generator statistics, batcher wrap semantics,
MovingMNIST pipeline contract."""
import jax
import numpy as np

from gpvae_tpu.data import (
    Batcher,
    MovingMNIST,
    generate_toy_data,
    synthetic_moving_mnist,
    toy_to_masked_batch,
)


def test_generate_toy_data_contract():
    data = generate_toy_data(jax.random.key(0), 64)
    x = np.asarray(data["x"])
    mask = np.asarray(data["mask"])
    assert x.shape == (64, 45, 15)
    assert mask.shape == (64, 45)
    # observed entries are exactly {0, 1}; hidden are exactly -1
    assert set(np.unique(x[mask])) <= {0.0, 1.0}
    assert np.all(x[~mask] == -1.0)
    # guard against the degenerate regime (fp32 Cholesky NaN -> all-zero
    # draws): probabilities finite, on-rate in a sane band
    assert np.all(np.isfinite(np.asarray(data["p"])))
    assert 0.1 < x[mask].mean() < 0.9, x[mask].mean()


def test_generate_toy_data_fp32_not_degenerate():
    """The generator is pinned to fp32 (the accelerator regime); its grams (rank-2
    cosine, near-singular RBF) must stay factorizable there — an x64
    fallback would hide a NaN->all-zeros regression."""
    data = generate_toy_data(jax.random.key(3), 32)
    assert np.asarray(data["f"]).dtype == np.float32
    x = np.asarray(data["x"])
    mask = np.asarray(data["mask"])
    assert np.all(np.isfinite(np.asarray(data["f"])))
    assert np.all(np.isfinite(np.asarray(data["p"])))
    assert 0.1 < x[mask].mean() < 0.9, x[mask].mean()
    # probabilities sum to one across the three groups
    p = np.asarray(data["p"])
    np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-6)
    # Poisson(0.7*45) draws WITH replacement: expected distinct fraction
    # 1-exp(-0.7) ~ 0.503 of timesteps hidden
    hidden_frac = (~mask).mean()
    assert 0.35 < hidden_frac < 0.65


def test_toy_latents_match_kernel_statistics():
    # empirical variance of the RBF latent ~ 1.0, cosine latent ~ 0.75
    data = generate_toy_data(jax.random.key(1), 2000)
    f = np.asarray(data["f"])
    assert abs(f[:, 0, :].var() - 1.0) < 0.1
    assert abs(f[:, 1, :].var() - 0.75) < 0.1


def test_toy_to_masked_batch():
    data = generate_toy_data(jax.random.key(2), 16)
    batch = toy_to_masked_batch(
        {k: np.asarray(v) for k, v in data.items()}
    )
    assert batch["x"].shape == (16, 45, 15)
    assert batch["times"].shape == (16, 45)
    assert set(np.unique(batch["x"])) <= {0.0, 1.0}
    # masked positions zeroed
    assert np.all(batch["x"][~batch["mask"]] == 0.0)


def test_batcher_wrap_reshuffles():
    arrays = {"x": np.arange(10)[:, None]}
    b = Batcher(arrays, batch_size=4, seed=0)
    seen = [next(b)["x"] for _ in range(6)]
    assert all(s.shape == (4, 1) for s in seen)
    assert b.steps_per_epoch == 2


def test_batcher_next_indices_stable_across_reshuffle():
    # Regression (round-2 advisor, high): next_indices() used to return a
    # view into the internal order array; a wrap-reshuffle in a later call
    # mutated all previously collected views, so multi-step chunks trained
    # on duplicated batches.  Collect a full chunk of index batches first
    # (as train.fit's sampled path does), then check coverage.
    arrays = {"x": np.arange(10)[:, None]}
    b = Batcher(arrays, batch_size=4, seed=0)
    chunks = [b.next_indices() for _ in range(6)]  # 3 epochs' worth
    flat = np.concatenate(chunks)
    # 6 batches x 4 rows over n=10 must cover most rows, and the collected
    # batches must be what they were when returned (distinct, not all equal)
    assert len(np.unique(flat)) >= 8
    assert not all(np.array_equal(chunks[0], c) for c in chunks[1:])
    # every epoch (2 full batches) covers 8 distinct rows
    for e in range(3):
        epoch = np.concatenate(chunks[2 * e:2 * e + 2])
        assert len(np.unique(epoch)) == 8


def test_moving_mnist_pipeline():
    vids = synthetic_moving_mnist(20, t=6, size=64)
    assert vids.shape == (6, 20, 64, 64)
    ds = MovingMNIST(data=vids, batch_size=4)
    batch = ds.data_batch("train")
    assert batch["x"].shape == (4, 6, 64, 64, 1)
    assert batch["times"].shape == (4, 6)
    assert set(np.unique(batch["x"])) <= {0.0, 1.0}  # binarized
    assert ds.splits["train"]["x"].shape[0] == 16
    assert ds.splits["valid"]["x"].shape[0] == 2
    assert ds.splits["test"]["x"].shape[0] == 2


def test_moving_mnist_shuffled_and_cropped_datasets():
    vids = synthetic_moving_mnist(20, t=6, size=64)
    ds = MovingMNIST(data=vids, batch_size=4)
    ds.make_shuffled_dataset()
    b = ds.data_batch("mixed_train")
    assert b["x"].shape == (4, 6, 64, 64, 1)
    # same pixel mass, destroyed ordering
    assert np.isclose(
        ds.splits["mixed_train"]["x"].sum(), ds.splits["train"]["x"].sum()
    )
    assert not np.array_equal(
        ds.splits["mixed_train"]["x"], ds.splits["train"]["x"]
    )
    ds.make_cropped_dataset()
    b = ds.data_batch("cropped_train")
    assert b["x"].shape == (4, 6, 28, 28, 1)
