"""Sparse FITC T=4096 training reproduction (BASELINE config 4 evidence,
VERDICT r4 missing #2).

The reference's author abandoned a max_time=1000 dense attempt
(src/old/GP_VAE_syn_data.py:226); the FITC path exists to make that regime
tractable.  This script gives config 4 the same evidence class as configs
1-3: a real training run that LEARNS and IMPUTES, not just a throughput
number.

1. Generates long-sequence toy data at T=4096 with the exact reference toy
   observation semantics (0.1-smoothed softmax over two latent GP draws ->
   three groups of five Bernoulli dims, src/gen_data/simulate_toy_data.py:
   41-52) — but the latents come from this framework's O(T log T)
   circulant-embedding sampler (toeplitz.circulant_prior_sample) at
   lengthscales scaled to the grid (256 and 64 steps), since a dense
   [2, 4096, 4096] factorization is exactly what this config avoids.
2. Trains the ``sparse_t4096`` preset (Z=8, diag posterior, m=64 FITC
   prior, O(T m^2) KL) via train.fit's device-resident sampled path.
3. Scores GP-posterior imputation (50% of observed steps dropped) on
   held-out sequences against the N(0,1)-fill baseline
   (analysis.imputation_metrics), chunked — the *scoring* conditional is
   dense [Z, T, T] per sequence, so test sequences go through in pairs.

Run: python benchmarks/sparse_reproduction.py --out chiprun_out/sparse
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def generate_long_toy(key, num_seqs: int, t: int, lengthscales=(256.0, 64.0),
                      hide_fraction: float = 0.5):
    """Reference toy observation model on a long uniform grid, latents via
    circulant embedding (no dense T x T factorization anywhere)."""
    import jax
    import jax.numpy as jnp

    from gpvae_tpu import kernels, toeplitz

    k_f, k_x, k_h = jax.random.split(key, 3)
    ls = jnp.asarray(lengthscales, jnp.float32)
    # unit spacing grid 0..T-1 (matches the preset's inducing_time_range)
    row = kernels.toeplitz_row(t, 1.0, ls, noise=1e-4)  # [2, T]
    f = toeplitz.circulant_prior_sample(k_f, row, num_samples=num_seqs)
    f = f.at[:, 1].mul(jnp.sqrt(0.75))  # second factor var=0.75 (ref :28)

    max_f = jnp.max(f, axis=1, keepdims=True)
    shifted = jnp.exp(f - max_f)
    denom = jnp.sum(0.1 + shifted, axis=1, keepdims=True)
    p01 = shifted / denom
    p2 = 1.0 - p01.sum(axis=1, keepdims=True)
    p = jnp.concatenate([p01, p2], axis=1)          # [N, 3, T]
    probs = p[:, jnp.repeat(jnp.arange(3), 5), :]   # [N, 15, T]
    x = (jax.random.uniform(k_x, probs.shape) < probs).astype(jnp.float32)
    x = jnp.swapaxes(x, 1, 2)                       # [N, T, 15]

    mask = jax.random.uniform(k_h, (num_seqs, t)) >= hide_fraction
    x = x * mask[..., None]
    times = jnp.broadcast_to(
        jnp.arange(t, dtype=jnp.float32), (num_seqs, t)
    )
    return {
        "x": np.asarray(x),
        "times": np.asarray(times),
        "mask": np.asarray(mask),
    }


def chunked_imputation_metrics(model, params, test, *, key, chunk: int = 1,
                               drop_fraction: float = 0.5) -> dict:
    """analysis.imputation_metrics over test sequences in chunks (the
    scoring conditional is dense [Z, T, T]; T=4096 needs small chunks),
    aggregated weighted by dropped-element counts."""
    import jax

    from gpvae_tpu import analysis

    n = test["x"].shape[0]
    keys = jax.random.split(key, (n + chunk - 1) // chunk)
    tot = {"nll_gp_impute": 0.0, "mse_gp_impute": 0.0,
           "nll_baseline": 0.0, "mse_baseline": 0.0}
    w_tot = 0
    for i in range(0, n, chunk):
        sl = slice(i, min(i + chunk, n))
        m = analysis.imputation_metrics(
            model, params,
            test["x"][sl], test["times"][sl], test["mask"][sl],
            key=keys[i // chunk], drop_fraction=drop_fraction,
        )
        w = m["dropped_steps"]
        for k in tot:
            tot[k] += m[k] * w
        w_tot += w
    out = {k: v / max(w_tot, 1) for k, v in tot.items()}
    out["dropped_steps"] = w_tot
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--num-seqs", type=int, default=2048)
    ap.add_argument("--num-test", type=int, default=32)
    ap.add_argument("--out", default="/tmp/sparse_repro")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from gpvae_tpu import configs
    from gpvae_tpu import train as train_lib
    from gpvae_tpu.data import Batcher
    from gpvae_tpu.models import GPVAE

    os.makedirs(args.out, exist_ok=True)
    preset = configs.get("sparse_t4096")
    model = GPVAE(preset.model)
    t = preset.model.time_len

    print(f"backend: {jax.default_backend()}; generating "
          f"{args.num_seqs + args.num_test} sequences at T={t}...",
          flush=True)
    data = generate_long_toy(
        jax.random.key(args.seed), args.num_seqs + args.num_test, t
    )
    train_arrays = {k: v[: args.num_seqs] for k, v in data.items()}
    test = {k: v[args.num_seqs:] for k, v in data.items()}

    train_cfg = dataclasses.replace(
        preset.train, num_steps=args.steps, log_every=500,
        checkpoint_dir=None,
    )
    sampler = Batcher(train_arrays, preset.batch_size, seed=args.seed)

    t0 = time.time()
    state, log = train_lib.fit(
        model, sampler, train_cfg,
        csv_path=os.path.join(args.out, "trajectory.csv"),
        verbose=False,
    )
    wall = time.time() - t0
    print(f"trained {int(state.step)} steps in {wall:.0f}s", flush=True)

    metrics = chunked_imputation_metrics(
        model, state.params, test, key=jax.random.key(args.seed + 1),
    )
    rows = log.rows
    losses = [r["loss"] for r in rows]
    summary = {
        "preset": "sparse_t4096",
        "steps": int(state.step),
        "wall_seconds": round(wall, 1),
        "steps_per_sec_wall": round(int(state.step) / wall, 1),
        "first_logged": rows[0] if rows else None,
        "last_logged": rows[-1] if rows else None,
        "loss_finite": bool(np.isfinite(losses).all()),
        "test_imputation": metrics,
        "beats_baseline": bool(
            metrics["nll_gp_impute"] < metrics["nll_baseline"]
            and metrics["mse_gp_impute"] < metrics["mse_baseline"]
        ),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    print(json.dumps(summary, default=str))


if __name__ == "__main__":
    main()
