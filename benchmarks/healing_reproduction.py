"""Healing-MNIST training reproduction (BASELINE config 2 evidence,
VERDICT r3 #6b).

Trains the ``healing_mnist`` preset — Z=64, T=10, 28x28 frames, Cauchy
kernel, per-pixel missing-feature masks — for ``--steps`` steps on
synthetic healing sequences (data/healing.py; the MNIST digits file is not
distributable, the rotating-sprite generator keeps the same corruption
process and temporal structure), then scores missing-pixel imputation on a
held-out split against the marginal-rate baseline
(analysis.pixel_imputation_metrics).

Run: python benchmarks/healing_reproduction.py --out chiprun_out/healing
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--num-seqs", type=int, default=4096)
    ap.add_argument("--num-test", type=int, default=512)
    ap.add_argument("--missing", type=float, default=0.5)
    ap.add_argument("--out", default="/tmp/healing_repro")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from gpvae_tpu import analysis, configs
    from gpvae_tpu import train as train_lib
    from gpvae_tpu.data import Batcher, make_healing_batch
    from gpvae_tpu.models import GPVAE

    os.makedirs(args.out, exist_ok=True)
    preset = configs.get("healing_mnist")
    model = GPVAE(preset.model)
    t = preset.model.time_len

    print(f"backend: {jax.default_backend()}; generating "
          f"{args.num_seqs + args.num_test} sequences...", flush=True)
    batch = make_healing_batch(
        args.num_seqs + args.num_test, t=t, size=28,
        missing_fraction=args.missing, seed=args.seed,
    )
    train_arrays = {
        k: batch[k][: args.num_seqs]
        for k in ("x", "times", "mask", "feature_mask")
    }
    test_batch = {k: v[args.num_seqs:] for k, v in batch.items()}

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

    metrics = analysis.pixel_imputation_metrics(
        model, state.params, test_batch, key=jax.random.key(1),
    )
    rows = log.rows
    losses = [r["loss"] for r in rows]
    summary = {
        "preset": "healing_mnist",
        "steps": int(state.step),
        "wall_seconds": round(wall, 1),
        "steps_per_sec_wall": round(int(state.step) / wall, 1),
        "first_logged": rows[0] if rows else None,
        "last_logged": rows[-1] if rows else None,
        "loss_finite": bool(np.isfinite(losses).all()),
        "missing_fraction": args.missing,
        "test_pixel_imputation": metrics,
        "beats_marginal_baseline": bool(
            metrics["nll_model"] < metrics["nll_marginal_baseline"]
            and metrics["mse_model"] < metrics["mse_marginal_baseline"]
        ),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    print(json.dumps(summary, default=str))


if __name__ == "__main__":
    main()
