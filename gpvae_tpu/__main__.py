"""Command-line entry point: ``python -m gpvae_tpu <command>``.

The reference has no CLI — every experiment is "edit the constants in this
file and run it" (SURVEY.md §5 config; machine variants are whole-file
copies).  Here the presets in configs.py drive everything:

    python -m gpvae_tpu list-presets
    python -m gpvae_tpu generate-data --out toy.npz --num-seqs 10000
    python -m gpvae_tpu train --preset syn_data --steps 5000 \
        --data toy.npz --ckpt-dir ./ckpt --csv losses.csv
    python -m gpvae_tpu train --preset full_gp_dynamic --num-seqs 64
    python -m gpvae_tpu evaluate --preset syn_data --ckpt-dir ./ckpt --plots out/
    python -m gpvae_tpu bench
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def cmd_list_presets(_args):
    from gpvae_tpu import configs

    for name in sorted(configs.PRESETS):
        p = configs.get(name)
        print(f"{name:20s} batch={p.batch_size:<5d} {p.description}")


def cmd_generate_data(args):
    import jax
    from gpvae_tpu.data import generate_toy_data

    data = generate_toy_data(
        jax.random.key(args.seed), args.num_seqs, t=args.time_len
    )
    np.savez(
        args.out, **{k: np.asarray(v) for k, v in data.items()}
    )
    print(f"wrote {args.num_seqs} sequences to {args.out}")


def _load_batches(args, preset, model_cfg=None):
    """Build (train_batcher, eval_arrays) for the preset's data family.

    ``model_cfg`` carries CLI overrides (--time-len) that must shape the
    generated data; defaults to the preset's model config."""
    model_cfg = model_cfg or preset.model
    batch_size = getattr(args, "batch_size", None) or preset.batch_size
    import jax
    from gpvae_tpu.data import (
        Batcher, MovingMNIST, generate_toy_data, load_toy_file,
        make_healing_batch, synthetic_moving_mnist, toy_to_masked_batch,
    )

    family = preset.resolved_data_family
    if family == "healing":
        # missing-pixel regime: the feature_mask must travel with every
        # batch or the NLL trains the model to predict the zero fill
        batch = make_healing_batch(
            args.num_seqs, t=model_cfg.time_len,
            size=model_cfg.image_shape[0], seed=args.seed,
        )
        n_train = int(0.9 * batch["x"].shape[0])
        train_keys = ("x", "times", "mask", "feature_mask")
        train = {k: batch[k][:n_train] for k in train_keys}
        test = {k: v[n_train:] for k, v in batch.items()}
        return Batcher(train, batch_size, seed=args.seed), test
    if family == "mnist":
        h = model_cfg.image_shape[0]
        if args.data:
            ds = MovingMNIST(args.data, batch_size=batch_size)
        else:
            vids = synthetic_moving_mnist(
                args.num_seqs, t=model_cfg.time_len, size=h,
                seed=args.seed,
            )
            ds = MovingMNIST(data=vids, batch_size=batch_size)
        return ds.batchers["train"], ds.splits.get("test")
    if args.data:
        # .npz from generate-data, or the reference's joblib pickle
        # (toy_data_v3.pkl, src/Models/syndata/GP_VAE_syn_data.py:278)
        batch = toy_to_masked_batch(load_toy_file(args.data))
    else:
        data = generate_toy_data(
            jax.random.key(args.seed), args.num_seqs,
            t=model_cfg.time_len,
            # uniform-grid presets (shared_time_grid / Toeplitz prior)
            # need fully observed sequences
            hide_fraction=0.0 if family == "toy_full" else 0.7,
        )
        batch = toy_to_masked_batch(
            {k: np.asarray(v) for k, v in data.items()}
        )
    n_train = int(0.9 * batch["x"].shape[0])
    train = {k: v[:n_train] for k, v in batch.items()}
    test = {k: v[n_train:] for k, v in batch.items()}
    return Batcher(train, batch_size, seed=args.seed), test


def cmd_train(args):
    from gpvae_tpu import configs, train as train_lib
    from gpvae_tpu.models import GPVAE

    preset = configs.get(args.preset)
    model_cfg = preset.model
    if args.time_len:
        model_cfg = dataclasses.replace(model_cfg, time_len=args.time_len)
    train_cfg = preset.train
    overrides = {}
    if args.steps:
        overrides["num_steps"] = args.steps
    if args.ckpt_dir:
        overrides["checkpoint_dir"] = args.ckpt_dir
    if args.log_every:
        overrides["log_every"] = args.log_every
    if args.steps_per_call:
        overrides["steps_per_call"] = args.steps_per_call
    if overrides:
        train_cfg = dataclasses.replace(train_cfg, **overrides)

    batches, _ = _load_batches(args, preset, model_cfg)
    model = GPVAE(model_cfg)
    callbacks = None
    if args.plots:
        # periodic input/reconstruction/latent artifacts during training —
        # the reference's every-10-20k-step savefig blocks
        # (src/Models/syndata/GP_VAE_syn_data.py:375-392)
        from gpvae_tpu import analysis

        probe = {
            k: v[: min(8, batches.batch_size)]
            for k, v in batches.arrays.items()
        }
        callbacks = [(
            args.plots_every,
            analysis.make_artifact_callback(model, probe, args.plots),
        )]
    state, log = train_lib.fit(
        model, iter(batches), train_cfg, csv_path=args.csv,
        callbacks=callbacks,
    )
    # a run resumed at or past --steps trains nothing and logs no loss
    final = (f"loss={log.rows[-1]['loss']:.4f}" if log.rows
             else "no steps left to run")
    print(f"done at step {int(state.step)}: {final}")


def cmd_evaluate(args):
    """Restore a checkpoint and run the imputation benchmark (+ optional
    plot artifacts) — the reference's analysis-script workflow
    (SURVEY.md §3.4) as one command."""
    import json

    import jax
    import jax.numpy as jnp

    from gpvae_tpu import analysis, configs, train as train_lib
    from gpvae_tpu.models import GPVAE

    preset = configs.get(args.preset)
    model_cfg = preset.model
    if args.time_len:
        model_cfg = dataclasses.replace(model_cfg, time_len=args.time_len)
    model = GPVAE(model_cfg)
    _, test = _load_batches(args, preset, model_cfg)
    batch = {k: v[: args.eval_batch] for k, v in test.items()}

    state, tx = train_lib.create_train_state(
        model, batch, train_lib.TrainConfig()
    )
    if args.ckpt_dir:
        mgr = train_lib.CheckpointManager(args.ckpt_dir)
        restored = mgr.restore_latest(state)
        if restored is None:
            raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
        state = restored
        print(f"restored step {int(state.step)}")

    x = jnp.asarray(batch["x"])
    times = jnp.asarray(batch["times"], jnp.float32)
    mask = jnp.asarray(batch["mask"])
    if preset.resolved_data_family == "healing":
        # missing-pixel regime: score reconstructions on exactly the
        # corrupted pixels against the clean targets
        metrics = analysis.pixel_imputation_metrics(
            model, state.params, batch, key=jax.random.key(args.seed),
        )
    else:
        metrics = analysis.imputation_metrics(
            model, state.params, x, times, mask,
            key=jax.random.key(args.seed),
            drop_fraction=args.drop_fraction,
        )
    print(json.dumps(metrics))

    if args.stats:
        # MC activation/variance statistics (the reference's commented
        # analysis block, src/Models/FullGP_and_GPdecoder_dynamic_time_
        # analysis.py:204-227) — per-dim variance of MC latent means,
        # sorted descending
        _, var_sorted = analysis.activation_stats(
            model, state.params, x, times, mask,
            key=jax.random.key(args.seed + 3),
            num_samples=args.stats_samples,
        )
        print(json.dumps({
            "activation_variance_sorted": [
                round(float(v), 6) for v in np.asarray(var_sorted)
            ],
        }))

    if args.plots:
        import os

        from gpvae_tpu.utils import plotting

        os.makedirs(args.plots, exist_ok=True)
        kept = analysis.drop_timesteps(
            jax.random.key(args.seed), mask, args.drop_fraction
        )
        probs, z_imp, _ = analysis.impute(
            model, state.params, x, times, mask, kept,
            key=jax.random.key(args.seed + 1),
        )
        if model_cfg.decoder == "conv":
            plotting.comparison_grid(
                {
                    "input": np.asarray(x[0]),
                    "imputed": np.asarray(probs[0]),
                },
                os.path.join(args.plots, "imputation.png"),
                kept_mask=np.asarray(kept[0]),
            )
        plotting.trajectory_plot(
            np.asarray(times[0]), np.asarray(z_imp[0]),
            os.path.join(args.plots, "latents.png"),
            mask=np.asarray(kept[0]),
        )
        if args.traversal is not None:
            # sweep one latent dim over a probit grid and along a draw from
            # the learned per-latent GP gram (reference latent traversal,
            # SURVEY.md §3.4)
            sweep = analysis.latent_traversal(
                model, state.params, jnp.zeros(model_cfg.latent_dim),
                dim=args.traversal,
            )
            gp_sweep = analysis.traversal_from_gp(
                model, state.params, times[0], dim=args.traversal,
                key=jax.random.key(args.seed + 2),
            )
            if model_cfg.decoder == "conv":
                plotting.film_strip(
                    np.asarray(sweep),
                    os.path.join(args.plots, "traversal.png"),
                    title=f"latent dim {args.traversal} probit sweep",
                )
                plotting.film_strip(
                    np.asarray(gp_sweep),
                    os.path.join(args.plots, "traversal_gp.png"),
                    title=f"latent dim {args.traversal} GP-draw sweep",
                )
            else:
                plotting.trajectory_plot(
                    np.arange(sweep.shape[0], dtype=np.float32),
                    np.asarray(sweep),
                    os.path.join(args.plots, "traversal.png"),
                )
        print(f"plots written to {args.plots}")


def cmd_bench(_args):
    import bench

    bench.main()


def main(argv=None):
    from gpvae_tpu.utils import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="gpvae_tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("list-presets").set_defaults(fn=cmd_list_presets)

    g = sub.add_parser("generate-data")
    g.add_argument("--out", required=True)
    g.add_argument("--num-seqs", type=int, default=10_000)
    g.add_argument("--time-len", type=int, default=45)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=cmd_generate_data)

    t = sub.add_parser("train")
    t.add_argument("--preset", required=True)
    t.add_argument("--data", help=".npz toy data or MovingMNIST .npy")
    t.add_argument("--num-seqs", type=int, default=512,
                   help="synthetic sequences when --data is absent")
    t.add_argument("--steps", type=int)
    t.add_argument("--time-len", type=int)
    t.add_argument("--ckpt-dir")
    t.add_argument("--csv")
    t.add_argument("--log-every", type=int)
    t.add_argument("--steps-per-call", type=int,
                   help="optimizer steps per jitted call (amortizes host work)")
    t.add_argument("--plots", help="directory for periodic training "
                   "artifacts (film strips / latent trajectories)")
    t.add_argument("--plots-every", type=int, default=10_000,
                   help="callback period for --plots (reference: 10-20k)")
    t.add_argument("--batch-size", type=int,
                   help="override the preset's batch size")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate")
    e.add_argument("--preset", required=True)
    e.add_argument("--ckpt-dir")
    e.add_argument("--data")
    e.add_argument("--num-seqs", type=int, default=128)
    e.add_argument("--time-len", type=int)
    e.add_argument("--eval-batch", type=int, default=16)
    e.add_argument("--drop-fraction", type=float, default=0.5)
    e.add_argument("--plots", help="directory for PNG artifacts")
    e.add_argument("--traversal", type=int,
                   help="also dump latent-traversal strips for this dim")
    e.add_argument("--stats", action="store_true",
                   help="print MC activation/variance statistics")
    e.add_argument("--stats-samples", type=int, default=100)
    e.add_argument("--batch-size", type=int,
                   help="override the preset's batch size")
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("bench")
    b.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
