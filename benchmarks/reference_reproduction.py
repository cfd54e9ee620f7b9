"""Reference-reproduction training run (VERDICT r2 missing #1).

Trains the ``syn_data`` preset — the exact
src/Models/syndata/GP_VAE_syn_data.py workload: B=20 sequences, T<=45
irregular masked times, Z=2, S=1, Adam 2e-4, beta 1e-3 +1e-7/step after
20k, clamp 1.0 — for ``--steps`` steps (>=100k) on real generated toy
data, recording the loss/NLL/KL/lengthscale trajectories the reference
prints every 500 steps, plus final imputation metrics.

Optionally (``--fp64-check-steps N``) audits the live trajectory against
the fp64 reference-math oracle: every log interval during the first N
steps, the ELBO at the *current* parameters is re-evaluated on a fixed
probe batch both by the framework's fp32 path and by the fp64
numpy re-derivation of the reference formulas
(gpvae_tpu.utils.reference_math — explicit matrix-inverse + logdet KL,
src/Models/syndata/GP_VAE_syn_data.py:168-236), with the same latent
draw.  The recorded max relative deviation bounds the fp32 vs
fp64 divergence along a real training trajectory — the SURVEY §6
consequence (1) evidence: "reproduce reference ELBO trajectories on the
toy config".

Writes a JSON summary + CSV next to ``--out`` and a trajectory PNG.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--num-seqs", type=int, default=10_000)
    ap.add_argument("--out", default="/tmp/ref_repro")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fp64-check-steps", type=int, default=0,
                    help="audit the first N steps of the trajectory against "
                    "the fp64 reference-math oracle (every log interval)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from gpvae_tpu import analysis, configs
    from gpvae_tpu.data import Batcher, generate_toy_data, toy_to_masked_batch
    from gpvae_tpu.models import GPVAE
    from gpvae_tpu import train as train_lib
    from gpvae_tpu.utils import reference_math
    import dataclasses

    os.makedirs(args.out, exist_ok=True)
    preset = configs.get("syn_data")
    model = GPVAE(preset.model)

    # real generated toy data (reference gen_toy_data semantics, JAX port)
    data = generate_toy_data(jax.random.key(args.seed), args.num_seqs)
    batch = toy_to_masked_batch({k: np.asarray(v) for k, v in data.items()})
    n_train = int(0.9 * batch["x"].shape[0])
    train_arrays = {k: v[:n_train] for k, v in batch.items()}
    test_arrays = {k: v[n_train:] for k, v in batch.items()}

    train_cfg = dataclasses.replace(
        preset.train, num_steps=args.steps, log_every=500,
        checkpoint_dir=None,
    )
    sampler = Batcher(train_arrays, preset.batch_size, seed=args.seed)

    # --- fp64 reference-math trajectory audit (--fp64-check-steps) --------
    fp64_rows: list[dict] = []
    callbacks = None
    if args.fp64_check_steps > 0:
        probe = {
            k: v[: preset.batch_size] for k, v in train_arrays.items()
        }
        probe_x = jnp.asarray(probe["x"])
        probe_t = jnp.asarray(probe["times"], jnp.float32)
        probe_m = jnp.asarray(probe["mask"])
        probe_key = jax.random.key(99)
        beta_sched = train_cfg.beta
        ls_p_fixed = preset.model.prior_lengthscales

        def fp64_check(state, step):
            if step > args.fp64_check_steps:
                return
            beta = float(beta_sched(step)) if callable(beta_sched) else float(
                beta_sched
            )
            out = model.apply(
                {"params": state.params}, probe_x, probe_t, probe_m,
                beta=beta, rngs={"sample": probe_key},
            )
            ref = reference_math.fp64_elbo(
                state.params, probe["x"], probe["times"], probe["mask"],
                np.asarray(out.latent_sample[0]), beta,
                prior_lengthscales=ls_p_fixed,
            )
            kl_fw = float(jnp.sum(out.kl))
            nll_fw = float(jnp.sum(out.nll))
            loss_fw = float(out.loss)
            fp64_rows.append({
                "step": int(step),
                "loss_fp32": loss_fw, "loss_fp64_ref": ref["loss"],
                "kl_rel": abs(kl_fw - ref["kl"]) / max(abs(ref["kl"]), 1e-12),
                "nll_rel": abs(nll_fw - ref["nll"]) / max(
                    abs(ref["nll"]), 1e-12),
                "loss_rel": abs(loss_fw - ref["loss"]) / max(
                    abs(ref["loss"]), 1e-12),
            })

        callbacks = [(train_cfg.log_every, fp64_check)]

    t0 = time.time()
    state, log = train_lib.fit(
        model, sampler, train_cfg,
        csv_path=os.path.join(args.out, "trajectory.csv"),
        verbose=False, callbacks=callbacks,
    )
    wall = time.time() - t0
    x = jnp.asarray(test_arrays["x"][:64])
    times = jnp.asarray(test_arrays["times"][:64], jnp.float32)
    mask = jnp.asarray(test_arrays["mask"][:64])
    metrics = analysis.imputation_metrics(
        model, state.params, x, times, mask, key=jax.random.key(1),
        drop_fraction=0.5,
    )

    rows = log.rows
    summary = {
        "steps": int(state.step),
        "wall_seconds": round(wall, 1),
        "steps_per_sec_wall": round(int(state.step) / wall, 1),
        "first_logged": rows[0] if rows else None,
        "last_logged": rows[-1] if rows else None,
        "final_imputation": metrics,
        "lengthscale_posterior_final": rows[-1].get(
            "lengthscale_posterior"
        ) if rows else None,
    }
    if fp64_rows:
        summary["fp64_reference_audit"] = {
            "checked_steps": [r["step"] for r in fp64_rows],
            "max_loss_rel": max(r["loss_rel"] for r in fp64_rows),
            "max_kl_rel": max(r["kl_rel"] for r in fp64_rows),
            "max_nll_rel": max(r["nll_rel"] for r in fp64_rows),
            "rows": fp64_rows,
        }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    print(json.dumps(summary, default=str))

    # trajectory plot
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        steps = [r["step"] for r in rows]
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for ax, key in zip(axes, ("loss", "kl", "beta")):
            ax.plot(steps, [r.get(key, np.nan) for r in rows])
            ax.set_title(key)
            ax.set_xlabel("step")
        ls = [r.get("lengthscale_posterior") for r in rows]
        if ls and ls[0] is not None:
            axes[1].twinx().plot(
                steps, [l[0] for l in ls], "g--", alpha=0.5,
            )
        fig.tight_layout()
        fig.savefig(os.path.join(args.out, "trajectory.png"), dpi=100)
    except Exception as e:  # noqa: BLE001
        print(f"plot failed: {e}")


if __name__ == "__main__":
    main()
