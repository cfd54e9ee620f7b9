"""The plain-XLA covariance ops and the steps-per-call sweep on one GPU.

    python benchmarks/xla_baseline.py [--out chiprun_out/xla_baseline.json]

Two measurements, printed as one JSON line (and written to ``--out``):

* ``ops``: milliseconds per call of gram + Cholesky + logdet at the shapes
  the covariance path serves (T=45 N=40, T=20 N=100, T=256 N=512,
  T=1024 N=128) and of the Cholesky VJP at T=1024 N=16 — the bar a
  hand-written GPU kernel must beat.  Each op runs ``inner`` times in a
  device-side ``fori_loop`` whose iterations are chained through an
  ``optimization_barrier``, so nothing is hoisted or overlapped.
* ``steps_per_call``: ``train.fit`` wall steps/s on the ``syn_data`` preset
  for k optimizer steps per jitted call, device-resident (a ``Batcher``)
  and host-staged (a plain batch iterator).  The steady rate is the median
  over the log windows after the first, which holds the compile.

Needs a GPU; the card's name and power limit are part of the output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OP_SHAPES = [(45, 40), (20, 100), (256, 512), (1024, 128)]


def time_loop(fn, *args, inner: int, outer: int = 5) -> float:
    """Median seconds per iteration of ``fn`` over ``outer`` timed calls."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(*args):
        def body(_, acc):
            a, _acc = jax.lax.optimization_barrier((args, acc))
            return acc + fn(*a)
        return jax.lax.fori_loop(0, inner, body, jnp.float32(0.0))

    jax.block_until_ready(run(*args))
    trials = []
    for _ in range(outer):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        trials.append((time.perf_counter() - t0) / inner)
    return float(np.median(trials))


def measure_ops() -> dict:
    import jax
    import jax.numpy as jnp

    from gpvae_tpu import kernels
    from gpvae_tpu.ops import cholesky, logdet_from_chol
    from gpvae_tpu.ops.chol import cholesky_bwd_from_l

    rng = np.random.default_rng(0)
    out = {}
    for t, n in OP_SHAPES:
        times = jnp.asarray(np.sort(rng.uniform(0, 60, (n, t)), -1),
                            jnp.float32)
        ls = jnp.asarray([5.0], jnp.float32)

        def op(tt, ls):
            l = cholesky(kernels.gram_bank(tt, ls, noise=1e-3))
            # an O(N*T) read of the factor keeps it live
            return jnp.sum(logdet_from_chol(l)) + jnp.sum(l[..., -1, :1])

        inner = max(8, min(512, int(2e9 // (n * t ** 3 / 3 + 1e6))))
        dt = time_loop(op, times, ls, inner=inner)
        out[f"gram_chol_logdet_T{t}_N{n}_ms"] = dt * 1e3
        out[f"gram_chol_logdet_T{t}_N{n}_tflops"] = n * t ** 3 / 3 / dt / 1e12
        print(f"gram+chol+logdet T={t} N={n}: {dt * 1e3:.4f} ms", flush=True)

    t, n = 1024, 16
    times = jnp.asarray(np.sort(rng.uniform(0, 60, (n, t)), -1), jnp.float32)
    l = jax.jit(lambda tt: cholesky(kernels.gram_bank(
        tt, jnp.asarray([5.0], jnp.float32), noise=1e-3)))(times)
    l_bar = jnp.asarray(np.tril(rng.standard_normal(l.shape)), jnp.float32)
    dt = time_loop(lambda l, lb: jnp.sum(cholesky_bwd_from_l(l, lb)[
        ..., -1, :1]), l, l_bar, inner=32)
    out["chol_vjp_T1024_N16_ms"] = dt * 1e3
    print(f"Cholesky VJP T=1024 N=16: {dt * 1e3:.4f} ms", flush=True)
    return out


class _Staged:
    """The Batcher's batches as a plain iterator: train.fit then stages
    every batch from the host."""

    def __init__(self, batcher):
        self._b = batcher

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._b)


def measure_steps_per_call() -> dict:
    import jax

    from gpvae_tpu import configs, train as train_lib
    from gpvae_tpu.data import Batcher, generate_toy_data, toy_to_masked_batch
    from gpvae_tpu.models import GPVAE

    preset = configs.get("syn_data")
    data = generate_toy_data(jax.random.key(0), 2000)
    arrays = toy_to_masked_batch({k: np.asarray(v) for k, v in data.items()})
    model = GPVAE(preset.model)
    out = {}
    for resident, ks in ((True, (1, 16, 64, 256)), (False, (1, 16, 64))):
        for k in ks:
            log_every = max(k, 128)
            cfg = dataclasses.replace(preset.train, steps_per_call=k,
                                      log_every=log_every,
                                      num_steps=8 * log_every)
            batches = Batcher(arrays, preset.batch_size)
            if not resident:
                batches = _Staged(batches)
            _, log = train_lib.fit(model, batches, cfg, verbose=False)
            sps = float(np.median([r["steps_per_sec"] for r in log.rows[1:]]))
            name = "resident" if resident else "staged"
            out[f"{name}_k{k}_steps_per_sec"] = sps
            print(f"syn_data fit {name} k={k}: {sps:.1f} steps/s", flush=True)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out")
    args = parser.parse_args()

    import jax

    from gpvae_tpu.utils import card_info, enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform}")
    enable_compile_cache()
    card = card_info()
    print(card, flush=True)
    result = {"card": card, "device_kind": dev.device_kind,
              "ops": measure_ops(), "steps_per_call": measure_steps_per_call()}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
