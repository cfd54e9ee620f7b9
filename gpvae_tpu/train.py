"""Training: one jitted ELBO step (optax Adam), metrics, checkpointing,
and the experiment driver loop.

Replaces the reference's L5 layer — the per-script ``main()`` train loops
(src/Models/syndata/GP_VAE_syn_data.py:277-399,
src/Models/Full_GP_VAE_dynamic_time.py:302-416):

* ``tf.train.AdamOptimizer(2e-4)`` (…:348, identical in all 9 scripts)
  -> ``optax.adam`` inside one jitted step — forward, KL, backward through
  the Cholesky custom VJP, and the update compile to a single XLA program;
* per-step ``feed_dict`` host->device copies -> device-resident batches
  (the only host boundary is the numpy Batcher);
* ``tf.train.Saver`` snapshots every 25k steps + manual restore-by-name
  (…:374,413; SURVEY.md §5 checkpoint) -> an in-repo ``.npz``
  CheckpointManager over an explicit (params, opt_state, step, rng) pytree
  with auto-resume;
* loss prints every 500 steps incl. learned lengthscales (…:367-374) and
  CSV loss files (``write_file``, src/Models/Full_GP_VAE_dynamic_time.py:
  294-300 — whose ``type=`` kwarg crash we do not reproduce) -> a metrics
  log with the same observables.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import re
import time
import warnings
from typing import Any, Callable, Iterator

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gpvae_tpu import elbo as elbo_lib
from gpvae_tpu import models as models_lib
from gpvae_tpu.models import GPVAE


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: jnp.ndarray
    rng: jax.Array


jax.tree_util.register_dataclass(
    TrainState,
    data_fields=["params", "opt_state", "step", "rng"],
    meta_fields=[],
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4  # reference Adam lr, all scripts
    num_steps: int = 10_000
    beta: elbo_lib.BetaSchedule = elbo_lib.BetaSchedule()
    log_every: int = 500         # reference print cadence (…:367)
    checkpoint_every: int = 25_000  # reference Saver cadence (…:374)
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3
    seed: int = 0
    # >1: run this many optimizer steps per jitted call (a lax.scan over a
    # stacked super-batch).  Amortizes the per-call host work (dispatch,
    # batch staging, the Python loop), which bounds short-sequence steps
    # on an accelerator.  None = auto, per platform (AUTO_STEPS_PER_CALL).
    # The loop may overshoot num_steps by up to k-1 steps.
    steps_per_call: int | None = None

    def resolved_steps_per_call(
        self, device_resident: bool = False, platform: str | None = None
    ) -> int:
        """Steps per jitted call; ``platform`` defaults to JAX's backend."""
        if self.steps_per_call is not None:
            return max(1, self.steps_per_call)
        platform = platform or jax.default_backend()
        k = AUTO_STEPS_PER_CALL.get(platform, {}).get(device_resident, 1)
        # never chunk past the log cadence or the run length
        return max(1, min(k, self.num_steps, max(1, self.log_every)))


# auto steps_per_call: platform -> {device-resident dataset: k}.  The GPU
# values come from a `fit` sweep of syn_data on one H100
# (benchmarks/xla_baseline.py): the device-resident rate plateaus from
# k=16, the host-staged one is bound by staging at any k.  Elsewhere (the
# CPU test backend) one step per call.
AUTO_STEPS_PER_CALL: dict[str, dict[bool, int]] = {
    "gpu": {True: 256, False: 16},
}


def create_train_state(
    model: GPVAE, batch: dict, config: TrainConfig
) -> tuple[TrainState, optax.GradientTransformation]:
    init_key, sample_key, train_key = jax.random.split(
        jax.random.key(config.seed), 3
    )
    params = model.init(
        {"params": init_key, "sample": sample_key},
        jnp.asarray(batch["x"]),
        jnp.asarray(batch["times"]),
        jnp.asarray(batch["mask"]),
    )["params"]
    tx = optax.adam(config.learning_rate)
    state = TrainState(
        params=params,
        opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32),
        rng=train_key,
    )
    return state, tx


def _build_step_fn(
    model: GPVAE,
    tx: optax.GradientTransformation,
    beta_schedule: elbo_lib.BetaSchedule,
):
    def step_fn(state: TrainState, batch: dict):
        rng, sample_key = jax.random.split(state.rng)
        beta = beta_schedule(state.step)

        def loss_fn(params):
            out = model.apply(
                {"params": params},
                batch["x"], batch["times"], batch["mask"],
                beta=beta,
                feature_mask=batch.get("feature_mask"),
                rngs={"sample": sample_key},
            )
            return out.loss, out

        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        metrics = {
            "loss": loss,
            "nll": jnp.mean(out.nll),
            "kl": jnp.mean(out.kl),
            "beta": beta,
            # lengthscale trajectories are a first-class observable
            # (reference prints them every 500 steps, …:370-371)
            **{
                "lengthscale_" + name.removesuffix("_log_ls"):
                    jnp.exp(state.params[name])
                for name in ("posterior_log_ls", "prior_log_ls")
                if name in state.params
            },
        }
        new_state = TrainState(
            params=params, opt_state=opt_state,
            step=state.step + 1, rng=rng,
        )
        return new_state, metrics

    return step_fn


def make_train_step(
    model: GPVAE,
    tx: optax.GradientTransformation,
    beta_schedule: elbo_lib.BetaSchedule,
    *,
    donate: bool = True,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build the single jitted train step (state donated for in-place
    buffer reuse on device)."""
    step_fn = _build_step_fn(model, tx, beta_schedule)
    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())


def make_multi_step(
    model: GPVAE,
    tx: optax.GradientTransformation,
    beta_schedule: elbo_lib.BetaSchedule,
    num_steps: int,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``num_steps`` optimizer steps per jitted call: a ``lax.scan`` over a
    super-batch whose arrays carry a leading [num_steps] axis.  Returns the
    last step's metrics."""
    inner = _build_step_fn(model, tx, beta_schedule)

    def multi_fn(state: TrainState, batches: dict):
        def body(s, b):
            s, metrics = inner(s, b)
            return s, metrics
        state, metrics = jax.lax.scan(body, state, batches)
        last = jax.tree_util.tree_map(lambda m: m[-1], metrics)
        return state, last

    return jax.jit(multi_fn, donate_argnums=(0,))


def make_sampled_multi_step(
    model: GPVAE,
    tx: optax.GradientTransformation,
    beta_schedule: elbo_lib.BetaSchedule,
    arrays: dict,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Multi-step trainer over a device-resident dataset.

    The full training arrays are staged onto the device ONCE and then
    passed as arguments to the jitted program (NOT closed over as jit
    constants: a closed-over dataset would be embedded in the compiled
    program — 503 MB at T=4096 x 2048 sequences; committed device arrays
    cost nothing to pass).  Each call takes only an ``idx [k, B]`` int
    array, gathers the super-batch on the device, and scans ``k``
    optimizer steps — so one dispatch plus a few KB of indices buys ``k``
    steps, instead of staging ``k`` full batches from the host every
    call.
    """
    inner = _build_step_fn(model, tx, beta_schedule)
    dev = {
        key: jax.device_put(
            jnp.asarray(v, jnp.float32 if key == "times" else None)
        )
        for key, v in arrays.items()
        if key in _BATCH_KEYS
    }

    @functools.partial(jax.jit, donate_argnums=(0,))
    def multi_fn(state: TrainState, idx, dev):
        def body(s, i):
            batch = {k: jnp.take(v, i, axis=0) for k, v in dev.items()}
            s, metrics = inner(s, batch)
            return s, metrics
        state, metrics = jax.lax.scan(body, state, idx)
        last = jax.tree_util.tree_map(lambda m: m[-1], metrics)
        return state, last

    def run(state: TrainState, idx):
        return multi_fn(state, idx, dev)

    return run


def eval_step(model: GPVAE, params, batch: dict, key: jax.Array,
              beta: float = 1.0) -> dict:
    out = model.apply(
        {"params": params},
        jnp.asarray(batch["x"]), jnp.asarray(batch["times"]),
        jnp.asarray(batch["mask"]),
        beta=beta, rngs={"sample": key},
    )
    return {"loss": out.loss, "nll": jnp.mean(out.nll),
            "kl": jnp.mean(out.kl)}


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

class CheckpointManager:
    """(params, opt_state, step, rng) checkpoints as ``.npz`` files.

    Each save writes the flattened leaves of the state to
    ``ckpt_<step>.npz`` through a temporary file and an atomic rename, so
    a crash mid-save never leaves a truncated checkpoint under the final
    name, and keeps the newest ``keep``.  Restore checks the saved tree
    structure, shapes and dtypes against a template state and puts each
    leaf back on the template leaf's sharding.

    The reference saves full graph variables but keeps the step only in
    filenames and never auto-resumes (SURVEY.md §5 failure detection);
    here ``restore_latest`` makes re-running a script resume exactly."""

    _NAME = re.compile(r"^ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._keep = max(1, keep)
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{step}.npz")

    def steps(self) -> list[int]:
        """Saved steps, oldest first."""
        found = (self._NAME.match(f) for f in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    @staticmethod
    def _payload(state: TrainState, step) -> dict:
        return {
            "params": state.params,
            "opt_state": state.opt_state,
            "step": np.asarray(step, np.int64),
            "rng": jax.random.key_data(state.rng),
        }

    def save(self, state: TrainState):
        step = int(state.step)
        leaves, treedef = jax.tree_util.tree_flatten(
            self._payload(state, step)
        )
        arrays = {f"leaf_{i}": np.asarray(jax.device_get(leaf))
                  for i, leaf in enumerate(leaves)}
        arrays["treedef"] = np.asarray(str(treedef))
        tmp = os.path.join(self._dir, f".ckpt_{step}.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self._keep]:
            os.remove(self._path(old))

    def restore_latest(self, state: TrainState) -> TrainState | None:
        """Restore into the structure of ``state``; None if no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        path = self._path(step)
        template, treedef = jax.tree_util.tree_flatten(
            self._payload(state, 0)
        )
        with np.load(path) as saved:
            if str(saved["treedef"]) != str(treedef):
                raise ValueError(
                    f"{path}: saved tree structure does not match the "
                    f"model's state (a different config or optimizer?)"
                )
            leaves = []
            for i, want in enumerate(template):
                got = saved[f"leaf_{i}"]
                if got.shape != np.shape(want) or got.dtype != want.dtype:
                    raise ValueError(
                        f"{path}: leaf {i} is {got.dtype}{list(got.shape)}, "
                        f"expected {want.dtype}{list(np.shape(want))}"
                    )
                sharding = getattr(want, "sharding", None)
                leaves.append(
                    got if sharding is None else jax.device_put(got, sharding)
                )
        restored = jax.tree_util.tree_unflatten(treedef, leaves)
        return TrainState(
            params=restored["params"],
            opt_state=restored["opt_state"],
            step=jnp.asarray(restored["step"], jnp.int32),
            rng=jax.random.wrap_key_data(restored["rng"]),
        )


# ---------------------------------------------------------------------------
# Experiment driver
# ---------------------------------------------------------------------------

class MetricsLog:
    """In-memory metrics record + optional CSV (the reference's
    ``write_file`` loss CSVs, src/Models/Full_GP_VAE_dynamic_time.py:294-300,
    minus its crashing kwarg).

    The CSV carries every scalar metric plus vector metrics expanded to one
    column per element — in particular the learned lengthscale trajectories
    (``lengthscale_*_0..Z-1``), which the reference prints every 500 steps
    as a first-class observable (src/Models/syndata/GP_VAE_syn_data.py:
    370-371).  The header is fixed by the first appended row.
    """

    def __init__(self, csv_path: str | None = None):
        self.rows: list[dict] = []
        self._csv = csv_path
        self._columns: list[str] | None = None
        if csv_path:
            os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
            with open(csv_path, "w"):
                pass  # truncate; header written on first append

    @staticmethod
    def _flatten(step: int, metrics: dict) -> dict:
        flat = {"step": step}
        for k, v in metrics.items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                flat[k] = arr.item()
            else:
                for i, x in enumerate(arr.reshape(-1)):
                    flat[f"{k}_{i}"] = float(x)
        return flat

    def append(self, step: int, metrics: dict):
        row = {"step": step}
        for k, v in metrics.items():
            arr = np.asarray(v)
            row[k] = arr.item() if arr.ndim == 0 else arr.tolist()
        self.rows.append(row)
        if self._csv:
            flat = self._flatten(step, metrics)
            if self._columns is None:
                head = [
                    c for c in ("step", "loss", "nll", "kl", "beta")
                    if c in flat
                ]
                self._columns = head + sorted(
                    c for c in flat if c not in head
                )
                with open(self._csv, "a") as f:
                    f.write(",".join(self._columns) + "\n")
            extra = set(flat) - set(self._columns)
            if extra:
                # the header is frozen at the first append; a metric key
                # that first appears later would otherwise vanish from the
                # CSV for the whole run with no trace
                warnings.warn(
                    f"MetricsLog: metric keys {sorted(extra)} appeared "
                    f"after the CSV header was written and are dropped "
                    f"from {self._csv} (present in .rows)",
                    stacklevel=2,
                )
            with open(self._csv, "a") as f:
                f.write(",".join(
                    str(flat.get(c, "")) for c in self._columns
                ) + "\n")


def fit(
    model: GPVAE,
    batches: Iterator[dict],
    config: TrainConfig,
    *,
    state: TrainState | None = None,
    csv_path: str | None = None,
    verbose: bool = True,
    callbacks: list[tuple[int, Callable[[TrainState, int], None]]] | None
    = None,
) -> tuple[TrainState, MetricsLog]:
    """Run the training loop; resumes from ``config.checkpoint_dir`` if a
    checkpoint exists there.

    ``callbacks``: list of ``(every_n_steps, fn(state, step))`` hooks — the
    home for periodic artifact dumps (the reference's reconstruction film
    strips every 10-20k steps, src/Models/Full_GP_VAE_dynamic_time.py:
    385-410; compose with gpvae_tpu.utils.plotting)."""
    from gpvae_tpu.data.batching import Batcher

    # a framework Batcher exposes the dataset arrays + index stream, which
    # unlocks the device-resident fast path (gather fused into the jitted
    # scan; only indices cross the host boundary per call)
    sampler = batches if isinstance(batches, Batcher) else None
    k = config.resolved_steps_per_call(device_resident=sampler is not None)
    sampled = k > 1 and sampler is not None
    if sampled:
        # init from array shapes without consuming the index stream (the
        # stream position must match the single-step path batch-for-batch)
        first = {
            key: v[: sampler.batch_size] for key, v in sampler.arrays.items()
        }
    else:
        first = next(batches)
    if first.get("times") is not None:
        # resolve structured_prior='auto' against the real grid, and fail
        # fast on a non-uniform grid before jit silently computes a wrong
        # structured prior (see models.resolve_structured_prior)
        cfg = models_lib.resolve_structured_prior(
            model.config, first["times"], first.get("mask")
        )
        if cfg is not model.config:
            model = type(model)(cfg)
    if state is None:
        state, tx = create_train_state(model, first, config)
    else:
        tx = optax.adam(config.learning_rate)
    ckpt = (
        CheckpointManager(config.checkpoint_dir, config.keep_checkpoints)
        if config.checkpoint_dir else None
    )
    if ckpt is not None:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state = restored
            if verbose:
                print(f"resumed from step {int(state.step)}")

    if sampled:
        multi_fn = make_sampled_multi_step(
            model, tx, config.beta, sampler.arrays
        )
    elif k > 1:
        multi_fn = make_multi_step(model, tx, config.beta, k)
    step_fn = make_train_step(model, tx, config.beta) if k == 1 else None
    log = MetricsLog(csv_path)
    t_last = time.perf_counter()
    batch = first
    # host-side step counter: reading state.step back every iteration would
    # force a device sync per step and stall the dispatch queue
    step = int(state.step)
    last_logged = step
    while step < config.num_steps:
        if k == 1:
            state, metrics = step_fn(state, _device_batch(batch))
            step += 1
        elif sampled:
            idx = np.stack([sampler.next_indices() for _ in range(k)])
            state, metrics = multi_fn(state, jnp.asarray(idx))
            step += k
        else:
            chunk = [batch] + [next(batches) for _ in range(k - 1)]
            stacked = {
                key: jnp.stack([jnp.asarray(c[key]) for c in chunk])
                for key in _BATCH_KEYS
                if chunk[0].get(key) is not None
            }
            stacked["times"] = stacked["times"].astype(jnp.float32)
            state, metrics = multi_fn(state, stacked)
            step += k
        if step // config.log_every > last_logged // config.log_every or (
            step >= config.num_steps
        ):
            jax.block_until_ready(metrics["loss"])
            now = time.perf_counter()
            sps = (step - last_logged) / max(now - t_last, 1e-9)
            t_last = now
            last_logged = step
            host = {
                name: np.asarray(v) for name, v in metrics.items()
            }
            log.append(step, {**host, "steps_per_sec": sps})
            if verbose:
                print(
                    f"step {step}: loss={float(host['loss']):.4f} "
                    f"nll={float(host['nll']):.4f} "
                    f"kl={float(host['kl']):.4f} "
                    f"beta={float(host['beta']):.2e} "
                    f"({sps:.1f} steps/s)"
                )
        if ckpt is not None and (
            step % config.checkpoint_every < k
            and step >= config.checkpoint_every
        ):
            ckpt.save(state)
        if callbacks:
            for every, fn in callbacks:
                if step % every < k and step >= every:
                    fn(state, step)
        if step < config.num_steps and not sampled:
            # only fetch when another iteration runs: a finite batch
            # iterator must not raise StopIteration after the last step
            # (which would skip the final checkpoint save).  The sampled
            # path consumes indices directly and never gathers on host.
            batch = next(batches)
    if ckpt is not None:
        ckpt.save(state)
    return state, log


_BATCH_KEYS = ("x", "times", "mask", "feature_mask")


def _device_batch(batch: dict) -> dict:
    out = {
        "x": jnp.asarray(batch["x"]),
        "times": jnp.asarray(batch["times"], jnp.float32),
        "mask": jnp.asarray(batch["mask"]),
    }
    # per-feature observation mask (healing-MNIST missing-pixel regime):
    # without it the Bernoulli NLL would train the model to predict the
    # zero-fill at never-observed pixels
    if batch.get("feature_mask") is not None:
        out["feature_mask"] = jnp.asarray(batch["feature_mask"])
    return out
