"""Data-parallel training over a device mesh.

The reference is strictly single-process/single-device (SURVEY.md §2.4: no
tf.device, no distribution strategy, no NCCL/MPI anywhere).  The scaling
story (BASELINE.json config 5: 4096 series x T=1024 over the cards of one
host):

* one ``Mesh`` with a ``data`` axis over all devices (the cards of a host
  are joined all to all, so a 1-D mesh needs no topology);
* the batch (and with it the ``[B*Z]`` batch-of-matrices axis of the
  covariance subsystem — every gram/Cholesky/solve shards for free with B)
  sharded over ``data`` via ``NamedSharding``;
* parameters/optimizer state replicated;
* gradient combination compiles to one all-reduce (NCCL on the GPU) —
  XLA inserts the collective from the sharding annotations; there is no
  hand-written communication.

TP/PP are deliberately absent: the largest dense layer in the model family
is 512x100 (SURVEY.md §2.4), far below the threshold where sharded matmuls
pay for their collectives.  The mesh axes tuple is the extension hook.
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpvae_tpu import elbo as elbo_lib
from gpvae_tpu.models import GPVAE
from gpvae_tpu.train import TrainState

import optax


def make_mesh(
    n_devices: int | None = None,
    axis_name: str = "data",
    devices: list | None = None,
) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(batch: dict, mesh: Mesh, axis_name: str = "data") -> dict:
    """Place each batch array with its leading dim sharded over the mesh."""
    n = mesh.shape[axis_name]
    for k, v in batch.items():
        if np.shape(v)[0] % n != 0:
            raise ValueError(
                f"batch axis of {k!r} ({np.shape(v)[0]}) is not divisible "
                f"by the {axis_name!r} mesh axis ({n} devices); pad or "
                f"resize the global batch"
            )
    sharding = NamedSharding(mesh, P(axis_name))
    return {k: jax.device_put(jax.numpy.asarray(v), sharding)
            for k, v in batch.items()}


def replicate(tree: Any, mesh: Mesh) -> Any:
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def make_parallel_train_step(
    model: GPVAE,
    tx: optax.GradientTransformation,
    beta_schedule: elbo_lib.BetaSchedule,
    mesh: Mesh,
    axis_name: str = "data",
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Jitted data-parallel train step: batch sharded over ``axis_name``,
    state replicated, gradients psum-reduced by XLA from the output
    sharding constraint."""
    repl = NamedSharding(mesh, P())
    data = NamedSharding(mesh, P(axis_name))

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
        new_state = TrainState(
            params=params, opt_state=opt_state,
            step=state.step + 1, rng=rng,
        )
        metrics = {
            "loss": loss,
            "nll": jax.numpy.mean(out.nll),
            "kl": jax.numpy.mean(out.kl),
            "beta": beta,
        }
        return new_state, metrics

    # a single sharding for the batch argument applies to every leaf, so
    # optional keys (feature_mask, the healing regime) shard for free
    return jax.jit(
        step_fn,
        in_shardings=(repl, data),
        out_shardings=(repl, repl),
        donate_argnums=(0,),
    )


def shard_batch_stack(
    batches: list, mesh: Mesh, axis_name: str = "data"
) -> dict:
    """Stack ``k`` global batches into ``[k, B, ...]`` super-arrays with the
    SECOND axis (the global batch) sharded over the mesh — the operand
    shape of :func:`make_parallel_multi_step`."""
    n = mesh.shape[axis_name]
    keys = [k for k in batches[0] if batches[0].get(k) is not None]
    for k in keys:
        if np.shape(batches[0][k])[0] % n != 0:
            raise ValueError(
                f"batch axis of {k!r} ({np.shape(batches[0][k])[0]}) is not "
                f"divisible by the {axis_name!r} mesh axis ({n} devices)"
            )
    sharding = NamedSharding(mesh, P(None, axis_name))
    return {
        k: jax.device_put(
            jax.numpy.stack([jax.numpy.asarray(b[k]) for b in batches]),
            sharding,
        )
        for k in keys
    }


def make_parallel_multi_step(
    model: GPVAE,
    tx: optax.GradientTransformation,
    beta_schedule: elbo_lib.BetaSchedule,
    mesh: Mesh,
    axis_name: str = "data",
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``k`` data-parallel optimizer steps per jitted call: a ``lax.scan``
    over super-batches ``[k, B_global, ...]`` whose batch axis shards over
    the mesh (the mesh analog of ``train.make_multi_step``).

    The k=1 dispatch-per-step loop pays one host->device staging and one
    dispatch per optimizer step (train.py steps_per_call).  Here the scan
    keeps the sharded super-batch device-resident across all k steps; the
    per-step gradient all-reduce is unchanged.  Step-for-step identical
    to the k=1 path (same ``train._build_step_fn`` body; tests assert
    parity)."""
    from gpvae_tpu import train as train_lib

    repl = NamedSharding(mesh, P())
    data2 = NamedSharding(mesh, P(None, axis_name))
    inner = train_lib._build_step_fn(model, tx, beta_schedule)

    def multi_fn(state: TrainState, batches: dict):
        state, metrics = jax.lax.scan(inner, state, batches)
        last = jax.tree_util.tree_map(lambda m: m[-1], metrics)
        return state, last

    return jax.jit(
        multi_fn,
        in_shardings=(repl, data2),
        out_shardings=(repl, repl),
        donate_argnums=(0,),
    )


def fit_data_parallel(
    model: GPVAE,
    batches,
    config,
    mesh: Mesh | None = None,
    *,
    state: TrainState | None = None,
    axis_name: str = "data",
    verbose: bool = True,
):
    """``train.fit`` over a data-parallel mesh (BASELINE config 5).

    Each batch from ``batches`` is the GLOBAL batch; its leading axis
    shards over the mesh's ``data`` axis (must divide evenly), parameters
    and optimizer state replicate, and the gradient reduction compiles to
    one all-reduce over the interconnect.  Like the single-chip loop, the
    driver runs ``config.steps_per_call`` optimizer steps per dispatch — a
    ``lax.scan`` over a device-resident sharded super-batch
    (:func:`make_parallel_multi_step`) — instead of one host staging and
    dispatch per step.  Checkpointing/resume go through the same
    ``train.CheckpointManager`` as the single-chip loop (replicated arrays
    are host-addressable).  Returns ``(state, MetricsLog)``.
    """
    import time

    from gpvae_tpu import train as train_lib

    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    first = next(batches)
    if first.get("times") is not None:
        from gpvae_tpu import models as models_lib
        cfg = models_lib.resolve_structured_prior(
            model.config, first["times"], first.get("mask")
        )
        if cfg is not model.config:
            model = type(model)(cfg)
    if state is None:
        state, tx = train_lib.create_train_state(model, first, config)
    else:
        tx = optax.adam(config.learning_rate)
    ckpt = (
        train_lib.CheckpointManager(
            config.checkpoint_dir, config.keep_checkpoints
        )
        if config.checkpoint_dir else None
    )
    if ckpt is not None:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state = restored
            if verbose:
                print(f"resumed from step {int(state.step)}")
    state = replicate(state, mesh)
    k = config.resolved_steps_per_call()
    if k > 1:
        multi_fn = make_parallel_multi_step(
            model, tx, config.beta, mesh, axis_name=axis_name
        )
    else:
        step_fn = make_parallel_train_step(
            model, tx, config.beta, mesh, axis_name=axis_name
        )
    log = train_lib.MetricsLog()
    step = int(jax.device_get(state.step))
    last_logged = step
    t_last = time.perf_counter()
    batch = first
    exhausted = False
    while step < config.num_steps:
        if k > 1:
            # clamp the chunk to the remaining steps (a num_steps-sized
            # finite iterator must not overshoot), and tolerate the
            # iterator ending mid-chunk: run what arrived, then stop
            # through the post-loop checkpoint save instead of raising
            # StopIteration out of the driver.  The tail chunk's shorter
            # scan length costs one extra compile.
            chunk = [batch]
            try:
                while len(chunk) < min(k, config.num_steps - step):
                    chunk.append(next(batches))
            except StopIteration:
                exhausted = True
            state, metrics = multi_fn(
                state, shard_batch_stack(chunk, mesh, axis_name)
            )
            took = len(chunk)
        else:
            state, metrics = step_fn(
                state, shard_batch(batch, mesh, axis_name)
            )
            took = 1
        step += took
        if step // config.log_every > last_logged // config.log_every or (
            step >= config.num_steps or exhausted
        ):
            jax.block_until_ready(metrics["loss"])
            now = time.perf_counter()
            sps = (step - last_logged) / max(now - t_last, 1e-9)
            t_last, last_logged = now, step
            host = {key: np.asarray(v) for key, v in metrics.items()}
            log.append(step, {**host, "steps_per_sec": sps})
            if verbose:
                print(
                    f"step {step}: loss={float(host['loss']):.4f} "
                    f"({sps:.1f} steps/s x {mesh.shape[axis_name]} devices)"
                )
        if ckpt is not None and not exhausted and (
            step % config.checkpoint_every < took
            and step >= config.checkpoint_every
        ):
            # (when exhausted, the post-loop save below covers this state —
            # saving here too would write the same checkpoint twice)
            ckpt.save(state)
        if exhausted:
            if verbose:
                print(f"batches exhausted at step {step}; stopping")
            break
        if step < config.num_steps:
            try:
                batch = next(batches)
            except StopIteration:
                if verbose:
                    print(f"batches exhausted at step {step}; stopping")
                break
    if ckpt is not None:
        ckpt.save(state)
    return state, log
