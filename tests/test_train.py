"""Training: jitted step runs, overfit-on-tiny-subset sanity check (the
reference author's own verification practice, SURVEY.md §4.3), checkpoint
save/resume roundtrip, the auto steps-per-call table, the compile-cache
placement, and the main path without flax/orbax."""
import os
import subprocess
import sys

import numpy as np
import jax
import pytest

from gpvae_tpu import configs, elbo as elbo_lib, train as train_lib
from gpvae_tpu.data import Batcher, generate_toy_data, toy_to_masked_batch
from gpvae_tpu.models import GPVAE, GPVAEConfig


def small_toy_setup(num_seqs=8, t=12, batch_size=4):
    data = generate_toy_data(jax.random.key(0), num_seqs, t=t)
    batch = toy_to_masked_batch({k: np.asarray(v) for k, v in data.items()})
    cfg = GPVAEConfig(
        latent_dim=2, obs_dim=15, time_len=t,
        prior="gp", posterior="gp",
        prior_lengthscales=(9.0, 3.0), posterior_lengthscales=(9.0, 3.0),
    )
    return GPVAE(cfg), Batcher(batch, batch_size), batch


def test_overfit_two_batches_loss_decreases():
    """Reference practice: train on a tiny fixed subset 'to show that the
    net works' (src/Models/Full_GP_VAE_fixed_for_MovMnist.py:326-327)."""
    # one fixed batch of 4 sequences, so every step sees the same data
    model, batches, _ = small_toy_setup(num_seqs=4, batch_size=4)
    config = train_lib.TrainConfig(
        learning_rate=3e-3, num_steps=400,
        beta=elbo_lib.BetaSchedule(init=1e-3, rate=0.0),
        log_every=50,
    )
    state, log = train_lib.fit(
        model, iter(batches), config, verbose=False
    )
    losses = [r["loss"] for r in log.rows]
    assert len(losses) >= 4
    assert losses[-1] < losses[0] * 0.8, losses
    assert np.isfinite(losses).all()


def test_lengthscales_are_observable_and_move():
    model, batches, _ = small_toy_setup()
    config = train_lib.TrainConfig(
        learning_rate=5e-3, num_steps=60,
        beta=elbo_lib.BetaSchedule(init=1.0, rate=0.0), log_every=30,
    )
    state, log = train_lib.fit(model, iter(batches), config, verbose=False)
    assert "lengthscale_posterior" in log.rows[-1]
    ls0 = np.asarray(log.rows[0]["lengthscale_posterior"])
    ls1 = np.asarray(log.rows[-1]["lengthscale_posterior"])
    assert not np.allclose(ls0, ls1)
    assert np.all(ls1 > 0)  # log-parameterization keeps them positive


def test_checkpoint_resume_roundtrip(tmp_path):
    model, batches, _ = small_toy_setup()
    config = train_lib.TrainConfig(
        learning_rate=1e-3, num_steps=20, log_every=10,
        checkpoint_every=10, checkpoint_dir=str(tmp_path / "ckpt"),
    )
    state1, _ = train_lib.fit(model, iter(batches), config, verbose=False)
    assert int(state1.step) == 20

    # a fresh fit with a longer horizon resumes from step 20, not 0
    config2 = train_lib.TrainConfig(
        learning_rate=1e-3, num_steps=30, log_every=10,
        checkpoint_every=10, checkpoint_dir=str(tmp_path / "ckpt"),
    )
    state2, _ = train_lib.fit(model, iter(batches), config2, verbose=False)
    assert int(state2.step) == 30
    # params continued from the checkpoint (not re-initialized): the
    # restored optimizer state keeps Adam's moments, so one step from the
    # restored params equals continuing the original run
    p1 = jax.tree_util.tree_leaves(state1.params)[0]
    p2 = jax.tree_util.tree_leaves(state2.params)[0]
    assert not np.allclose(np.asarray(p1), np.asarray(p2))


def test_eval_step_finite():
    model, batches, batch = small_toy_setup()
    config = train_lib.TrainConfig(num_steps=5, log_every=5)
    state, _ = train_lib.fit(model, iter(batches), config, verbose=False)
    metrics = train_lib.eval_step(
        model, state.params, batch, jax.random.key(5)
    )
    assert np.isfinite(float(metrics["loss"]))


def test_preset_syn_data_step_runs():
    preset = configs.get("syn_data")
    data = generate_toy_data(jax.random.key(0), preset.batch_size)
    batch = toy_to_masked_batch({k: np.asarray(v) for k, v in data.items()})
    model = GPVAE(preset.model)
    b = Batcher(batch, preset.batch_size)
    config = train_lib.TrainConfig(num_steps=2, log_every=1)
    state, log = train_lib.fit(model, iter(b), config, verbose=False)
    assert np.isfinite(log.rows[-1]["loss"])


def test_fit_callbacks_fire():
    model, batches, _ = small_toy_setup()
    calls = []
    config = train_lib.TrainConfig(num_steps=30, log_every=30)
    train_lib.fit(
        model, iter(batches), config, verbose=False,
        callbacks=[(10, lambda state, step: calls.append(step))],
    )
    assert calls == [10, 20, 30]


def test_fp64_trajectory_audit_machinery():
    """The reference-reproduction runner's --fp64-check-steps audit
    (benchmarks/reference_reproduction.py) re-evaluates the ELBO at live
    trained params with the fp64 reference-math oracle.  Lock the
    machinery: after a short fit, the framework ELBO at the final params
    must match utils.reference_math.fp64_elbo within the 1e-4 north star
    (BASELINE.json)."""
    import jax.numpy as jnp
    from gpvae_tpu.utils import reference_math

    model, batches, batch = small_toy_setup(num_seqs=8, t=12, batch_size=4)
    config = train_lib.TrainConfig(
        num_steps=60, log_every=30,
        beta=elbo_lib.BetaSchedule(init=1e-3, rate=0.0),
    )
    state, _ = train_lib.fit(model, iter(batches), config, verbose=False)
    probe = {k: v[:4] for k, v in batch.items()}
    beta = 1e-3
    out = model.apply(
        {"params": state.params},
        jnp.asarray(probe["x"], jnp.float32),
        jnp.asarray(probe["times"], jnp.float32),
        jnp.asarray(probe["mask"]),
        beta=beta, rngs={"sample": jax.random.key(5)},
    )
    ref = reference_math.fp64_elbo(
        state.params, probe["x"], probe["times"], probe["mask"],
        np.asarray(out.latent_sample[0]), beta,
        prior_lengthscales=(9.0, 3.0),
    )
    kl_fw = float(np.sum(np.asarray(out.kl)))
    nll_fw = float(np.sum(np.asarray(out.nll)))
    assert abs(kl_fw - ref["kl"]) / abs(ref["kl"]) < 1e-4
    assert abs(nll_fw - ref["nll"]) / abs(ref["nll"]) < 1e-4
    assert abs(float(out.loss) - ref["loss"]) / abs(ref["loss"]) < 1e-4


def _tiny_state(latent_dim=2):
    model, _, batch = small_toy_setup()
    if latent_dim != 2:
        model = GPVAE(GPVAEConfig(
            latent_dim=latent_dim, obs_dim=15, time_len=12,
            prior="gp", posterior="gp",
            prior_lengthscales=(9.0,), posterior_lengthscales=(9.0,),
        ))
    state, _ = train_lib.create_train_state(
        model, batch, train_lib.TrainConfig(seed=latent_dim)
    )
    return model, batch, state


def test_checkpoint_bitwise_roundtrip(tmp_path):
    _, batch, state = _tiny_state()
    mgr = train_lib.CheckpointManager(str(tmp_path), keep=2)
    state = train_lib.TrainState(
        params=state.params, opt_state=state.opt_state,
        step=state.step + 7, rng=jax.random.key(123),
    )
    mgr.save(state)
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt_7.npz"]
    # a template from another seed: every leaf must come from the file
    _, _, template = _tiny_state()
    template = train_lib.TrainState(
        params=jax.tree_util.tree_map(lambda a: a * 0, template.params),
        opt_state=template.opt_state, step=template.step,
        rng=jax.random.key(0),
    )
    restored = mgr.restore_latest(template)
    assert int(restored.step) == 7
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(restored.rng)),
        np.asarray(jax.random.key_data(state.rng)),
    )
    for a, b in zip(jax.tree_util.tree_leaves((state.params, state.opt_state)),
                    jax.tree_util.tree_leaves(
                        (restored.params, restored.opt_state))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_keeps_last_n(tmp_path):
    _, _, state = _tiny_state()
    mgr = train_lib.CheckpointManager(str(tmp_path), keep=2)
    assert mgr.restore_latest(state) is None
    for step in (1, 2, 3, 10):
        mgr.save(train_lib.TrainState(state.params, state.opt_state,
                                      state.step + step, state.rng))
    assert mgr.steps() == [3, 10]
    assert int(mgr.restore_latest(state).step) == 10


def test_checkpoint_rejects_other_structure(tmp_path):
    _, _, state = _tiny_state()
    mgr = train_lib.CheckpointManager(str(tmp_path))
    mgr.save(state)
    _, _, other = _tiny_state(latent_dim=3)
    with pytest.raises(ValueError, match="leaf"):
        mgr.restore_latest(other)


def test_checkpoint_restores_onto_template_sharding(tmp_path):
    from gpvae_tpu.parallel import make_mesh, replicate

    _, _, state = _tiny_state()
    mgr = train_lib.CheckpointManager(str(tmp_path))
    mgr.save(state)
    mesh = make_mesh(2)
    template = replicate(state, mesh)
    restored = mgr.restore_latest(template)
    for want, got in zip(jax.tree_util.tree_leaves(template.params),
                         jax.tree_util.tree_leaves(restored.params)):
        assert got.sharding == want.sharding
        assert len(got.devices()) == 2


@pytest.mark.parametrize("platform,resident,want", [
    ("cpu", False, 1), ("cpu", True, 1),
    ("gpu", False, train_lib.AUTO_STEPS_PER_CALL["gpu"][False]),
    ("gpu", True, train_lib.AUTO_STEPS_PER_CALL["gpu"][True]),
    ("other", True, 1),
])
def test_resolved_steps_per_call_per_platform(platform, resident, want):
    cfg = train_lib.TrainConfig(num_steps=10_000, log_every=10_000)
    assert cfg.resolved_steps_per_call(resident, platform) == want
    # capped by the log cadence and the run length; explicit values win
    short = train_lib.TrainConfig(num_steps=5, log_every=3)
    assert short.resolved_steps_per_call(resident, platform) == min(want, 3)
    fixed = train_lib.TrainConfig(steps_per_call=7)
    assert fixed.resolved_steps_per_call(resident, platform) == 7


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_placement(env_dir, tmp_path, monkeypatch):
    from gpvae_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / env_dir))
    try:
        got = compile_cache.enable_compile_cache()
        if env_dir is None:
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert got == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            # JAX reads the variable itself; nothing else is set
            assert got == str(tmp_path / env_dir)
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


_NO_FLAX = """
import sys
for name in ("flax", "flax.linen", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib
import jax
jax.config.update("jax_platforms", "cpu")
importlib.import_module({module!r})
if {module!r} == "gpvae_tpu.train":
    import numpy as np
    from gpvae_tpu import train
    from gpvae_tpu.data import Batcher, generate_toy_data, toy_to_masked_batch
    from gpvae_tpu.models import GPVAE, GPVAEConfig
    data = generate_toy_data(jax.random.key(0), 4, t=6)
    batch = toy_to_masked_batch({{k: np.asarray(v) for k, v in data.items()}})
    model = GPVAE(GPVAEConfig(latent_dim=2, obs_dim=15, time_len=6))
    cfg = train.TrainConfig(num_steps=2, log_every=1,
                            checkpoint_dir=sys.argv[1])
    state, log = train.fit(model, Batcher(batch, 2), cfg, verbose=False)
    assert int(state.step) == 2 and np.isfinite(log.rows[-1]["loss"])
    assert train.CheckpointManager(sys.argv[1]).latest_step() == 2
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("flax", "orbax")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""


@pytest.mark.parametrize("module", [
    "gpvae_tpu.train", "gpvae_tpu.models", "gpvae_tpu.parallel",
])
def test_main_path_runs_without_flax_and_orbax(module, tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_FLAX.format(module=module),
         str(tmp_path / "ckpt")],
        cwd=repo, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
