"""Per-phase step-time budget for the t1024 dense training step (VERDICT r3
missing #1 / next #2): where do the ~5 ms of a T=1024 B=8 shared-grid train
step go?

Phases timed separately, each under the saturated device-side fori_loop /
scan ruler (>= 300 ms of device work per host sync, barrier-chained):

  full_step        value_and_grad(ELBO) + Adam update      (the product)
  fwd_bwd          value_and_grad(ELBO) only (no optimizer)
  fwd              ELBO forward only
  chol_fwd         chol_gram_bank forward (the [1, 2Z, T, T] stacked bank)
  chol_fwd_bwd     grad through the bank (Cholesky VJP + gram pullback)
  kl_fwd           gp.gp_kl forward on fixed factors
  kl_fwd_bwd       grad of gp.gp_kl wrt (mu, l_q, l_p)
  nets_fwd_bwd     encoder+decoder forward+backward, no GP terms
  sample           gp.gp_sample einsum

Derived: chol_bwd ~= chol_fwd_bwd - chol_fwd; kl_bwd ~= kl_fwd_bwd - kl_fwd.

Run: python benchmarks/prof_train_phases.py
"""
from __future__ import annotations

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

import bench
from gpvae_tpu import elbo as elbo_lib, gp
from gpvae_tpu.models import GPVAE, GPVAEConfig
from gpvae_tpu.train import TrainConfig, TrainState, create_train_state

T, B, Z = 1024, 8, 2


def _data():
    rng = np.random.default_rng(0)
    x = (rng.random((B, T, 15)) < 0.4).astype(np.float32)
    times = np.broadcast_to(
        np.arange(T, dtype=np.float32) * (60.0 / T), (B, T)
    ).copy()
    mask = np.ones((B, T), bool)
    return jnp.asarray(x), jnp.asarray(times), jnp.asarray(mask)


def sat_time(fn, operands, inner, reps=3, label=""):
    """Median seconds per op for ``fn(*operands)`` under a barrier-chained
    fori_loop of ``inner`` iterations."""

    @jax.jit
    def run(*ops):
        def body(_, acc):
            chained = jax.lax.optimization_barrier(tuple(ops) + (acc,))
            out = fn(*chained[:-1])
            return chained[-1] + out
        return jax.lax.fori_loop(0, inner, body, jnp.float32(0.0))

    t0 = time.perf_counter()
    float(run(*operands))
    compile_s = time.perf_counter() - t0
    dt = bench.timed_median(lambda: run(*operands), reps) / inner
    print(f"{label:>14}: {dt*1e3:8.3f} ms/op   (compile {compile_s:.0f}s, "
          f"{inner} inner)", flush=True)
    return dt


def main():
    print(f"backend: {jax.default_backend()}", flush=True)
    x, times, mask = _data()
    cfg = GPVAEConfig(
        latent_dim=Z, obs_dim=15, time_len=T,
        prior="gp", posterior="gp",
        prior_lengthscales=(9.0, 3.0), posterior_lengthscales=(9.0, 3.0),
        encoder="dense", decoder="dense",
        shared_time_grid=True, structured_prior="dense",
    )
    model = GPVAE(cfg)
    batch0 = {"x": x, "times": times, "mask": mask}
    state, tx = create_train_state(model, batch0, TrainConfig())
    params = state.params
    sched = elbo_lib.BetaSchedule()
    key = jax.random.key(3)
    results = {}

    # --- full train step via scan (state-threaded; the production shape) --
    def one_step(state, b):
        rng_key, sk = jax.random.split(state.rng)
        beta = sched(state.step)

        def loss_fn(p):
            return model.apply(
                {"params": p}, b["x"], b["times"], b["mask"],
                beta=beta, rngs={"sample": sk},
            ).loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        u, os_ = tx.update(grads, state.opt_state, state.params)
        return TrainState(params=optax.apply_updates(state.params, u),
                          opt_state=os_, step=state.step + 1,
                          rng=rng_key), loss

    n_stack = 96
    stacked = {
        "x": jnp.broadcast_to(x, (n_stack,) + x.shape),
        "times": jnp.broadcast_to(times, (n_stack,) + times.shape),
        "mask": jnp.broadcast_to(mask, (n_stack,) + mask.shape),
    }

    @jax.jit
    def chunk(state, xs):
        state, losses = jax.lax.scan(one_step, state, xs)
        return state, losses[-1]

    t0 = time.perf_counter()
    state2, loss = chunk(state, stacked)
    print(f"full-step compile+warm {time.perf_counter()-t0:.0f}s "
          f"loss={float(loss):.2f}", flush=True)
    box = {"s": state2}

    def once():
        box["s"], loss = chunk(box["s"], stacked)
        return loss

    dt = bench.timed_median(once, 3) / n_stack
    print(f"{'full_step':>14}: {dt*1e3:8.3f} ms/op   (scan x{n_stack})",
          flush=True)
    results["full_step"] = dt

    # --- fwd_bwd (no optimizer) -------------------------------------------
    def fwd_bwd(p, xx):
        def loss_fn(p):
            return model.apply(
                {"params": p}, xx, times, mask,
                beta=0.5, rngs={"sample": key},
            ).loss
        loss, grads = jax.value_and_grad(loss_fn)(p)
        return loss + sum(jnp.sum(g) * 1e-9 for g in
                          jax.tree_util.tree_leaves(grads))

    results["fwd_bwd"] = sat_time(fwd_bwd, (params, x), 96, label="fwd_bwd")

    # --- fwd only -----------------------------------------------------------
    def fwd(p, xx):
        return model.apply(
            {"params": p}, xx, times, mask, beta=0.5,
            rngs={"sample": key},
        ).loss

    results["fwd"] = sat_time(fwd, (params, x), 192, label="fwd")

    # --- covariance bank: fwd and fwd+bwd -----------------------------------
    ls_all = jnp.asarray([9.0, 3.0, 9.0, 3.0], jnp.float32)

    def chol_fwd(ls):
        l = gp.chol_gram_bank(times[:1], ls)
        return jnp.sum(l[..., 0, :1]) + jnp.sum(
            jnp.log(jnp.diagonal(l[..., :2, :2], axis1=-2, axis2=-1))
        )

    results["chol_fwd"] = sat_time(
        chol_fwd, (ls_all,), 256, label="chol_fwd"
    )

    def chol_fwd_bwd(ls):
        def f(ls):
            l = gp.chol_gram_bank(times[:1], ls)
            # a dense cotangent over the factor (like the KL terms produce)
            return jnp.sum(l * 1e-3) + jnp.sum(
                jnp.log(jnp.diagonal(l, axis1=-2, axis2=-1))
            )
        v, g = jax.value_and_grad(f)(ls)
        return v + jnp.sum(g)

    results["chol_fwd_bwd"] = sat_time(
        chol_fwd_bwd, (ls_all,), 96, label="chol_fwd_bwd"
    )

    # --- KL: fwd and fwd+bwd -------------------------------------------------
    l_bank = gp.chol_gram_bank(times[:1], ls_all)
    l_q0, l_p0 = l_bank[:, :Z], l_bank[:, Z:]
    rngn = np.random.default_rng(1)
    mu = jnp.asarray(rngn.standard_normal((B, T, Z)), jnp.float32)

    def kl_fwd(mu, l_q, l_p):
        return jnp.sum(gp.gp_kl(mu, l_q, l_p))

    results["kl_fwd"] = sat_time(
        kl_fwd, (mu, l_q0, l_p0), 192, label="kl_fwd"
    )

    def kl_fwd_bwd(mu, l_q, l_p):
        v, gs = jax.value_and_grad(kl_fwd, argnums=(0, 1, 2))(mu, l_q, l_p)
        return v + sum(jnp.sum(g) * 1e-9 for g in gs)

    results["kl_fwd_bwd"] = sat_time(
        kl_fwd_bwd, (mu, l_q0, l_p0), 96, label="kl_fwd_bwd"
    )

    # --- nets only -----------------------------------------------------------
    def nets_fwd_bwd(p, xx):
        def f(p):
            mean = model.apply({"params": p}, xx, method=GPVAE.encode)
            logits = model.apply({"params": p}, mean, method=GPVAE.decode)
            return jnp.sum(
                elbo_lib.bernoulli_nll(logits[None], xx, mask)
            )
        v, g = jax.value_and_grad(f)(p)
        return v + sum(jnp.sum(x) * 1e-9 for x in
                       jax.tree_util.tree_leaves(g))

    results["nets_fwd_bwd"] = sat_time(
        nets_fwd_bwd, (params, x), 192, label="nets_fwd_bwd"
    )

    # --- sampler ---------------------------------------------------------------
    def sample(mu, l_q):
        z = gp.gp_sample(key, mu, l_q, 1, mask)
        return jnp.sum(z[..., 0, :1])

    results["sample"] = sat_time(sample, (mu, l_q0), 512, label="sample")

    print("\n--- derived budget (ms) ---")
    ms = {k: v * 1e3 for k, v in results.items()}
    print(f"chol_bwd ~ {ms['chol_fwd_bwd'] - ms['chol_fwd']:.3f}")
    print(f"kl_bwd   ~ {ms['kl_fwd_bwd'] - ms['kl_fwd']:.3f}")
    print(f"optimizer+glue ~ {ms['full_step'] - ms['fwd_bwd']:.3f}")
    print(f"accounted fwd: chol {ms['chol_fwd']:.3f} + kl {ms['kl_fwd']:.3f} "
          f"+ nets/2 + sample {ms['sample']:.3f}  vs fwd {ms['fwd']:.3f}")
    print({k: round(v, 3) for k, v in ms.items()})


if __name__ == "__main__":
    main()
