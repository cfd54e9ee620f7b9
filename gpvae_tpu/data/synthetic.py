"""Synthetic GP-draw toy data, a JAX re-implementation of the reference
generator ``gen_toy_data`` (src/gen_data/simulate_toy_data.py:7-65).

Reference semantics reproduced exactly (per-sequence):
* two latent trajectories on a ``linspace(0, xmax, 45)`` grid, drawn from
  GP(RBF, l=9, var=1) and GP(Cosine, l=3, var=0.75) (:24-28, gpflow);
* stabilized exp-normalize with the author's 0.1-smoothing:
  ``p[d] = exp(f_d - max_f) / sum_d (0.1 + exp(f_d - max_f))``, third group
  ``p2 = 1 - p0 - p1`` (:41-44);
* 15 Bernoulli observation dims in three groups of 5 sharing p0/p1/p2
  (:46-52);
* ``Poisson(0.7 * 45)`` draws *with replacement* choose timesteps to hide
  with the sentinel -1 (:53-55) — the effective hidden count is the number
  of distinct draws, reproduced here.

Differences: vectorized over all sequences in one jitted program (the
reference loops sequence-by-sequence through numpy), explicit PRNG key, and
a converter to the framework's fixed-shape masked batch format instead of
the ragged pickle + flatten pipeline (src/Models/DataHandler.py:129-156).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gpvae_tpu import kernels as kernels_lib

TOY_T = 45
TOY_OBS_DIM = 15
TOY_XMAX = 60.0
TOY_TIME_GRID = np.linspace(0.0, TOY_XMAX, TOY_T)


@functools.partial(
    jax.jit, static_argnames=("num_seqs", "t", "obs_dim", "hide_fraction")
)
def generate_toy_data(
    key: jax.Array,
    num_seqs: int,
    *,
    t: int = TOY_T,
    xmax: float = TOY_XMAX,
    obs_dim: int = TOY_OBS_DIM,
    hide_fraction: float = 0.7,
):
    """Returns dict with the reference pickle's fields in array form:

    * ``x``     ``[N, T, obs_dim]`` float32 in {0, 1} with -1 at hidden steps,
    * ``f``     ``[N, 2, T]`` latent GP draws,
    * ``p``     ``[N, 3, T]`` group probabilities,
    * ``time``  ``[T]`` the shared grid,
    * ``mask``  ``[N, T]`` bool observed-step mask (True = observed).
    """
    k_f, k_x, k_h, k_n = jax.random.split(key, 4)
    # pinned fp32: the accelerator's working precision; the jitter below
    # is sized for fp32 factorization (the x64 test env must not mask that)
    times = jnp.linspace(0.0, xmax, t, dtype=jnp.float32)

    # gpflow kernels carry no noise term; the factorization jitter must be
    # fp32-appropriate: the cosine gram is exactly rank 2 and the l=9 RBF
    # gram is near-singular, so a fp64-habit 1e-8 makes the fp32 Cholesky
    # produce NaNs (and silently all-zero Bernoulli draws)
    jitter = 1e-4 * jnp.eye(t, dtype=jnp.float32)
    k_rbf = kernels_lib.gram(times, 9.0, kernel="rbf", noise=0.0) + jitter
    k_cos = (
        0.75 * kernels_lib.gram(times, 3.0, kernel="cosine", noise=0.0)
        + jitter
    )
    l = jnp.linalg.cholesky(jnp.stack([k_rbf, k_cos]))  # [2, T, T]

    eps = jax.random.normal(k_f, (num_seqs, 2, t), dtype=jnp.float32)
    f = jnp.einsum("dij,ndj->ndi", l, eps)  # [N, 2, T]

    max_f = jnp.max(f, axis=1, keepdims=True)
    shifted = jnp.exp(f - max_f)
    denom = jnp.sum(0.1 + shifted, axis=1, keepdims=True)
    p01 = shifted / denom                       # [N, 2, T]
    p2 = 1.0 - p01.sum(axis=1, keepdims=True)   # [N, 1, T]
    p = jnp.concatenate([p01, p2], axis=1)      # [N, 3, T]

    m = obs_dim // 3
    group = jnp.repeat(jnp.arange(3), m)        # [obs_dim]
    probs = p[:, group, :]                      # [N, obs_dim, T]
    x = (
        jax.random.uniform(k_x, probs.shape) < probs
    ).astype(jnp.float32)                       # [N, obs_dim, T]

    # Poisson(0.7*T) choices WITH replacement (reference :53-55): draw T
    # indices, keep the first n_hidden of them.
    n_hidden = jnp.minimum(
        jax.random.poisson(k_n, hide_fraction * t, (num_seqs,)), t
    )
    draws = jax.random.randint(k_h, (num_seqs, t), 0, t)
    active = jnp.arange(t)[None, :] < n_hidden[:, None]
    hidden = jnp.zeros((num_seqs, t), bool)
    hidden = jax.vmap(
        lambda h, d, a: h.at[d].max(a)
    )(hidden, draws, active)
    mask = ~hidden

    x = jnp.where(mask[:, None, :], x, -1.0)
    return {
        "x": jnp.swapaxes(x, 1, 2),  # [N, T, obs_dim]
        "f": f,
        "p": p,
        "time": times,
        "mask": mask,
    }


def load_toy_file(path: str) -> dict:
    """Load a toy dataset file in any of the supported on-disk formats:

    * ``.npz`` written by ``python -m gpvae_tpu generate-data``;
    * the reference's joblib pickle ``toy_data_v3.pkl``
      (src/gen_data/simulate_toy_data.py:70-71, loaded by the reference
      trainer at src/Models/syndata/GP_VAE_syn_data.py:278) — a dict with
      ``x`` as a *list* of per-sequence ``[obs_dim, T]`` sentinel arrays,
      plus ``f``/``time``/``p``.

    Returns a dict of numpy arrays (lists stacked along a leading N axis)
    ready for :func:`toy_to_masked_batch`.
    """
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    try:
        import joblib
        data = joblib.load(path)
    except ImportError:
        import pickle
        with open(path, "rb") as f:
            data = pickle.load(f)
    out = {}
    for k, v in dict(data).items():
        arr = np.stack([np.asarray(s) for s in v]) if isinstance(
            v, (list, tuple)
        ) else np.asarray(v)
        out[k] = arr
    return out


def toy_to_masked_batch(data: dict) -> dict:
    """Convert generator output (or a reference-format pickle with
    ``x [N, obs_dim, T]`` sentinel arrays) to the framework batch format:
    ``{x [N,T,D] in {0,1}, times [N,T], mask [N,T]}`` — the static-shape
    replacement for SyntheticDataHandler's ragged pipeline
    (src/Models/DataHandler.py:129-156)."""
    x = np.asarray(data["x"])
    if x.ndim == 3 and x.shape[1] != x.shape[2] and "mask" not in data:
        # reference pickle layout [N, obs_dim, T]
        x = np.swapaxes(x, 1, 2)
    n, t, _ = x.shape
    times = np.broadcast_to(
        np.asarray(data["time"]).reshape(-1)[:t], (n, t)
    ).copy()
    if "mask" in data:
        mask = np.asarray(data["mask"])
        x_clean = np.where(mask[..., None], x, 0.0).astype(np.float32)
    else:
        # sentinel-format reference pickle: C++ ragged packer
        from gpvae_tpu.data import native
        x_clean, mask, _ = native.pack_ragged(x.astype(np.float32))
    return {
        "x": x_clean,
        "times": times.astype(np.float32),
        "mask": mask,
    }
