"""The GP-VAE model zoo as one configurable plain-JAX model.

The reference implements its seven model variants as whole-file copies
(SURVEY.md §2.2); here one ``GPVAE`` module covers the full capability
matrix via ``GPVAEConfig``:

| reference script                         | prior     | posterior      | nets  |
|------------------------------------------|-----------|----------------|-------|
| Vanilla_VAE.py                           | standard  | diag           | conv  |
| VAE_GPprior_diag_cov.py                  | gp (l=1)  | diag           | conv  |
| Full_GP_VAE_fixed_for_MovMnist.py        | gp learn  | gp learn       | conv  |
| Full_GP_VAE_dynamic_time.py              | gp (l=1)  | gp learn       | conv  |
| syndata/GP_VAE_syn_data.py (+_VM)        | gp [9,3]  | gp learn [9,3] | dense |
| syndata/GP_VAE_mnist_from_syndata.py     | gp (l=1)  | gp learn       | conv  |
| GP_recog_VAE_prior.py                    | standard  | gp_plus_diag   | conv  |

(see configs.py for the named presets.)

Time grids are always a static ``[B, T]`` array plus a boolean mask — fixed
grids are just a constant-times/all-true-mask special case, so the reference's
separate fixed-time and dynamic-time codepaths collapse into one.

Deliberate deltas from the reference:
* lengthscales are parameterized in log space (always positive; the
  reference's raw tf.Variables can wander negative);
* all randomness flows through an explicit ``rngs={"sample": key}``;
* the recognition model's KL defaults to the *exact* KL of its sampling
  distribution; set ``reference_recog_kl=True`` for behavioral parity with
  the reference's mismatched standard KL (src/Models/GP_recog_VAE_prior.py:
  65-70 vs :159-160, SURVEY.md §7 "quirks").
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from gpvae_tpu import elbo as elbo_lib
from gpvae_tpu import gp, nets

PRIORS = ("standard", "gp", "sparse_gp")
POSTERIORS = ("diag", "gp", "gp_plus_diag")
NETS = ("dense", "conv")


@dataclasses.dataclass(frozen=True)
class GPVAEConfig:
    latent_dim: int = 2
    obs_dim: int = 15
    time_len: int = 45
    prior: str = "gp"
    posterior: str = "gp"
    encoder: str = "dense"
    decoder: str = "dense"
    image_shape: tuple[int, int, int] = (64, 64, 1)
    kernel: str = "rbf"
    noise: float = 1e-3
    # observation model: "bernoulli" (the reference's only choice — decoder
    # outputs logits) or "gaussian" (decoder outputs means; unit variance)
    likelihood: str = "bernoulli"
    # scalar entries broadcast over latent dims; len == latent_dim otherwise
    prior_lengthscales: tuple[float, ...] = (9.0, 3.0)
    posterior_lengthscales: tuple[float, ...] = (9.0, 3.0)
    learn_prior_lengthscales: bool = False
    learn_posterior_lengthscales: bool = True
    num_samples: int = 1
    reference_recog_kl: bool = False
    # fixed/uniform time grids: factor each latent's gram ONCE and share it
    # across the batch (the reference fixed-time models tile one gram,
    # src/Models/Full_GP_VAE_fixed_for_MovMnist.py:99) — requires all
    # sequences to share `times` row 0 and a full mask
    shared_time_grid: bool = False
    # structured GP prior on uniform shared grids (the gram is symmetric
    # Toeplitz): "toeplitz" replaces the dense prior factorization with an
    # O(T^2) Durbin scan + Gohberg-Semencul inverse (gp.gp_kl_toeplitz_prior;
    # BASELINE config 3, T=1024); "dense" forces the dense path.  "auto"
    # resolves at the first non-jit boundary (train.fit /
    # fit_data_parallel / the CLI call models.resolve_structured_prior
    # with the first batch's times).  "auto" resolves to DENSE everywhere:
    # the sequential Durbin scan is the structured path's floor, and the
    # crossover against the dense factorization has not been measured on
    # the GPU; "toeplitz" remains the explicit O(T^2)-memory/work option.
    # Under jit the grid cannot be validated, hence the host-side
    # resolution step.
    structured_prior: str = "auto"
    # sparse inducing-point (FITC) prior for long sequences (sparse.py)
    num_inducing: int = 64
    inducing_time_range: tuple[float, float] | None = None
    # matmul precision of the DENSE encoder/decoder: "highest" (default —
    # a reduced-precision f32 dot, TF32 on the GPU, would dominate the
    # shipped config's deviation from the fp64 reference math against the
    # 1e-4 north star, and these matmuls are ~15x32 so HIGHEST costs
    # nothing) or "default" (the backend default).  Conv nets always use
    # the backend default — their FLOPs are real.
    dense_precision: str = "highest"

    def __post_init__(self):
        if self.prior not in PRIORS:
            raise ValueError(f"prior must be one of {PRIORS}")
        if self.posterior not in POSTERIORS:
            raise ValueError(f"posterior must be one of {POSTERIORS}")
        if self.encoder not in NETS or self.decoder not in NETS:
            raise ValueError(f"nets must be one of {NETS}")
        if self.likelihood not in ("bernoulli", "gaussian"):
            raise ValueError("likelihood must be bernoulli or gaussian")
        if self.posterior == "gp_plus_diag" and self.prior != "standard":
            raise ValueError(
                "gp_plus_diag posterior pairs with the standard prior "
                "(reference GP_recog_VAE_prior.py)"
            )
        if self.prior == "sparse_gp":
            if self.posterior != "diag":
                raise ValueError(
                    "sparse_gp prior requires a diagonal posterior (the "
                    "full-GP posterior is itself O(T^3))"
                )
            if self.inducing_time_range is None:
                raise ValueError(
                    "sparse_gp prior needs inducing_time_range=(t0, t1)"
                )
        if self.structured_prior not in ("auto", "dense", "toeplitz"):
            raise ValueError(
                "structured_prior must be auto, dense, or toeplitz"
            )
        if self.dense_precision not in ("highest", "default"):
            raise ValueError("dense_precision must be highest or default")
        if self.structured_prior == "toeplitz" and not self.shared_time_grid:
            raise ValueError(
                "the toeplitz structured prior requires shared_time_grid "
                "(one uniform grid for the whole batch)"
            )

    def _ls_tuple(self, raw: tuple[float, ...]) -> tuple[float, ...]:
        if len(raw) == 1:
            return raw * self.latent_dim
        if len(raw) != self.latent_dim:
            raise ValueError(
                f"lengthscales {raw} incompatible with Z={self.latent_dim}"
            )
        return raw

    @property
    def needs_log_var(self) -> bool:
        return self.posterior in ("diag", "gp_plus_diag")

    @property
    def needs_times(self) -> bool:
        return (
            self.prior in ("gp", "sparse_gp")
            or self.posterior in ("gp", "gp_plus_diag")
        )

    @property
    def toeplitz_prior(self) -> bool:
        if self.prior != "gp" or not self.shared_time_grid:
            return False
        return self.structured_prior == "toeplitz"


def check_structured_grid(config: GPVAEConfig, times, mask=None) -> None:
    """Host-side validation for the Toeplitz structured prior.

    ``gp.gp_kl_toeplitz_prior`` builds the prior row from ``config.time_len``
    and the first grid step — under jit it cannot detect a non-arithmetic
    grid or a runtime T that disagrees with the config, and would silently
    compute a wrong prior.  Call this at a non-jit boundary (train.fit and
    the CLI do) with the first batch's ``times [B, T]``.
    """
    if not config.toeplitz_prior:
        return
    import numpy as np
    t_arr = np.asarray(times)
    if t_arr.ndim != 2:
        raise ValueError(f"times must be [B, T], got {t_arr.shape}")
    t = t_arr.shape[1]
    if t != config.time_len:
        raise ValueError(
            f"structured_prior='toeplitz': batch T={t} != config.time_len="
            f"{config.time_len}; the prior row is built at time_len"
        )
    row = t_arr[0].astype(np.float64)
    steps = np.diff(row)
    if steps.size and not np.allclose(steps, steps[0], rtol=1e-4, atol=1e-6):
        raise ValueError(
            "structured_prior='toeplitz' requires an arithmetic (uniform) "
            f"time grid; got steps in [{steps.min():.6g}, {steps.max():.6g}]"
        )
    if mask is not None and not np.all(np.asarray(mask)):
        raise ValueError(
            "structured_prior='toeplitz' requires a full mask (shared "
            "uniform grid, no missing steps)"
        )


def resolve_structured_prior(
    config: GPVAEConfig, times, mask=None
) -> GPVAEConfig:
    """Resolve ``structured_prior='auto'`` against the first real batch.

    Host-side (non-jit) companion to :func:`check_structured_grid`:
    explicit settings are validated and returned unchanged; ``auto``
    becomes ``'dense'`` (the structured path's sequential Durbin scan is
    its floor — see GPVAEConfig.structured_prior).  Explicit
    ``'toeplitz'`` keeps the O(T^2) structured option.  Train.fit /
    fit_data_parallel call this with the first batch; library users
    composing their own loops should too (under jit a wrong structured
    prior is silent).
    """
    if config.structured_prior != "auto":
        check_structured_grid(config, times, mask)
        return config
    return dataclasses.replace(config, structured_prior="dense")


@dataclasses.dataclass
class ELBOOutput:
    loss: jnp.ndarray          # scalar: mean over batch of (nll + beta*kl)
    nll: jnp.ndarray           # [B]
    kl: jnp.ndarray            # [B]
    beta: jnp.ndarray
    latent_mean: jnp.ndarray   # [B, T, Z]
    latent_sample: jnp.ndarray  # [S, B, T, Z]
    logits: jnp.ndarray        # [S, B, T, ...]
    aux: dict[str, Any]


jax.tree_util.register_dataclass(
    ELBOOutput,
    data_fields=["loss", "nll", "kl", "beta", "latent_mean", "latent_sample",
                 "logits", "aux"],
    meta_fields=[],
)


class GPVAE:
    """Configurable GP-VAE; see module docstring for the capability matrix.

    A linen-shaped interface over plain JAX: ``init(rngs, x, times, mask)``
    returns ``{"params": tree}`` and ``apply({"params": p}, *args,
    method=..., rngs={"sample": key})`` runs ``__call__`` (or the named
    method, or an unbound ``GPVAE.<method>``) on a copy bound to ``p``.
    The params tree holds ``encoder_net``, ``decoder_net`` and, when
    learnable, ``posterior_log_ls`` / ``prior_log_ls``.
    """

    def __init__(self, config: GPVAEConfig):
        self.config = config
        self._params: dict | None = None
        self._rng: jax.Array | None = None

    @property
    def encoder_net(self):
        c = self.config
        if c.encoder == "dense":
            return nets.DenseEncoder(
                c.latent_dim, with_log_var=c.needs_log_var,
                precision=self._dense_precision,
            )
        return nets.ConvEncoder(c.latent_dim, with_log_var=c.needs_log_var)

    @property
    def decoder_net(self):
        c = self.config
        if c.decoder == "dense":
            return nets.DenseDecoder(
                c.obs_dim, precision=self._dense_precision
            )
        return nets.ConvDecoder(c.image_shape)

    @property
    def _dense_precision(self):
        if self.config.dense_precision == "highest":
            return jax.lax.Precision.HIGHEST
        return None

    def _initial_log_ls(self, raw) -> jnp.ndarray:
        return jnp.log(jnp.asarray(self.config._ls_tuple(raw), jnp.float32))

    def init(self, rngs, x, times=None, mask=None) -> dict:
        """Fresh parameters for inputs shaped like ``x [B, T, ...]``.

        ``rngs`` is ``{"params": key, ...}`` or a bare key; only the
        ``params`` stream is used (``times``/``mask`` are accepted for
        call-compatibility with ``apply``)."""
        c = self.config
        key = rngs["params"] if isinstance(rngs, dict) else rngs
        k_enc, k_dec = jax.random.split(key)
        b, t = x.shape[:2]
        params = {
            "encoder_net": self.encoder_net.init(
                k_enc, x.reshape((b * t,) + x.shape[2:])
            ),
            "decoder_net": self.decoder_net.init(
                k_dec, jnp.zeros((1, c.latent_dim), jnp.float32)
            ),
        }
        if (c.posterior in ("gp", "gp_plus_diag")
                and c.learn_posterior_lengthscales):
            params["posterior_log_ls"] = self._initial_log_ls(
                c.posterior_lengthscales
            )
        if c.prior in ("gp", "sparse_gp") and c.learn_prior_lengthscales:
            params["prior_log_ls"] = self._initial_log_ls(
                c.prior_lengthscales
            )
        return {"params": params}

    def apply(self, variables: dict, *args,
              method: str | Callable | None = None, rngs=None, **kwargs):
        bound = copy.copy(self)
        bound._params = variables["params"]
        if rngs is not None:
            bound._rng = rngs["sample"] if isinstance(rngs, dict) else rngs
        if method is None:
            fn = type(self).__call__
        elif isinstance(method, str):
            fn = getattr(type(self), method)
        else:
            fn = method
        return fn(bound, *args, **kwargs)

    def make_rng(self, name: str) -> jax.Array:
        if self._rng is None:
            raise ValueError(
                f"this call draws samples: pass rngs={{{name!r}: key}}"
            )
        return self._rng

    @property
    def posterior_log_ls(self) -> jnp.ndarray:
        c = self.config
        if c.learn_posterior_lengthscales:
            return self._params["posterior_log_ls"]
        return self._initial_log_ls(c.posterior_lengthscales)

    @property
    def prior_log_ls(self) -> jnp.ndarray:
        c = self.config
        if c.learn_prior_lengthscales:
            return self._params["prior_log_ls"]
        return self._initial_log_ls(c.prior_lengthscales)

    # -- pieces (each independently callable via .apply(method=...),
    #    the capability the reference hacks with get_tensor_by_name
    #    re-entry, SURVEY.md §3.4) ------------------------------------

    def encode(self, x: jnp.ndarray):
        """[B, T, ...] -> mean [B, T, Z] (and log_var if configured)."""
        b, t = x.shape[:2]
        flat = x.reshape((b * t,) + x.shape[2:])
        out = self.encoder_net(self._params["encoder_net"], flat)
        if self.config.needs_log_var:
            mean, log_var = out
            return (
                mean.reshape(b, t, -1),
                log_var.reshape(b, t, -1),
            )
        return out.reshape(b, t, -1)

    def decode(self, z: jnp.ndarray) -> jnp.ndarray:
        """[S, B, T, Z] (or [B, T, Z]) -> logits with matching leading dims."""
        lead = z.shape[:-1]
        flat = z.reshape((-1, z.shape[-1]))
        logits = self.decoder_net(self._params["decoder_net"], flat)
        return logits.reshape(lead + logits.shape[1:])

    def _grid(self, times, mask):
        """With shared_time_grid, factor one gram bank (leading dim 1) and
        let gp.* broadcast it over the batch."""
        if self.config.shared_time_grid:
            return times[:1], None
        return times, mask

    def posterior_chol(self, times, mask):
        times, mask = self._grid(times, mask)
        return gp.chol_gram_bank(
            times, jnp.exp(self.posterior_log_ls), mask=mask,
            kernel=self.config.kernel, noise=self.config.noise,
        )

    def prior_chol(self, times, mask):
        times, mask = self._grid(times, mask)
        return gp.chol_gram_bank(
            times, jnp.exp(self.prior_log_ls), mask=mask,
            kernel=self.config.kernel, noise=self.config.noise,
        )

    def inducing_times(self):
        c = self.config
        lo, hi = c.inducing_time_range
        return jnp.linspace(lo, hi, c.num_inducing)

    def chol_banks(self, times, mask):
        """All Cholesky factors this config needs, in ONE batched call.

        When both the posterior and the prior are GPs, their per-latent
        lengthscales are stacked into a single 2Z-wide bank so the gram
        build and the batched Cholesky run once per step instead of twice.
        Returns ``{"l_q": ..., "l_p": ...}`` (absent keys for non-GP sides).
        """
        c = self.config
        times, mask = self._grid(times, mask)
        want_q = c.posterior in ("gp", "gp_plus_diag")
        want_p = c.prior == "gp"
        out: dict[str, Any] = {}
        if want_p and c.toeplitz_prior:
            # structured prior: O(T) first rows instead of dense factors —
            # the [Z, T, T] prior gram bank never exists (gp.gp_kl_toeplitz_
            # prior consumes the rows directly)
            from gpvae_tpu import kernels as kernels_lib
            step = times[0, 1] - times[0, 0]
            out["prior_row"] = kernels_lib.toeplitz_row(
                c.time_len, step, jnp.exp(self.prior_log_ls),
                kernel=c.kernel, noise=c.noise,
            )
            want_p = False
        if want_q and want_p:
            ls = jnp.concatenate([
                jnp.exp(self.posterior_log_ls), jnp.exp(self.prior_log_ls)
            ])
            l_all = gp.chol_gram_bank(
                times, ls, mask=mask, kernel=c.kernel, noise=c.noise,
            )
            out["l_q"] = l_all[:, : c.latent_dim]
            out["l_p"] = l_all[:, c.latent_dim:]
        elif want_q:
            out["l_q"] = gp.chol_gram_bank(
                times, jnp.exp(self.posterior_log_ls), mask=mask,
                kernel=c.kernel, noise=c.noise,
            )
        elif want_p:
            out["l_p"] = gp.chol_gram_bank(
                times, jnp.exp(self.prior_log_ls), mask=mask,
                kernel=c.kernel, noise=c.noise,
            )
        return out

    def sample_posterior(self, x, times, mask, num_samples, aux=None):
        """Encode + reparameterized draw -> (z [S,B,T,Z], mean, aux)."""
        c = self.config
        key = self.make_rng("sample")
        if c.needs_log_var:
            mean, log_var = self.encode(x)
        else:
            mean = self.encode(x)
            log_var = None
        if mask is not None:
            m = mask.astype(mean.dtype)[..., None]
            mean = mean * m
        if aux is None:
            aux = self.chol_banks(times, mask)
        if c.posterior == "diag":
            z = gp.diag_sample(key, mean, log_var, num_samples, mask)
        elif c.posterior == "gp":
            z = gp.gp_sample(key, mean, aux["l_q"], num_samples, mask)
        else:  # gp_plus_diag
            z = gp.recog_sample(
                key, mean, log_var, aux["l_q"], num_samples, mask
            )
        return z, mean, log_var, aux

    def kl(self, mean, log_var, times, mask, aux):
        """Per-sequence KL [B] for the configured prior/posterior pair."""
        c = self.config
        if c.prior == "sparse_gp":
            from gpvae_tpu import sparse
            kl_bz = sparse.fitc_diag_kl(
                mean, log_var, times, self.inducing_times(),
                jnp.exp(self.prior_log_ls), mask=mask, kernel=c.kernel,
                noise=c.noise,
            )
            return jnp.sum(kl_bz, axis=-1)
        if c.prior == "gp":
            if "prior_row" in aux:  # Toeplitz structured prior
                if c.posterior == "gp":
                    kl_bz = gp.gp_kl_toeplitz_prior(
                        mean, aux["l_q"], aux["prior_row"]
                    )
                elif c.posterior == "diag":
                    kl_bz = gp.gp_prior_diag_kl_toeplitz(
                        mean, log_var, aux["prior_row"]
                    )
                else:
                    raise NotImplementedError
                return jnp.sum(kl_bz, axis=-1)
            l_p = (
                aux["l_p"] if "l_p" in aux else self.prior_chol(times, mask)
            )
            if c.posterior == "gp":
                kl_bz = gp.gp_kl(mean, aux["l_q"], l_p, mask)
            elif c.posterior == "diag":
                kl_bz = gp.gp_prior_diag_kl(mean, log_var, l_p, mask)
            else:
                raise NotImplementedError
            return jnp.sum(kl_bz, axis=-1)
        # standard N(0, I) prior
        if c.posterior == "diag":
            return gp.standard_kl(mean, log_var, mask)
        if c.posterior == "gp_plus_diag":
            if c.reference_recog_kl:
                return gp.standard_kl(mean, log_var, mask)
            return jnp.sum(
                gp.recog_gp_kl(mean, log_var, aux["l_q"], mask), axis=-1
            )
        # standard prior + full-GP posterior: KL vs identity factor
        b, z, t, _ = aux["l_q"].shape
        eye = jnp.broadcast_to(
            jnp.eye(t, dtype=aux["l_q"].dtype), aux["l_q"].shape
        )
        return jnp.sum(gp.gp_kl(mean, aux["l_q"], eye, mask), axis=-1)

    def __call__(
        self,
        x: jnp.ndarray,
        times: jnp.ndarray | None = None,
        mask: jnp.ndarray | None = None,
        *,
        beta: jnp.ndarray | float = 1.0,
        num_samples: int | None = None,
        feature_mask: jnp.ndarray | None = None,
    ) -> ELBOOutput:
        """``feature_mask [B, T, ...]`` marks per-feature observations
        (missing-pixel imputation, healing-MNIST regime); missing features
        must be zero-filled in ``x`` and contribute no likelihood."""
        c = self.config
        s = num_samples if num_samples is not None else c.num_samples
        if times is None:
            if c.needs_times:
                raise ValueError(f"{c.prior}/{c.posterior} model needs times")
            times = jnp.broadcast_to(
                jnp.arange(x.shape[1], dtype=jnp.float32), x.shape[:2]
            )
        z, mean, log_var, aux = self.sample_posterior(x, times, mask, s)
        kl_b = self.kl(mean, log_var, times, mask, aux)
        logits = self.decode(z)
        if c.likelihood == "bernoulli":
            nll_b = elbo_lib.bernoulli_nll(logits, x, mask, feature_mask)
        else:
            nll_b = elbo_lib.gaussian_nll(logits, x, mask, feature_mask)
        beta = jnp.asarray(beta, nll_b.dtype)
        loss = jnp.mean(nll_b + beta * kl_b)
        return ELBOOutput(
            loss=loss,
            nll=nll_b,
            kl=kl_b,
            beta=beta,
            latent_mean=mean,
            latent_sample=z,
            logits=logits,
            aux={
                k: v for k, v in aux.items()
            } | ({"log_var": log_var} if log_var is not None else {}),
        )
