"""Encoder/decoder networks in plain JAX.

Re-implementations of the reference's L4 layer:

* dense MLP encoder/decoder (obs 15 <-> Z) —
  src/Models/syndata/GP_VAE_syn_data.py:15-39 (encode), :238-275 (decode),
  truncated-normal(0.1) weights / 0.1 bias init (:9-13);
* strided conv encoder / transposed-conv decoder (64x64x1 <-> Z) —
  src/Models/Full_GP_VAE_dynamic_time.py:15-58 (encode), :262-292 (decode);
* optional log-variance head for diagonal/recognition posteriors —
  src/Models/VAE_GPprior_diag_cov.py:54-62.

Each net is a frozen description with ``init(key, x) -> params`` and
``__call__(params, x)``.  Params are nested dicts laid out as linen
modules name them (``Dense_i``/``Conv_i``/``ConvTranspose_i`` numbered in
call order, plus the named heads, each holding ``kernel``/``bias``), so
checkpoints and the fp64 oracle (utils/reference_math.py) read them by
name.  Convolutions are SAME-padded with HWIO kernels.

Design deltas from the reference (deliberate):
* decoders return *logits*, not clamped sigmoid probabilities — the Bernoulli
  NLL is computed with the numerically stable log-sigmoid form instead of the
  reference's ``log(p + 1e-10)`` clamp (GP_VAE_syn_data.py:334-341);
* precision policy: the DENSE nets pin ``precision=HIGHEST`` by default.
  An f32 dot without a precision argument may run in TF32 on the GPU
  (about three decimal digits), which would dominate the shipped config's
  deviation from the fp64 reference math (1e-4 north star).  These matmuls
  are ~15x32, so HIGHEST costs nothing.  The conv nets keep the backend
  default (TF32 on the GPU): their FLOPs are real.  Flip the dense nets
  with ``GPVAEConfig(dense_precision="default")``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
from jax import lax

_HI = lax.Precision.HIGHEST

# Reference initializers (src/Models/syndata/GP_VAE_syn_data.py:9-13)
_W_INIT = jax.nn.initializers.truncated_normal(stddev=0.1)
_BIAS = 0.1

# Reference conv channel schedule (src/Models/Full_GP_VAE_dynamic_time.py:27-58)
CONV_FEATURES = (16, 32, 64, 128, 256, 512)
# Reference dense hidden schedule (src/Models/syndata/GP_VAE_syn_data.py:15-39)
DENSE_HIDDEN = (32, 32, 16, 8)

_CONV_DIMS = ("NHWC", "HWIO", "NHWC")


def _layer(key, kernel_shape) -> dict:
    return {
        "kernel": _W_INIT(key, kernel_shape, jnp.float32),
        "bias": jnp.full(kernel_shape[-1:], _BIAS, jnp.float32),
    }


def _dense(p, x, precision=None):
    return jnp.dot(x, p["kernel"], precision=precision) + p["bias"]


def _promote(x, kernel):
    # lax convolutions take one dtype (jnp.dot promotes on its own)
    dtype = jnp.result_type(x, kernel)
    return x.astype(dtype), kernel.astype(dtype)


def _conv(p, x):
    x, k = _promote(x, p["kernel"])
    return lax.conv_general_dilated(
        x, k, (2, 2), "SAME", dimension_numbers=_CONV_DIMS,
    ) + p["bias"]


def _conv_transpose(p, x, stride):
    x, k = _promote(x, p["kernel"])
    return lax.conv_transpose(
        x, k, (stride, stride), "SAME", dimension_numbers=_CONV_DIMS,
    ) + p["bias"]


def _init_layers(key, shapes: dict) -> dict:
    keys = jax.random.split(key, len(shapes))
    return {name: _layer(k, shape)
            for k, (name, shape) in zip(keys, shapes.items())}


@dataclasses.dataclass(frozen=True)
class DenseEncoder:
    """15 -> 32 -> 32 -> 16 -> 8 -> Z ReLU MLP with linear mean head
    (and optional log-variance head)."""
    latent_dim: int
    hidden: Sequence[int] = DENSE_HIDDEN
    with_log_var: bool = False
    precision: Any = _HI

    def init(self, key, x) -> dict:
        dims = (x.shape[-1],) + tuple(self.hidden)
        shapes = {f"Dense_{i}": (dims[i], dims[i + 1])
                  for i in range(len(self.hidden))}
        shapes["mean_head"] = (dims[-1], self.latent_dim)
        if self.with_log_var:
            shapes["log_var_head"] = (dims[-1], self.latent_dim)
        return _init_layers(key, shapes)

    def __call__(self, params, x):
        h = x
        for i in range(len(self.hidden)):
            h = jax.nn.relu(_dense(params[f"Dense_{i}"], h, self.precision))
        mean = _dense(params["mean_head"], h, self.precision)
        if not self.with_log_var:
            return mean
        return mean, _dense(params["log_var_head"], h, self.precision)


@dataclasses.dataclass(frozen=True)
class DenseDecoder:
    """Z -> 8 -> 16 -> 32 -> 32 -> obs_dim, returning Bernoulli logits."""
    obs_dim: int
    hidden: Sequence[int] = tuple(reversed(DENSE_HIDDEN))
    precision: Any = _HI

    def init(self, key, z) -> dict:
        dims = (z.shape[-1],) + tuple(self.hidden)
        shapes = {f"Dense_{i}": (dims[i], dims[i + 1])
                  for i in range(len(self.hidden))}
        shapes["logits_head"] = (dims[-1], self.obs_dim)
        return _init_layers(key, shapes)

    def __call__(self, params, z):
        h = z
        for i in range(len(self.hidden)):
            h = jax.nn.relu(_dense(params[f"Dense_{i}"], h, self.precision))
        return _dense(params["logits_head"], h, self.precision)


@dataclasses.dataclass(frozen=True)
class ConvEncoder:
    """64x64x1 -> six stride-2 3x3 convs (16..512) -> flatten -> Z.

    Input: ``[N, H, W, C]`` frames (callers flatten [B, T] into N)."""
    latent_dim: int
    features: Sequence[int] = CONV_FEATURES
    with_log_var: bool = False

    def init(self, key, x) -> dict:
        _, h, w, c = x.shape
        shapes = {}
        for i, feat in enumerate(self.features):
            shapes[f"Conv_{i}"] = (3, 3, c, feat)
            # SAME padding at stride 2: ceil(size / 2)
            h, w, c = -(-h // 2), -(-w // 2), feat
        shapes["mean_head"] = (h * w * c, self.latent_dim)
        if self.with_log_var:
            shapes["log_var_head"] = (h * w * c, self.latent_dim)
        return _init_layers(key, shapes)

    def __call__(self, params, x):
        h = x
        for i in range(len(self.features)):
            h = jax.nn.relu(_conv(params[f"Conv_{i}"], h))
        h = h.reshape((h.shape[0], -1))
        mean = _dense(params["mean_head"], h)
        if not self.with_log_var:
            return mean
        return mean, _dense(params["log_var_head"], h)


@dataclasses.dataclass(frozen=True)
class ConvDecoder:
    """Z -> dense -> h0 x h0 seed -> stride-2 transposed convs -> H x W
    logits (reference src/Models/Full_GP_VAE_dynamic_time.py:262-292).

    For the reference's 64x64 frames this is exactly its architecture
    (1x1x512 seed, six doublings).  Non-power-of-two sizes (e.g. 28x28
    healing-MNIST) seed at the largest odd divisor (7x7) and double from
    there."""
    image_shape: tuple[int, int, int] = (64, 64, 1)
    features: Sequence[int] = tuple(reversed(CONV_FEATURES))

    def _plan(self):
        """(seed, seed dense width, transposed-conv widths, head stride)."""
        n = len(self.features)
        # number of stride-2 doublings: 2-adic valuation, capped at the
        # reference's six layers; seed spatial size is what remains
        k = 0
        seed = self.image_shape[0]
        while seed % 2 == 0 and k < n:
            seed //= 2
            k += 1
        feats = tuple(self.features[n - k:]) or (self.features[-1],)
        if k == n:
            # the 1x1 seed holds features[0]; the head makes the last doubling
            return seed, self.features[0], feats[1:], 2
        return seed, seed * seed * self.features[n - k - 1], feats, 1

    def init(self, key, z) -> dict:
        seed, width, feats, _ = self._plan()
        shapes = {"Dense_0": (z.shape[-1], width)}
        c = width // (seed * seed)
        for i, feat in enumerate(feats):
            shapes[f"ConvTranspose_{i}"] = (3, 3, c, feat)
            c = feat
        shapes["logits_head"] = (3, 3, c, self.image_shape[-1])
        return _init_layers(key, shapes)

    def __call__(self, params, z):
        seed, width, feats, head_stride = self._plan()
        h = jax.nn.relu(_dense(params["Dense_0"], z))
        h = h.reshape((h.shape[0], seed, seed, width // (seed * seed)))
        for i in range(len(feats)):
            h = jax.nn.relu(
                _conv_transpose(params[f"ConvTranspose_{i}"], h, 2)
            )
        return _conv_transpose(params["logits_head"], h, head_stride)
