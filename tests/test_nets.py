"""Plain-JAX encoder/decoder nets: the params layout every preset builds,
dense and conv forwards against fp64 numpy oracles, transposed-conv
shapes, and the reference initializers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpvae_tpu import configs, nets
from gpvae_tpu.models import GPVAE
from gpvae_tpu.utils import reference_math


def _expected_layout(cfg) -> dict:
    """Sub-module names per side, written from the config rules (not from
    the implementation): linen numbering, heads named."""
    heads = ["mean_head"] + (["log_var_head"] if cfg.needs_log_var else [])
    if cfg.encoder == "dense":
        enc = [f"Dense_{i}" for i in range(4)] + heads
    else:
        enc = [f"Conv_{i}" for i in range(6)] + heads
    if cfg.decoder == "dense":
        dec = [f"Dense_{i}" for i in range(4)] + ["logits_head"]
    else:
        n_up = {64: 5, 28: 2}[cfg.image_shape[0]]
        dec = (["Dense_0"] + [f"ConvTranspose_{i}" for i in range(n_up)]
               + ["logits_head"])
    top = {"encoder_net", "decoder_net"}
    if cfg.posterior != "diag" and cfg.learn_posterior_lengthscales:
        top.add("posterior_log_ls")
    if cfg.prior != "standard" and cfg.learn_prior_lengthscales:
        top.add("prior_log_ls")
    return {"top": top, "enc": set(enc), "dec": set(dec)}


def _example_x(cfg, b=2, t=3):
    if cfg.encoder == "conv":
        return jnp.zeros((b, t) + cfg.image_shape, jnp.float32)
    return jnp.zeros((b, t, cfg.obs_dim), jnp.float32)


@pytest.mark.parametrize("name", sorted(configs.PRESETS))
def test_param_layout_per_preset(name):
    cfg = configs.get(name).model
    model = GPVAE(cfg)
    x = _example_x(cfg)
    params = model.init({"params": jax.random.key(0)}, x)["params"]
    want = _expected_layout(cfg)
    assert set(params) == want["top"]
    assert set(params["encoder_net"]) == want["enc"]
    assert set(params["decoder_net"]) == want["dec"]
    for side in ("encoder_net", "decoder_net"):
        for layer in params[side].values():
            assert set(layer) == {"kernel", "bias"}
            assert layer["kernel"].dtype == jnp.float32
            assert layer["bias"].shape == layer["kernel"].shape[-1:]
    z = cfg.latent_dim
    assert params["encoder_net"]["mean_head"]["kernel"].shape[-1] == z
    assert params["decoder_net"]["Dense_0"]["kernel"].shape[0] == z
    for key in ("posterior_log_ls", "prior_log_ls"):
        if key in params:
            assert params[key].shape == (z,)
    # the forward runs on the layout it initialized
    logits = model.apply({"params": params}, jnp.zeros((1, 2, 3, z)),
                         method="decode")
    assert logits.shape[:3] == (1, 2, 3)


def test_initializers_match_reference():
    """truncated-normal(0.1) kernels within 2 sigma, 0.1 biases
    (src/Models/syndata/GP_VAE_syn_data.py:9-13)."""
    cfg = configs.get("full_gp_dynamic").model
    params = GPVAE(cfg).init(jax.random.key(1), _example_x(cfg))["params"]
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    kern = np.concatenate([np.asarray(v).ravel() for p, v in leaves
                           if p[-1].key == "kernel"])
    bias = np.concatenate([np.asarray(v).ravel() for p, v in leaves
                           if p[-1].key == "bias"])
    assert np.abs(kern).max() <= 0.2 + 1e-6
    assert 0.08 < kern.std() < 0.1
    assert abs(kern.mean()) < 1e-3
    np.testing.assert_array_equal(bias, np.float32(0.1))


@pytest.mark.parametrize("part", ["encoder", "encoder_log_var", "decoder"])
def test_dense_nets_vs_fp64(part):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 15))
    key = jax.random.key(3)
    if part == "decoder":
        net = nets.DenseDecoder(15)
        x = x[:, :2]
        params = net.init(key, jnp.asarray(x, jnp.float32))
        got = [net(params, jnp.asarray(x, jnp.float32))]
        want = [reference_math.ref_mlp_forward(
            params, x, [f"Dense_{i}" for i in range(4)], "logits_head",
            final_sigmoid=False)]
    else:
        with_lv = part == "encoder_log_var"
        net = nets.DenseEncoder(2, with_log_var=with_lv)
        params = net.init(key, jnp.asarray(x, jnp.float32))
        out = net(params, jnp.asarray(x, jnp.float32))
        got = list(out) if with_lv else [out]
        layers = [f"Dense_{i}" for i in range(4)]
        want = [reference_math.ref_mlp_forward(params, x, layers, head,
                                               final_sigmoid=False)
                for head in (["mean_head", "log_var_head"] if with_lv
                             else ["mean_head"])]
    for g, w in zip(got, want):
        assert g.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5, atol=1e-6)


def _np_conv(x, w, b, stride, pad):
    """fp64 NHWC x HWIO cross-correlation with explicit (lo, hi) padding."""
    kh, kw = w.shape[:2]
    xp = np.pad(x, ((0, 0), pad[0], pad[1], (0, 0)))
    oh = (xp.shape[1] - kh) // stride + 1
    ow = (xp.shape[2] - kw) // stride + 1
    out = np.zeros((x.shape[0], oh, ow, w.shape[-1]))
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, i:i + stride * oh:stride, j:j + stride * ow:stride]
            out += np.einsum("nhwc,cd->nhwd", patch, w[i, j])
    return out + b


def _np_conv_same_s2(x, w, b):
    """XLA SAME at stride 2: output ceil(n/2), padding split low-first."""
    pads = []
    for n in x.shape[1:3]:
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads.append((total // 2, total - total // 2))
    return _np_conv(x, w, b, 2, pads)


def _np_conv_transpose_same(x, w, b, stride):
    """lax.conv_transpose SAME (kernel not flipped): dilate the input by
    the stride, pad (2, 1) at stride 2 or (1, 1) at stride 1, correlate."""
    if stride == 2:
        n, h, wd, c = x.shape
        up = np.zeros((n, 2 * h - 1, 2 * wd - 1, c))
        up[:, ::2, ::2] = x
        x, pad = up, (2, 1)
    else:
        pad = (1, 1)
    return _np_conv(x, w, b, 1, (pad, pad))


def _relu(v):
    return np.maximum(v, 0.0)


def _np_conv_encoder(p, x):
    h = x
    for i in range(6):
        c = p[f"Conv_{i}"]
        h = _relu(_np_conv_same_s2(h, np.asarray(c["kernel"], np.float64),
                                   np.asarray(c["bias"], np.float64)))
    h = h.reshape(h.shape[0], -1)
    m = p["mean_head"]
    return h @ np.asarray(m["kernel"], np.float64) + np.asarray(m["bias"])


def _np_conv_decoder(p, z, size):
    d = p["Dense_0"]
    h = _relu(z @ np.asarray(d["kernel"], np.float64) + np.asarray(d["bias"]))
    seed = 1 if size == 64 else 7
    h = h.reshape(h.shape[0], seed, seed, -1)
    n_up = 5 if size == 64 else 2
    for i in range(n_up):
        c = p[f"ConvTranspose_{i}"]
        h = _relu(_np_conv_transpose_same(
            h, np.asarray(c["kernel"], np.float64), np.asarray(c["bias"]), 2))
    c = p["logits_head"]
    return _np_conv_transpose_same(
        h, np.asarray(c["kernel"], np.float64), np.asarray(c["bias"]),
        2 if size == 64 else 1)


@pytest.mark.parametrize("size", [64, 28])
def test_conv_encoder_vs_fp64(size):
    rng = np.random.default_rng(size)
    x = (rng.random((2, size, size, 1)) < 0.3).astype(np.float64)
    net = nets.ConvEncoder(8)
    params = net.init(jax.random.key(4), jnp.asarray(x, jnp.float32))
    got = np.asarray(net(params, jnp.asarray(x, jnp.float32)))
    want = _np_conv_encoder(params, x)
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("size", [64, 28])
def test_conv_decoder_vs_fp64(size):
    rng = np.random.default_rng(size + 1)
    z = rng.standard_normal((2, 8))
    net = nets.ConvDecoder((size, size, 1))
    params = net.init(jax.random.key(5), jnp.asarray(z, jnp.float32))
    got = np.asarray(net(params, jnp.asarray(z, jnp.float32)))
    want = _np_conv_decoder(params, z, size)
    assert got.shape == (2, size, size, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("size,seed,ups", [(64, 1, 6), (28, 7, 2)])
def test_conv_decoder_seed_and_doublings(size, seed, ups):
    """64 seeds at 1x1x512 and doubles six times (the last in the head);
    28 seeds at 7x7x64 and doubles twice, the head at stride 1."""
    net = nets.ConvDecoder((size, size, 1))
    params = net.init(jax.random.key(6), jnp.zeros((1, 4)))
    width = params["Dense_0"]["kernel"].shape[1]
    assert width == seed * seed * (512 if size == 64 else 64)
    h = jnp.zeros((3, seed, seed, width // (seed * seed)))
    shapes = [h.shape[1]]
    n_up = sum(k.startswith("ConvTranspose_") for k in params)
    for i in range(n_up):
        h = nets._conv_transpose(params[f"ConvTranspose_{i}"], h, 2)
        shapes.append(h.shape[1])
    head = 2 if size == 64 else 1
    h = nets._conv_transpose(params["logits_head"], h, head)
    shapes.append(h.shape[1])
    assert h.shape == (3, size, size, 1)
    assert shapes[-1] == size and shapes[0] == seed
    assert sum(b == 2 * a for a, b in zip(shapes, shapes[1:])) == ups
