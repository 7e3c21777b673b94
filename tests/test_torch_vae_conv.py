"""The port's conv-VAE serving slice against the JAX package, on the CPU.

Same weights in both packages (JAX variables flattened to the npz keys and
carried across with ``conv_vae_state_dict``), same inputs and the same noise
``eps``, made with numpy. JAX's flash attention runs its Pallas kernel in
interpret mode; the port's runs its plain version (the CUDA kernel is held
against that plain version on the card by ``chip_smoke.py``).
"""

import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_tpu.data.laion import synthesize_image as jax_synthesize_image
from tinydiffusion_tpu.io.checkpoint import (
    _flat_items,
    _load_weights_arrays,
    _norm_key,
    restore_weights,
)
from tinydiffusion_tpu.models.vae_conv import ConvVAE as JaxConvVAE
from tinydiffusion_tpu.obs.images import make_grid as jax_make_grid
from tinydiffusion_torch.data.laion import synthesize_image
from tinydiffusion_torch.experiments.vae_laion import load_conv_vae, reconstruct
from tinydiffusion_torch.io.checkpoint import load_weights_arrays
from tinydiffusion_torch.io.from_jax import conv_transpose_weight, conv_vae_state_dict, conv_weight
from tinydiffusion_torch.models.vae_conv import ConvVAE
from tinydiffusion_torch.nn.layers import SpectralNorm
from tinydiffusion_torch.obs.images import encode_png, make_grid
from tinydiffusion_torch.ops import attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_laion_best")

# One layer, float32 on both sides: XLA's and torch's convolutions sum in
# different orders (~1e-6 relative on these widths).
LAYER_ATOL, LAYER_RTOL = 1e-5, 1e-5
# A whole model, float32 on both sides: ~30 layers of summation-order
# differences plus the JAX flash kernel's bf16x3 logits (~1e-4 on attention
# outputs); mu/logvar are O(1-10), the images are sigmoids in [0, 1].
MODEL_ATOL, MODEL_RTOL = 2e-3, 2e-3
IMAGE_ATOL = 1e-3


def _jax_apply(module, variables, *args, **kwargs):
    return np.asarray(jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args))


# --- io --------------------------------------------------------------------


def test_bf16_leaves_decode_like_ml_dtypes():
    """The port's numpy bf16 decode equals the JAX loader's ml_dtypes decode."""
    ours = load_weights_arrays(CHECKPOINT)
    theirs = _load_weights_arrays(CHECKPOINT)
    assert ours.keys() == theirs.keys()
    for k, a in theirs.items():
        want = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        assert ours[k].dtype == want.dtype, k
        np.testing.assert_array_equal(ours[k], want, err_msg=k)


def test_bridge_fills_every_state_dict_slot():
    sd = conv_vae_state_dict(load_weights_arrays(CHECKPOINT))
    model = ConvVAE()
    want = model.state_dict()
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    model.load_state_dict(sd)  # strict


def test_bridge_refuses_an_unknown_key():
    with pytest.raises(KeyError, match="no ConvVAE state_dict slot"):
        conv_vae_state_dict({"params/unknown_layer/kernel": np.zeros((2, 2), np.float32)})


# --- one layer each ----------------------------------------------------------


def _random_kernel(rng, shape):
    return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)


@pytest.mark.parametrize("case", ["conv_transpose", "sn_conv", "sn_conv_transpose"])
def test_layer_matches_flax(case):
    """flax ConvTranspose(4x4, stride 2, SAME) / SpectralNorm(Conv | ConvTranspose)
    against the port's layer, on random non-symmetric kernels. Spectral norm
    also checks the train-mode ``u`` update."""
    rng = np.random.default_rng(1)
    cin, cout = 6, 5
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)  # NHWC
    kernel = _random_kernel(rng, (4, 4, cin, cout))
    bias = rng.standard_normal(cout).astype(np.float32)
    u = rng.standard_normal((1, cout)).astype(np.float32)
    transposed = case != "sn_conv"
    if transposed:
        flax_layer = flax_nn.ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME")
        torch_layer = nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)
        weight = conv_transpose_weight(kernel)
    else:
        flax_layer = flax_nn.Conv(cout, (4, 4), strides=(2, 2), padding=1)
        torch_layer = nn.Conv2d(cin, cout, 4, stride=2, padding=1)
        weight = conv_weight(kernel)
    torch_layer.weight.data.copy_(weight)
    torch_layer.bias.data.copy_(torch.from_numpy(bias))
    params = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    if case == "conv_transpose":
        want = _jax_apply(flax_layer, {"params": params}, jnp.asarray(x))
        got = torch_layer(xt)
    else:
        wrapper = flax_nn.SpectralNorm(flax_layer)
        fresh = wrapper.init(jax.random.PRNGKey(0), jnp.asarray(x), update_stats=False)
        by_leaf = {"kernel": kernel, "bias": bias, "u": u, "sigma": np.ones((), np.float32)}
        variables = jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(by_leaf[_norm_key(p).rsplit("/", 1)[-1]]), fresh)
        want = _jax_apply(wrapper, variables, jnp.asarray(x), update_stats=False)
        _, mutated = jax.jit(lambda v, a: wrapper.apply(
            v, a, update_stats=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        (want_u,) = [np.asarray(leaf) for path, leaf in _flat_items(mutated)[0].items()
                     if path.endswith("/u")]
        sn = SpectralNorm(torch_layer)
        sn.u.copy_(torch.from_numpy(u))
        sn.eval()
        got = sn(xt)
        assert torch.equal(sn.u, torch.from_numpy(u)), "eval mode must not write u"
        sn.train()
        sn(xt)
        np.testing.assert_allclose(sn.u.numpy(), want_u, atol=LAYER_ATOL, rtol=LAYER_RTOL)
    np.testing.assert_allclose(
        got.detach().permute(0, 2, 3, 1).numpy(), want, atol=LAYER_ATOL, rtol=LAYER_RTOL)


def test_unflipped_transposed_kernel_would_be_caught():
    """The flip in conv_transpose_weight matters for a non-symmetric kernel."""
    rng = np.random.default_rng(2)
    kernel = _random_kernel(rng, (4, 4, 3, 2))
    x = torch.from_numpy(rng.standard_normal((1, 3, 5, 5)).astype(np.float32))
    flipped = F.conv_transpose2d(x, conv_transpose_weight(kernel), stride=2, padding=1)
    plain = F.conv_transpose2d(
        x, torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))),
        stride=2, padding=1)
    assert (flipped - plain).abs().max() > 1e-2


# --- the whole model ---------------------------------------------------------


@pytest.fixture(scope="module")
def small_vae():
    """JAX ConvVAE at image_size=128, randomly initialised, with gamma, the BN
    statistics and the attention logits made non-trivial; and the port's
    ConvVAE with the same weights."""
    size = 128
    jmodel = JaxConvVAE(latent_dim=128, image_size=size)
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jax.random.PRNGKey(1),
        train=False))()
    flat, _ = _flat_items(variables)
    rng = np.random.default_rng(3)
    flat = {k: np.asarray(v) for k, v in flat.items()}
    for k, v in flat.items():
        if k.endswith("/gamma"):
            flat[k] = np.full_like(v, 0.8)  # init 0 would hide the attention
        elif "_attn" in k and ("/query/" in k or "/key/" in k) and k.endswith("kernel"):
            flat[k] = 4.0 * v  # logits of several units, as a trained model has
        elif k.endswith("/mean") or (k.endswith("/bias") and "/bn" in k):
            flat[k] = 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat[_norm_key(p)]), variables)
    model = ConvVAE(latent_dim=128, image_size=size)
    model.load_state_dict(conv_vae_state_dict(flat))
    return jmodel, variables, model.eval()


def test_conv_vae_reconstruct_matches_jax(small_vae):
    """encode -> reparameterize(eps) -> decode at 128x128. enc_attn0 sees a
    64x64 map, N = 4096, so the flash dispatch runs in both packages."""
    jmodel, variables, model = small_vae
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    eps = rng.standard_normal((2, 128)).astype(np.float32)
    mu, logvar = jax.jit(lambda v, a: jmodel.apply(
        v, a, train=False, method=JaxConvVAE.encode))(variables, jnp.asarray(x))
    z = mu + jnp.asarray(eps) * jnp.exp(0.5 * logvar)
    want = _jax_apply(jmodel, variables, z, train=False, method=JaxConvVAE.decode)

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    calls = []
    orig = attention.flash_fwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "flash_fwd", lambda *a: calls.append(a[0].shape) or orig(*a))
        with torch.no_grad():
            got_mu, got_logvar = model.encode(xt)
        got = reconstruct(model, xt, torch.from_numpy(eps))
    assert (2, 4, 4096) in calls  # enc_attn0 took the flash path
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(mu), atol=MODEL_ATOL, rtol=MODEL_RTOL)
    np.testing.assert_allclose(
        got_logvar.numpy(), np.asarray(logvar), atol=MODEL_ATOL, rtol=MODEL_RTOL)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=IMAGE_ATOL)


def test_checkpoint_decode_matches_jax():
    """Full width from the committed checkpoint at 256x256: dec_attn1 sees a
    64x64 map (N = 4096, flash), dec_attn0 a 32x32 one (N = 1024, dense)."""
    jmodel = JaxConvVAE(latent_dim=128, image_size=256)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), jax.random.PRNGKey(1),
        train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables = restore_weights(CHECKPOINT, template)
    z = np.random.default_rng(5).standard_normal((1, 128)).astype(np.float32)
    want = _jax_apply(jmodel, variables, jnp.asarray(z), train=False, method=JaxConvVAE.decode)

    model = load_conv_vae(CHECKPOINT, device="cpu")
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z))
    assert got.shape == (1, 3, 256, 256)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=IMAGE_ATOL)


def test_load_conv_vae_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA device"):
        load_conv_vae(CHECKPOINT)


def test_load_conv_vae_on_the_cpu_leaves_the_tf32_flags_alone(monkeypatch):
    """TF32 is turned off only when the model goes onto a card."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    model = load_conv_vae(CHECKPOINT, device="cpu")
    assert (model.latent_dim, model.input_channels, model.image_size) == (128, 3, 256)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


# --- data and images ---------------------------------------------------------


@pytest.mark.parametrize("i,size", [(0, 64), (1, 256), (2, 33), (7, 128)])
def test_synthesize_image_matches_jax(i, size):
    img, caption = synthesize_image(i, size)
    want_img, want_caption = jax_synthesize_image(i, size)
    assert caption == want_caption
    np.testing.assert_array_equal(img, want_img)


def test_make_grid_matches_jax():
    images = np.random.default_rng(6).uniform(-1, 2, (5, 7, 9, 3)).astype(np.float32)
    for normalize in (True, False):
        np.testing.assert_array_equal(
            make_grid(images, nrow=3, normalize=normalize),
            jax_make_grid(images, nrow=3, normalize=normalize))


@pytest.mark.parametrize("channels", [1, 3])
def test_png_decodes_to_the_same_pixels(channels, tmp_path):
    from PIL import Image  # test-only: the port itself writes PNGs without PIL

    pixels = np.random.default_rng(7).integers(0, 256, (11, 13, channels), dtype=np.uint8)
    path = tmp_path / "grid.png"
    path.write_bytes(encode_png(pixels))
    with Image.open(path) as img:
        back = np.asarray(img)
    np.testing.assert_array_equal(back.reshape(pixels.shape), pixels)
