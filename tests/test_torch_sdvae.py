"""The port's SD-VAE codec against the JAX package, on the CPU.

``compat/sdvae.py``: the ``AutoencoderKL``'s keys and shapes against the
vendored SD v1.4 manifest (``tests/fixtures/sd_v1_4_vae_state_dict.json``),
the encoder's moments and the decoder against ``vae_encode_moments`` /
``vae_decode`` on JAX's conversion of the same weights, at the JAX tests'
tiny config and at v1.4's widths on 32² images, ``gaussian_sample`` on JAX's
own draw, the codec's encode and decode against ``SDVAEFlaxCodec``, a
diffusers-named state dict (``tests/torch_sdvae_ref.py``) loaded ``strict``,
``io/from_jax.py``'s ``sdvae_from_jax``, and ``get_latent_codec("sd")``.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_sdvae_ref import AutoencoderKLRef
from tinydiffusion_tpu.compat import sdvae as jax_sdvae
from tinydiffusion_torch.compat import latent_codec, sdvae
from tinydiffusion_torch.io.from_jax import sdvae_from_jax

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TINY_VAE_CFG = {"block_out_channels": (16, 32), "layers_per_block": 1, "latent_channels": 4,
                "norm_num_groups": 4}
# float32 convolutions, GroupNorms and the mid block's softmax in another
# summation order, through up to ~30 layers; moments and images of order 1.
# As tight as the JAX package's own SD-VAE parity test (tests/test_pretrained_seams.py).
ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vae(config: dict, seed: int) -> sdvae.AutoencoderKL:
    torch.manual_seed(seed)
    return sdvae.AutoencoderKL(**config).eval()


def _nhwc(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _nchw(x) -> np.ndarray:
    return np.asarray(x).transpose(0, 3, 1, 2)


def test_state_dict_is_the_v1_4_manifest():
    """At SD_VAE_CONFIG the port's keys and shapes are the upstream
    checkpoint's 248, 83 653 863 parameters."""
    with open(os.path.join(FIXTURES, "sd_v1_4_vae_state_dict.json")) as f:
        manifest = {k: tuple(v) for k, v in json.load(f).items()}
    with open(os.path.join(FIXTURES, "sd_v1_4_vae_config.json")) as f:
        config = json.load(f)
    assert tuple(config["block_out_channels"]) == sdvae.SD_VAE_CONFIG["block_out_channels"]
    for key in ("layers_per_block", "latent_channels", "norm_num_groups"):
        assert config[key] == sdvae.SD_VAE_CONFIG[key]
    assert config["scaling_factor"] == sdvae.SD_SCALING_FACTOR
    with torch.device("meta"):
        model = sdvae.AutoencoderKL()
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == manifest and len(got) == 248
    assert sum(int(np.prod(s)) for s in got.values()) == 83_653_863


@pytest.mark.parametrize("config, size", [(TINY_VAE_CFG, 16), (sdvae.SD_VAE_CONFIG, 32)],
                         ids=["tiny", "v1_4"])
def test_moments_and_decode_match_jax(config, size):
    """The encoder's moments of (2, 3, S, S) images and the decoder's images
    of (2, 4, S/f, S/f) latents against JAX's functions on
    ``convert_diffusers_vae`` of the same weights; the tree mapped back by
    ``sdvae_from_jax`` is the same state dict."""
    model = _vae(config, seed=0)
    tree = jax_sdvae.convert_diffusers_vae(model.state_dict())
    f = 2 ** (len(config["block_out_channels"]) - 1)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    z = rng.standard_normal((2, 4, size // f, size // f)).astype(np.float32)
    with torch.no_grad():
        moments = model.encode_moments(torch.from_numpy(x)).numpy()
        images = model.decode(torch.from_numpy(z)).numpy()
    want_m = _nchw(jax_sdvae.vae_encode_moments(tree, _nhwc(x), config))
    want_x = _nchw(jax_sdvae.vae_decode(tree, _nhwc(z), config))
    assert moments.shape == want_m.shape == (2, 8, size // f, size // f)
    assert images.shape == want_x.shape == (2, 3, size, size)
    np.testing.assert_allclose(moments, want_m, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(images, want_x, atol=ATOL, rtol=RTOL)
    back = sdvae_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert set(back) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key


def test_gaussian_sample_matches_jax_on_its_draw():
    """``gaussian_sample`` with JAX's standard normal (its key's draw,
    transposed to NCHW) against JAX's: mean + exp(logvar / 2) * noise with
    logvar clamped to [-30, 20] (the moments reach past both ends); the mode
    without noise or generator; a generator's draw is the one its seed gives."""
    rng = np.random.default_rng(2)
    moments = rng.standard_normal((3, 8, 4, 4)).astype(np.float32) * 4
    moments[:, 4:, 0, 0], moments[:, 4:, 1, 1] = -60.0, 25.0
    key = jax.random.PRNGKey(5)
    want = _nchw(jax_sdvae.gaussian_sample(_nhwc(moments), key))
    noise = _nchw(jax.random.normal(key, (3, 4, 4, 4)))
    got = sdvae.gaussian_sample(torch.from_numpy(moments), noise=torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    mode = sdvae.gaussian_sample(torch.from_numpy(moments))
    np.testing.assert_array_equal(mode.numpy(), moments[:, :4])
    np.testing.assert_array_equal(mode.numpy(),
                                  _nchw(jax_sdvae.gaussian_sample(_nhwc(moments), None)))
    drawn = sdvae.gaussian_sample(torch.from_numpy(moments),
                                  generator=torch.Generator().manual_seed(9))
    again = torch.randn((3, 4, 4, 4), generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(drawn, sdvae.gaussian_sample(torch.from_numpy(moments),
                                                            noise=again), atol=0, rtol=0)


def test_codec_encode_and_decode_match_jax_codec():
    """``SDVAECodec`` against ``SDVAEFlaxCodec`` from one diffusers-named
    state dict (``tests/torch_sdvae_ref.py``'s replica, loaded ``strict``):
    the scaled sample on JAX's draw, the scaled mode, and the decode of the
    scaled latents. A state dict that lacks a key raises."""
    torch.manual_seed(3)
    ref = AutoencoderKLRef(**TINY_VAE_CFG).eval()
    codec = sdvae.SDVAECodec.from_torch_state_dict(ref.state_dict(), TINY_VAE_CFG)
    jcodec = jax_sdvae.SDVAEFlaxCodec.from_torch_state_dict(ref.state_dict(), TINY_VAE_CFG)
    assert codec.scaling_factor == jcodec.scaling_factor == 0.18215
    x = np.random.default_rng(4).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = _nchw(jcodec.encode(_nhwc(x), key=key))
    noise = torch.from_numpy(_nchw(jax.random.normal(key, (2, 8, 8, 4))).copy())
    got = codec.encode(torch.from_numpy(x), noise=noise)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    mode = codec.encode(torch.from_numpy(x))
    np.testing.assert_allclose(mode.numpy(), _nchw(jcodec.encode(_nhwc(x))), atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        np.testing.assert_allclose(mode.numpy() / 0.18215,
                                   ref.encode_moments(torch.from_numpy(x))[:, :4].numpy(),
                                   atol=ATOL, rtol=RTOL)
    decoded = codec.decode(got)
    np.testing.assert_allclose(decoded.numpy(), _nchw(jcodec.decode(jnp.asarray(_nhwc(
        got.numpy())))), atol=ATOL, rtol=RTOL)
    assert not any(p.requires_grad for p in codec.vae.parameters()) and not codec.vae.training
    state = dict(ref.state_dict())
    del state["decoder.conv_out.bias"]
    with pytest.raises(RuntimeError, match="decoder.conv_out.bias"):
        sdvae.SDVAECodec.from_torch_state_dict(state, TINY_VAE_CFG)


def test_get_latent_codec_sd_reaches_from_pretrained(monkeypatch):
    """``"sd"`` goes to ``SDVAECodec.from_pretrained``, which raises
    ``ImportError`` without diffusers (refused here, so nothing reaches for
    the network); ``"patch"`` and ``"auto"`` stay the patch codec, whose
    encode takes and ignores the SD codec's noise and generator."""
    monkeypatch.setitem(sys.modules, "diffusers", None)
    with pytest.raises(ImportError, match="diffusers"):
        latent_codec.get_latent_codec("sd")
    patch = latent_codec.get_latent_codec("auto", image_size=64)
    assert isinstance(patch, latent_codec.LinearPatchCodec)
    x = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (2, 3, 64, 64)).astype(
        np.float32))
    assert torch.equal(patch.encode(x, noise=torch.ones(2, 4, 8, 8),
                                    generator=torch.Generator().manual_seed(0)), patch.encode(x))
    with pytest.raises(ValueError, match="latent_codec"):
        latent_codec.get_latent_codec("vqgan")
