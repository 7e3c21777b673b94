"""The port's LAION serving against the JAX package, on the CPU.

``experiments/conditional_diffusion_laion.py::make_laion_sampler`` on the
committed ``checkpoints/laion_diffusion_1000ep`` against JAX's
``make_laion_sampler`` (DDIM-10 chains, plain and guided with eta noise,
JAX's draws handed to the port through ``x_init`` / ``noise_stream``), the
four prompts' labelled grid against JAX's ``save_image_grid`` (PIL's
default font), and ``python -m tinydiffusion_torch.generate_laion``: the
committed checkpoint served with ``--dump-dir`` and ``--repeat``, the EMA
shadow and guidance of a caption-dropout checkpoint, its parser errors, a
checkpoint trained on CLIP embeddings, and one whose codec is the SD-VAE.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import write_synthetic_clip
from tests.test_torch_diffusion import _same_tables
from tests.test_torch_sampler import _draws
from tinydiffusion_tpu.compat.latent_codec import LinearPatchCodec as JaxCodec
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.experiments import conditional_diffusion_laion as jax_exp
from tinydiffusion_tpu.io.checkpoint import restore_weights
from tinydiffusion_tpu.models.unet_latent import LatentUNet as JaxLatentUNet
from tinydiffusion_tpu.obs.images import save_image_grid as jax_save_image_grid
from tinydiffusion_torch import generate_laion
from tinydiffusion_torch.compat.clip import CLIPTextEncoder
from tinydiffusion_torch.compat.latent_codec import LinearPatchCodec
from tinydiffusion_torch.compat.sdvae import AutoencoderKL, SDVAECodec
from tinydiffusion_torch.compat.text_encoder import HashTextEncoder
from tinydiffusion_torch.experiments import conditional_diffusion_laion as exp
from tinydiffusion_torch.io.checkpoint import load_sidecar, load_weights_arrays, save_weights
from tinydiffusion_torch.io.from_jax import state_dict_by_name
from tinydiffusion_torch.models.unet_latent import LatentUNet
from tinydiffusion_torch.obs import images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "checkpoints", "laion_diffusion_1000ep")
PROMPTS = exp.SAMPLE_PROMPTS
N, STEPS = 4, 10
# Decoded images in [0, 1] after a float32 DDIM-10 chain of the full-width
# UNet: each forward differs in summation order only (~1e-5 on eps, within
# the forward test's 1e-4), carried through 10 steps and the linear decode.
CHAIN_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("guidance, eta", [(1.0, 0.0), (2.0, 1.0)])
def test_ddim_chain_matches_jax(guidance, eta):
    """DDIM-10 on the four prompts in float32, forward and chain, plain and
    with guidance 2 against the empty-string embedding (one doubled-batch
    forward a step) and eta 1 (a noise draw a step): JAX's sampler from a
    key, the port's with that key's draws."""
    codec_state = load_sidecar(CHECKPOINT)["metadata"]["codec_state"]
    jcodec, codec = JaxCodec(), LinearPatchCodec()
    jcodec.load_state_dict(codec_state)
    codec.load_state_dict(codec_state)
    encoder = HashTextEncoder()
    embeds, null = encoder.encode(PROMPTS), encoder.encode([""])[0]
    jmodel = JaxLatentUNet()
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 4)), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, 768))))
    variables = restore_weights(CHECKPOINT, dict(shapes))
    jschedule = JaxSchedule.linear(1000)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_exp.make_laion_sampler(
        jmodel, jschedule, jcodec, N, 32, 4, jnp.float32, guidance_scale=guidance,
        null_embed=jnp.asarray(null), method="ddim", sample_steps=STEPS, eta=eta)(
        variables["params"], variables["batch_stats"], key, jnp.asarray(embeds)))
    x_init, zs, _ = _draws(key, (N, 32, 32, 4), STEPS, eta > 0, False)

    model = LatentUNet()
    model.load_state_dict(state_dict_by_name(load_weights_arrays(CHECKPOINT)))
    sampler = exp.make_laion_sampler(
        model.eval(), _same_tables(jschedule), codec, N, 32, 4, guidance_scale=guidance,
        null_embed=torch.from_numpy(null), method="ddim", sample_steps=STEPS, eta=eta)
    got = sampler(None, torch.from_numpy(embeds), x_init=_nchw(x_init),
                  noise_stream=torch.stack([_nchw(z) for z in zs]) if zs else None)
    assert got.shape == (N, 3, 256, 256) and 0 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(exp.to_nhwc(got), want, atol=CHAIN_ATOL, rtol=0)


def test_prompt_grid_equals_jax_byte_for_byte(tmp_path):
    """The 2x2 grid of 256² tiles labelled with the four prompts: the pixels
    JAX's grid writes through PIL's default font."""
    tiles = np.random.default_rng(2).uniform(0, 1, (4, 256, 256, 3)).astype(np.float32)
    jax_save_image_grid(tiles, str(tmp_path / "jax.png"), nrow=2, normalize=False,
                        labels=PROMPTS)
    images.save_image_grid(tiles, str(tmp_path / "port.png"), nrow=2, normalize=False,
                           labels=PROMPTS)
    np.testing.assert_array_equal(images.read_png(str(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


def _cli(tmp_path, *flags):
    return generate_laion.main(["--device", "cpu", "--out", str(tmp_path / "out.png"), *flags])


def test_cli_serves_the_committed_checkpoint(tmp_path):
    """DDIM-3 on two prompts: the grid (labelled) and, with ``--dump-dir``
    and ``--repeat 2``, each sample as a PNG, the first batch the grid's."""
    prompts = ["a photo of a dog", "a photo of a cow"]
    out = _cli(tmp_path, "--checkpoint", CHECKPOINT, "--sampler", "ddim", "--sample-steps", "3",
               "--prompt", prompts[0], "--prompt", prompts[1], "--dump-dir",
               str(tmp_path / "dump"), "--repeat", "2")
    assert out["forwards"] == 3 and out["prompts"] == prompts
    assert out["images"].shape == (2, 3, 256, 256)
    assert [os.path.basename(p) for p in out["dumped"]] == [
        "sample_000_00.png", "sample_000_01.png", "sample_001_00.png", "sample_001_01.png"]
    first = images.read_png(out["dumped"][0])
    np.testing.assert_array_equal(
        first, (np.clip(exp.to_nhwc(out["images"])[0], 0, 1) * 255).astype(np.uint8))
    assert not np.array_equal(first, images.read_png(out["dumped"][2]))  # another seed
    grid = images.read_png(str(tmp_path / "out.png"))
    assert grid.shape == (2 + 1 * 258, 2 + 2 * 258, 3)


def _variant(tmp_path, name: str, ema: bool, **config) -> str:
    """The committed checkpoint copied to ``tmp_path / name`` with its
    sidecar's config changed and, with ``ema``, an EMA shadow of half the
    params in the npz."""
    path = str(tmp_path / name)
    with open(CHECKPOINT + ".json") as f:
        sidecar = json.load(f)
    sidecar["config"].update(config)
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    if not ema:
        shutil.copy(CHECKPOINT + ".npz", path + ".npz")
        return path
    flat = load_weights_arrays(CHECKPOINT)
    flat.update({"ema_" + k: v * 0.5 for k, v in list(flat.items()) if k.startswith("params/")})
    save_weights(path, flat)
    return path


def test_cli_serves_the_ema_shadow_and_guidance(tmp_path):
    """A sidecar with ``ema_decay`` serves the npz's ``ema_params``; one with
    ``caption_dropout`` takes ``--guidance-scale``, a forward at twice the
    batch a step."""
    ema_path = _variant(tmp_path, "ema", ema=True, ema_decay=0.999, caption_dropout=0.1)
    plain_path = _variant(tmp_path, "plain", ema=False, caption_dropout=0.1)
    flags = ["--sampler", "ddim", "--sample-steps", "2", "--prompt", PROMPTS[0]]
    ema = _cli(tmp_path, "--checkpoint", ema_path, *flags)
    guided = _cli(tmp_path, "--checkpoint", ema_path, *flags, "--guidance-scale", "2.0")
    plain = _cli(tmp_path, "--checkpoint", plain_path, *flags)
    assert ema["forwards"] == guided["forwards"] == 2
    assert not torch.equal(ema["images"], plain["images"])
    assert not torch.equal(ema["images"], guided["images"])


@pytest.mark.parametrize("config, flags, match", [
    ({}, ["--guidance-scale", "2.0"], "--caption-dropout"),
    ({"ema_decay": 0.999}, [], "ema_params"),
])
def test_cli_parser_errors(tmp_path, capsys, config, flags, match):
    path = _variant(tmp_path, "variant", ema=False, **config)
    with pytest.raises(SystemExit):
        _cli(tmp_path, "--checkpoint", path, *flags)
    assert match in capsys.readouterr().err


def test_cli_refuses_a_sidecar_without_its_codec_basis(tmp_path, capsys):
    path = _variant(tmp_path, "variant", ema=False)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    del sidecar["metadata"]["codec_state"]
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    with pytest.raises(SystemExit):
        _cli(tmp_path, "--checkpoint", path)
    assert "codec_state" in capsys.readouterr().err


def test_cli_serves_a_clip_checkpoint(tmp_path):
    """A checkpoint trained by ``run`` with ``text_encoder="clip"`` (a
    synthetic CLIP-L directory, two steps on the CPU) served by the CLI:
    ``load_laion_checkpoint`` builds CLIP from the sidecar's
    ``clip_local_dir`` on the asked device, and the prompts' embeddings the
    chain reads are CLIP's."""
    clip_dir = tmp_path / "clip"
    clip_dir.mkdir()
    write_synthetic_clip(str(clip_dir), seed=5)
    out = tmp_path / "run"
    exp.run(exp.LaionDiffusionConfig(
        device="cpu", num_epochs=1, max_steps_per_epoch=2, batch_size=2, n_records=12,
        image_size=64, log_every=1, num_timesteps=4, compute_dtype="float32",
        sample_every_batches=0, sample_every_epoch=False, text_encoder="clip",
        clip_local_dir=str(clip_dir), out_dir=str(out), model_save_path=str(out / "ckpt"),
        image_cache_dir=str(out / "laion_cache"), failed_urls_cache=str(out / "failed.json")))
    loaded = generate_laion.load_laion_checkpoint(str(out / "ckpt"), "cpu")
    encoder = loaded["text_encoder"]
    assert isinstance(encoder, CLIPTextEncoder) and encoder.device == torch.device("cpu")
    prompts = ["a photo of a horse", "a red cow"]
    want = CLIPTextEncoder.from_local(*(str(clip_dir / f) for f in (
        "clip_text.pth", "vocab.json", "merges.txt")), device="cpu").encode(prompts)
    np.testing.assert_array_equal(encoder.encode(prompts), want)
    served = _cli(tmp_path, "--checkpoint", str(out / "ckpt"), "--sampler", "ddim",
                  "--sample-steps", "2", "--prompt", prompts[0], "--prompt", prompts[1])
    assert served["forwards"] == 2 and served["images"].shape == (2, 3, 64, 64)
    assert torch.isfinite(served["images"]).all()


def test_cli_serves_an_sd_codec_checkpoint_without_a_basis(tmp_path, monkeypatch):
    """A sidecar whose codec is the SD-VAE needs no ``codec_state``: the
    codec (here a tiny random one standing in for ``from_pretrained``, which
    needs diffusers) decodes the chain's latents, 2x up at its two widths."""
    path = _variant(tmp_path, "sd", ema=False, latent_codec="sd")
    with open(path + ".json") as f:
        sidecar = json.load(f)
    del sidecar["metadata"]["codec_state"]
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    torch.manual_seed(0)
    tiny = {"block_out_channels": (16, 32), "layers_per_block": 1, "latent_channels": 4,
            "norm_num_groups": 4}
    codec = SDVAECodec(AutoencoderKL(**tiny))
    names = []
    monkeypatch.setattr(generate_laion, "get_latent_codec",
                        lambda name, image_size: names.append(name) or codec)
    served = _cli(tmp_path, "--checkpoint", path, "--sampler", "ddim", "--sample-steps", "2",
                  "--prompt", PROMPTS[0])
    assert names == ["sd"] and served["images"].shape == (1, 3, 64, 64)
    assert torch.isfinite(served["images"]).all()
