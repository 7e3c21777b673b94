"""The port's latent serving against the JAX package, on the CPU.

``experiments/common.py::load_latent_checkpoint`` and
``make_latent_pixel_sampler`` on the committed ``latent_diffusion_best``
(MLP UNet) and ``diffusion_transformer_best`` (DiT) checkpoints against
JAX's, for DDPM, DDIM and DPM-Solver++ (JAX's chain noise rebuilt from its
key splits and handed to the port as ``x_init`` / ``noise_stream``), and the
latent branch of ``tinydiffusion_torch.generate`` with its parser errors.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_sampler import _draws
from tinydiffusion_tpu.experiments import common as jax_common
from tinydiffusion_torch import generate
from tinydiffusion_torch.experiments.common import (
    load_latent_checkpoint,
    make_latent_pixel_sampler,
)
from tinydiffusion_torch.obs import images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {
    "mlp_unet": os.path.join(REPO, "checkpoints", "latent_diffusion_best"),
    "dit": os.path.join(REPO, "checkpoints", "diffusion_transformer_best"),
}
VAE_CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_mnist_best")
CFG_CHECKPOINT = os.path.join(REPO, "checkpoints", "conditional_cfg_ema_best")
# Decoded samples in [-1, 1] from float32 chains of the same denoiser on the
# same noise: summation order carried through up to 20 steps and the decoder.
# Read 3.3e-6 to 1.5e-5, and 1.1e-4 for the DiT's DPM++-10, whose
# second-order steps amplify what the LayerNorms round.
F32_ATOL = 3e-4
# The committed recipe's bfloat16 denoiser (JAX's model dtype against the
# port's autocast) under a float32 DPM++-10 chain: bfloat16 rounding of
# different intermediates carried through 10 steps; mean |diff| of the
# decoded pixels, which are in [-1, 1] (read 0.0041 and 0.0049, largest
# single pixels 0.19 and 0.28).
BF16_MEAN_ABS = 0.02
N = 4


@pytest.fixture(autouse=True)
def _at_the_repo_root(monkeypatch):
    """The committed sidecars record their VAE as a path from the repo root,
    as JAX's do."""
    monkeypatch.chdir(REPO)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops; the suite runs several workers on a few cores. One torch
    thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _copy(tmp_path, backbone: str, **sidecar) -> str:
    """The committed checkpoint with its sidecar's config changed."""
    path = str(tmp_path / backbone)
    shutil.copy(CHECKPOINTS[backbone] + ".npz", path + ".npz")
    with open(CHECKPOINTS[backbone] + ".json") as f:
        meta = json.load(f)
    meta["config"].update(vae_checkpoint=VAE_CHECKPOINT, **sidecar)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path


@pytest.mark.parametrize("backbone", ["mlp_unet", "dit"])
def test_load_latent_checkpoint_rebuilds_the_committed_checkpoints(backbone):
    loaded = load_latent_checkpoint(CHECKPOINTS[backbone], device="cpu")
    assert loaded["cfg"]["backbone"] == backbone and loaded["step"] == 34125
    assert loaded["latent_dim"] == 20 and loaded["num_classes"] == 10
    assert loaded["compute_dtype"] == torch.bfloat16 and loaded["prediction"] == "eps"
    assert not loaded["use_ema"] and loaded["schedule"].num_timesteps == 1000
    assert not loaded["model"].training and not loaded["vae"].training
    for name, p in loaded["model"].named_parameters():
        assert loaded["params"][name] is p or torch.equal(loaded["params"][name], p)
    assert type(loaded["model"]).__name__ == ("DiT" if backbone == "dit" else "MLPUNetLatent")


def test_load_latent_checkpoint_refuses_a_missing_vae_and_a_pixel_checkpoint(tmp_path):
    path = _copy(tmp_path, "mlp_unet")
    with open(path + ".json") as f:
        meta = json.load(f)
    meta["config"]["vae_checkpoint"] = str(tmp_path / "nowhere" / "vae")
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(FileNotFoundError, match="vae_checkpoint="):
        load_latent_checkpoint(path, device="cpu")
    assert load_latent_checkpoint(path, vae_checkpoint=VAE_CHECKPOINT, device="cpu")["vae"]
    with pytest.raises(ValueError, match="not a latent-family checkpoint"):
        load_latent_checkpoint(CFG_CHECKPOINT, device="cpu")


@pytest.mark.parametrize("backbone", ["mlp_unet", "dit"])
@pytest.mark.parametrize("method, T, steps", [("ddpm", 20, 20), ("ddim", 1000, 10),
                                              ("dpmpp", 1000, 10)])
def test_latent_pixel_sampler_matches_jax_in_float32(tmp_path, backbone, method, T, steps):
    """The committed weights with the sidecar's compute dtype set to float32
    (and T = 20 for DDPM): JAX's ``make_latent_pixel_sampler`` with a key,
    the port's with JAX's draws of that key."""
    path = _copy(tmp_path, backbone, compute_dtype="float32", num_timesteps=T)
    y = np.array([7, 0, 3, 9], np.int32)
    key = jax.random.PRNGKey(3)
    jloaded = jax_common.load_latent_checkpoint(path)
    want = np.asarray(jax_common.make_latent_pixel_sampler(
        jloaded, N, method=method, sample_steps=steps)(key, y))
    x_init, zs, _ = _draws(key, (N, 20), steps, method == "ddpm", False)
    loaded = load_latent_checkpoint(path, device="cpu")
    assert loaded["compute_dtype"] == torch.float32
    got = make_latent_pixel_sampler(loaded, N, method=method, sample_steps=steps)(
        None, torch.from_numpy(y).long(), x_init=torch.from_numpy(x_init),
        noise_stream=torch.from_numpy(np.stack(zs)) if zs else None)
    assert got.shape == (N, 1, 28, 28) and -1 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("backbone", ["mlp_unet", "dit"])
def test_latent_pixel_sampler_in_the_committed_bfloat16_recipe(backbone):
    """As the checkpoints serve: a bfloat16 denoiser under a float32 chain."""
    y = np.array([7, 1, 4, 8], np.int32)
    key = jax.random.PRNGKey(5)
    jloaded = jax_common.load_latent_checkpoint(CHECKPOINTS[backbone])
    want = np.asarray(jax_common.make_latent_pixel_sampler(
        jloaded, N, method="dpmpp", sample_steps=10)(key, y))
    x_init, _, _ = _draws(key, (N, 20), 0, False, False)
    got = make_latent_pixel_sampler(load_latent_checkpoint(CHECKPOINTS[backbone], device="cpu"),
                                    N, method="dpmpp", sample_steps=10)(
        None, torch.from_numpy(y).long(), x_init=torch.from_numpy(x_init))
    diff = np.abs(got.numpy().reshape(want.shape) - want)
    assert diff.mean() <= BF16_MEAN_ABS, diff.mean()


def _main(ckpt, out, *flags):
    return generate.main(["--checkpoint", ckpt, "--device", "cpu", "--n", str(N), "--out", out,
                          *flags])


@pytest.mark.parametrize("backbone", ["mlp_unet", "dit"])
@pytest.mark.parametrize("flags, forwards", [
    (["--sampler", "dpmpp", "--sample-steps", "5", "--digit", "7"], 5),
    (["--sampler", "ddim", "--sample-steps", "4", "--eta", "1.0", "--seed", "2"], 4),
])
def test_generate_serves_a_latent_checkpoint(tmp_path, capsys, backbone, flags, forwards):
    out = str(tmp_path / "out.png")
    result = _main(CHECKPOINTS[backbone], out, *flags)
    samples = result["samples"]
    assert samples.shape == (N, 1, 28, 28) and -1 <= samples.min() and samples.max() <= 1
    assert result["forwards"] == forwards and len(result["labels"]) == N
    if "--digit" in flags:
        assert result["labels"] == [7] * N
    assert images.read_png(out).shape == (2 + 2 * 30, 2 + 2 * 30, 3)  # labelled: RGB
    printed = capsys.readouterr().out
    assert f"backbone {backbone}, step 34125" in printed
    assert f"{forwards} model forwards" in printed
    # The request is the loader's sampler on the seed's generator.
    generator = torch.Generator().manual_seed(int(flags[flags.index("--seed") + 1])
                                              if "--seed" in flags else 0)
    y = (torch.full((N,), 7) if "--digit" in flags
         else torch.randint(0, 10, (N,), generator=generator))
    sampler = make_latent_pixel_sampler(
        load_latent_checkpoint(CHECKPOINTS[backbone], device="cpu"), N,
        method=flags[1], sample_steps=int(flags[3]), eta=1.0 if "--eta" in flags else 0.0)
    assert torch.equal(sampler(generator, y), samples) and result["labels"] == y.tolist()


def test_generate_runs_the_1000_step_latent_ddpm(tmp_path):
    result = _main(CHECKPOINTS["mlp_unet"], str(tmp_path / "out.png"), "--n", "2")
    assert result["forwards"] == 1000 and result["samples"].shape == (2, 1, 28, 28)


@pytest.mark.parametrize("flags", [
    ["--guidance-scale", "2.0"],
    ["--sampler", "ddim", "--init-image", "INIT"],
    ["--inpaint-image", "INIT", "--inpaint-mask", "INIT"],
])
def test_generate_refuses_pixel_modes_on_a_latent_checkpoint(tmp_path, capsys, flags):
    init = str(tmp_path / "init.png")
    images.write_png(init, np.zeros((28, 28, 1), np.uint8))
    flags = [init if f == "INIT" else f for f in flags]
    out = tmp_path / "x.png"
    with pytest.raises(SystemExit) as exc:
        _main(CHECKPOINTS["dit"], str(out), *flags)
    assert exc.value.code == 2
    assert ("img2img/inpainting/guidance are pixel-checkpoint modes; latent checkpoints "
            "support plain sampling with any --sampler") in capsys.readouterr().err
    assert not out.exists()
