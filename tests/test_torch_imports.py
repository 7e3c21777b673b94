"""The port runs on a machine without the JAX stack.

The CUDA machines that serve the port have torch, numpy and the standard
library, and no jax, jaxlib, flax, optax, orbax, ml_dtypes or PIL. This test
stands in for that machine on the CPU: a subprocess whose import system
refuses those packages (and ``tinydiffusion_tpu``) imports every module of
``tinydiffusion_torch``, ``chip_smoke``, ``chip_flash_ab``,
``chip_decode_ab`` and ``chip_sdpa_sites``, then loads a conv-VAE from an npz
of random weights and serves it on ``device="cpu"``; another trains, samples
and checkpoints a small UNet28 on the CPU; a third trains the conv-VAE for
two steps through its ``run``; a fourth trains a small class-conditional
UNet28 for two steps through its ``run`` and serves the checkpoint with
``generate.main`` in every mode (guidance, DDIM, DPM-Solver++, img2img and
inpainting from PNGs); a fifth trains the MNIST VAE for two steps, each
latent backbone for two steps on that VAE, and serves a latent checkpoint
with ``generate.main``; a sixth trains the LAION text-conditional latent
UNet for two steps and serves it with ``python -m
tinydiffusion_torch.generate_laion``, ``--dump-dir`` included; a seventh,
with ``regex``, ``ftfy``, ``transformers``, ``diffusers`` and
``safetensors`` refused too, trains it for two steps on a synthetic CLIP-L
directory through ``from_local``, serves that checkpoint, and takes resident
LAION steps with a small SD-VAE codec; an eighth runs the FID tools and the
checkpoint importer as ``python -m`` modules (``runpy``): ``fid_eval`` on
``diffusion_final``, ``fid_eval_laion`` at 64² training its feature net and
scoring a random conv-VAE and a PNG directory, ``import_torch_checkpoint`` on
a ``.pth``.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_laion_best")
# The JAX stack and PIL, which the card's machine lacks, what the CLIP and
# SD-VAE seams of the JAX package and the reference reach for (regex, ftfy,
# transformers, diffusers and safetensors), and what JAX's LAION loader
# fetches and lists records with (requests, urllib3, datasets).
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "PIL", "tinydiffusion_tpu",
           "regex", "ftfy", "transformers", "diffusers", "safetensors", "requests", "urllib3",
           "datasets")

_REFUSE = textwrap.dedent("""
    import importlib, importlib.abc, os, pkgutil, sys

    BLOCKED = set(sys.argv[2].split(","))

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"import of {name} refused: not on the CUDA machine")
            return None

    sys.meta_path.insert(0, Refuse())
""")

_CHILD = _REFUSE + textwrap.dedent("""
    import numpy as np
    import torch

    import tinydiffusion_torch
    for mod in pkgutil.walk_packages(tinydiffusion_torch.__path__, "tinydiffusion_torch."):
        importlib.import_module(mod.name)
    import chip_smoke  # its work sits behind `if __name__ == "__main__"`
    import chip_flash_ab  # likewise
    import chip_decode_ab  # likewise
    import chip_sdpa_sites  # likewise
    # Data parallelism and the JPEG round trip: no group without torchrun's
    # variables, and no Pillow.
    from tinydiffusion_torch.data.jpeg import jpeg_round_trip
    from tinydiffusion_torch.parallel import distributed, mesh
    for var in ("RANK", "WORLD_SIZE"):
        os.environ.pop(var, None)
    assert not distributed.maybe_initialize_distributed("cpu")
    assert mesh.make_mesh_for_batch(16) is None
    assert jpeg_round_trip(np.zeros((16, 16, 3), np.uint8)).shape == (16, 16, 3)

    from tinydiffusion_torch.data.laion import synthesize_image
    from tinydiffusion_torch.experiments.vae_laion import load_conv_vae, reconstruct, sample_prior
    from tinydiffusion_torch.obs.images import save_image_grid
    from tinydiffusion_torch.ops import attention

    path = sys.argv[1]
    model = load_conv_vae(path, device="cpu")
    x = torch.from_numpy(np.stack([synthesize_image(i, 64)[0] for i in range(2)]))
    x = x.permute(0, 3, 1, 2).float() / 255.0
    eps = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 128), np.float32))
    recon = reconstruct(model, x, eps)
    prior = sample_prior(model, 2, torch.Generator().manual_seed(0))
    assert recon.shape == prior.shape == (2, 3, 64, 64)
    for t in (recon, prior):
        assert torch.isfinite(t).all() and t.min() >= 0 and t.max() <= 1
    qt = torch.randn(1, 4, 2048)
    out = attention.flash_attention_unscaled_t(qt, qt, torch.randn(1, 32, 2048))
    assert out.shape == (1, 32, 2048)
    save_image_grid(recon.permute(0, 2, 3, 1).numpy(), path + "_grid.png")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


def _random_weights_npz(path: str, image_size: int) -> None:
    """An npz in the JAX package's weights format, with the committed
    checkpoint's keys and random values, for a conv-VAE at ``image_size``."""
    rng = np.random.default_rng(0)
    flat = 256 * (image_size // 16) ** 2
    arrays, bf16 = {}, []
    with np.load(CHECKPOINT + ".npz") as z:
        for key in z.files:
            if key in ("__meta__", "step"):
                continue
            shape = z[key].shape
            if key.startswith("params/fc_") and key.endswith("kernel"):
                shape = (flat, shape[1])
            elif key == "params/decoder_input/kernel":
                shape = (shape[0], flat)
            elif key == "params/decoder_input/bias":
                shape = (flat,)
            if key.endswith("/var") or key.endswith("/sigma"):
                value = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            else:
                value = (0.05 * rng.standard_normal(shape)).astype(np.float32)
            if key.startswith("params/"):  # stored as bfloat16 bits, as the JAX saver does
                value = (value.view(np.uint32) >> 16).astype(np.uint16)
                bf16.append(key)
            arrays[key] = value
    arrays["__meta__"] = np.frombuffer(json.dumps({"bfloat16": bf16}).encode(), np.uint8)
    np.savez(path + ".npz", **arrays)
    config = {"latent_dim": 128, "input_channels": 3, "image_size": image_size}
    with open(path + ".json", "w") as f:
        json.dump({"config": config, "metadata": {}}, f)


# Two train steps of a small UNet28 (the fused q_sample's CPU path), a
# T = 5 DDPM chain, and the checkpoint written and read back.
_CHILD_TRAIN = _REFUSE + textwrap.dedent("""
    import numpy as np
    import torch

    from tinydiffusion_torch.core.schedule import DiffusionSchedule
    from tinydiffusion_torch.experiments.common import load_unet28, make_sampler
    from tinydiffusion_torch.io.checkpoint import save_checkpoint
    from tinydiffusion_torch.models.unet28 import UNet28
    from tinydiffusion_torch.train.trainer import create_train_state, make_train_step

    torch.manual_seed(0)
    model = UNet28(time_dim=32, base_width=8)
    state = create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), 0)
    step = make_train_step(DiffusionSchedule.linear(1000))
    x0 = torch.rand(4, 1, 28, 28) * 2 - 1
    losses = [step(state, x0).item() for _ in range(2)]
    assert all(np.isfinite(losses)), losses
    samples = make_sampler(model, DiffusionSchedule.linear(5), (2, 1, 28, 28))(
        torch.Generator().manual_seed(0))
    assert samples.shape == (2, 1, 28, 28) and torch.isfinite(samples).all()
    path = sys.argv[1]
    save_checkpoint(path, state, config={"time_dim": 32, "base_width": 8})
    assert not load_unet28(path, device="cpu").training
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


# Two train steps of the conv-VAE at 64x64 through ``run`` (data, step,
# eval, checkpoint, samples), on the CPU.
_CHILD_VAE_TRAIN = _REFUSE + textwrap.dedent("""
    from tinydiffusion_torch.experiments.vae_laion import VAELaionConfig, run

    path = sys.argv[1]
    result = run(VAELaionConfig(image_size=64, n_records=12, batch_size=2, epochs=1,
                                max_steps_per_epoch=2, out_dir=path + "/out",
                                checkpoint_dir=path + "/ckpt", device="cpu"))
    assert result["state"].step == 2, result["state"].step
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


# The same two steps through the CLI in bfloat16 with the set resident.
_CHILD_VAE_TRAIN_BF16 = _REFUSE + textwrap.dedent("""
    from tinydiffusion_torch.experiments import vae_laion

    path = sys.argv[1]
    vae_laion.main(["--image-size", "64", "--n-records", "12", "--batch-size", "2",
                    "--epochs", "1", "--max-steps-per-epoch", "2", "--out-dir", path + "/out",
                    "--checkpoint-dir", path + "/ckpt", "--device", "cpu",
                    "--compute-dtype", "bfloat16", "--data-placement", "device"])
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


# The conv-VAE CLI twice on one record cache: the first run fills it (cold
# reads: the synthesized bytes, each written as a quality-95 JPEG by the
# port's encoder), the second reads it warm (the port's JPEG decoder), as
# JAX's loader does; both train their two steps.
_CHILD_VAE_WARM_CACHE = _REFUSE + textwrap.dedent("""
    import numpy as np

    from tinydiffusion_torch.data.jpeg import jpeg_round_trip
    from tinydiffusion_torch.data.laion import synthesize_image
    from tinydiffusion_torch.experiments import vae_laion

    path = sys.argv[1]
    flags = ["--image-size", "64", "--n-records", "12", "--batch-size", "2", "--epochs", "1",
             "--max-steps-per-epoch", "2", "--device", "cpu", "--image-cache-dir",
             path + "/cache", "--failed-urls-cache", path + "/failed.json"]
    for run in ("cold", "warm"):
        vae_laion.main(flags + ["--out-dir", path + "/" + run, "--checkpoint-dir",
                                path + "/" + run + "_ckpt"])
        assert len(os.listdir(path + "/cache")) == 12, os.listdir(path + "/cache")
    images = vae_laion.load_images(vae_laion.VAELaionConfig(
        image_size=64, n_records=12, image_cache_dir=path + "/cache",
        failed_urls_cache=path + "/failed.json"))
    want = jpeg_round_trip(np.stack([synthesize_image(i, 64)[0] for i in range(12)]))
    assert np.array_equal(images, want)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


# Two steps of the class-conditional run() at small width (label dropout,
# EMA, the resident step, the val pass, labelled grids), then the serving
# CLI on its checkpoint in every mode, with PNG inputs from the port's encoder.
_CHILD_CONDITIONAL = _REFUSE + textwrap.dedent("""
    import numpy as np
    import torch

    from tinydiffusion_torch import generate
    from tinydiffusion_torch.experiments.conditional_diffusion import (
        ConditionalDiffusionConfig, run)
    from tinydiffusion_torch.obs.images import write_png

    torch.set_num_threads(1)  # small ops; the test suite runs beside other workers
    path = sys.argv[1]
    result = run(ConditionalDiffusionConfig(
        device="cpu", num_epochs=1, max_steps_per_epoch=2, batch_size=4, log_every=1,
        num_timesteps=20, n_samples=4, denoising_stride=10, base_width=8, time_dim=32,
        label_dropout=0.1, guidance_scale=2.0, ema_decay=0.9, data_root=path + "/data",
        out_dir=path + "/out", model_save_path=path + "/ckpt"))
    assert result["state"].step == 2 and result["resident"], result
    rng = np.random.default_rng(0)
    write_png(path + "/init.png", rng.integers(0, 256, (28, 28, 3), dtype=np.uint8))
    write_png(path + "/mask.png", rng.integers(0, 2, (28, 28, 1), dtype=np.uint8) * 255)
    base = ["--checkpoint", path + "/ckpt", "--device", "cpu", "--n", "2",
            "--out", path + "/gen.png"]
    for flags in (["--guidance-scale", "2.0", "--digit", "7"],
                  ["--sampler", "ddim", "--sample-steps", "4", "--eta", "1.0"],
                  ["--sampler", "dpmpp", "--sample-steps", "4", "--guidance-scale", "2.0"],
                  ["--sampler", "ddim", "--sample-steps", "4", "--init-image",
                   path + "/init.png"],
                  ["--sampler", "ddim", "--sample-steps", "4", "--inpaint-image",
                   path + "/init.png", "--inpaint-mask", path + "/mask.png"]):
        out = generate.main(base + flags)
        assert out["samples"].shape == (2, 1, 28, 28), flags
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


# Two steps of the MNIST VAE's run() on small IDX files, two steps of each
# latent backbone's run() on that VAE, then generate.main on the DiT's
# checkpoint, which finds its VAE through the sidecar.
_CHILD_LATENT = _REFUSE + textwrap.dedent("""
    import gzip, os, struct

    import torch

    from tinydiffusion_torch import generate
    from tinydiffusion_torch.data.mnist import load_mnist_u8
    from tinydiffusion_torch.experiments import latent_diffusion, vae

    torch.set_num_threads(1)  # small ops; the test suite runs beside other workers
    path = sys.argv[1]
    root = path + "/idx"
    os.makedirs(root)
    for train, n, name in ((True, 40, "train"), (False, 16, "t10k")):
        images, labels = load_mnist_u8(path + "/synth", train=train, synthetic_n=n)
        for suffix, array in (("images-idx3", images[..., 0]), ("labels-idx1", labels)):
            header = struct.pack(">I", 0x0800 | array.ndim)
            header += struct.pack(f">{array.ndim}I", *array.shape)
            with gzip.open(f"{root}/{name}-{suffix}-ubyte.gz", "wb") as f:
                f.write(header + array.astype("uint8").tobytes())
    result = vae.run(vae.VAEExperimentConfig(
        device="cpu", epochs=1, max_steps_per_epoch=2, batch_size=4, log_every=1,
        data_root=root, out_dir=path + "/vae", checkpoint_dir=path + "/ckpt"))
    assert result["state"].step == 2 and result["resident"], result
    for backbone in ("mlp_unet", "dit"):
        result = latent_diffusion.run(latent_diffusion.LatentDiffusionConfig(
            backbone=backbone, device="cpu", num_epochs=1, max_steps_per_epoch=2,
            batch_size=4, log_every=1, num_timesteps=20, n_samples=4, denoising_stride=10,
            vae_checkpoint=path + "/ckpt/vae_mnist_best", data_root=root,
            out_dir=path + "/" + backbone, model_save_path=path + "/" + backbone + "/ckpt"))
        assert result["state"].step == 2 and result["resident"], result
    out = generate.main(["--checkpoint", path + "/dit/ckpt", "--device", "cpu", "--n", "2",
                         "--sampler", "dpmpp", "--sample-steps", "3", "--out",
                         path + "/gen.png"])
    assert out["samples"].shape == (2, 1, 28, 28) and out["forwards"] == 3, out
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


# Two steps of the LAION text-conditional run() at 64² images and a narrow
# time embedding (caption dropout, EMA, the resident step, the val pass,
# labelled grids), then ``python -m tinydiffusion_torch.generate_laion`` on
# its checkpoint (run as ``-m`` runs it), guided, with --dump-dir.
_CHILD_LAION = _REFUSE + textwrap.dedent("""
    import runpy

    import torch

    from tinydiffusion_torch.experiments import conditional_diffusion_laion as laion

    torch.set_num_threads(1)  # small ops; the test suite runs beside other workers
    path = sys.argv[1]
    result = laion.run(laion.LaionDiffusionConfig(
        device="cpu", num_epochs=1, max_steps_per_epoch=2, batch_size=2, n_records=12,
        image_size=64, time_dim=32, log_every=1, num_timesteps=4, caption_dropout=0.1,
        guidance_scale=2.0, ema_decay=0.9, out_dir=path + "/out",
        model_save_path=path + "/ckpt"))
    assert result["state"].step == 2 and result["resident"], result
    sys.argv = ["generate_laion", "--checkpoint", path + "/ckpt", "--device", "cpu",
                "--sampler", "ddim", "--sample-steps", "2", "--guidance-scale", "2.0",
                "--out", path + "/gen.png", "--dump-dir", path + "/dump"]
    runpy.run_module("tinydiffusion_torch.generate_laion", run_name="__main__")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


# The pretrained seams: run() on CLIP embeddings from a synthetic CLIP-L
# directory, ``generate_laion.main`` on its checkpoint, and two resident LAION
# steps with a small SD-VAE codec's stochastic encode.
_CHILD_SEAMS = _REFUSE + textwrap.dedent("""
    import numpy as np
    import torch

    from chip_smoke import write_synthetic_clip
    from tinydiffusion_torch import generate_laion
    from tinydiffusion_torch.compat.sdvae import AutoencoderKL, SDVAECodec
    from tinydiffusion_torch.core.schedule import DiffusionSchedule
    from tinydiffusion_torch.data.device import DeviceDataset
    from tinydiffusion_torch.experiments import conditional_diffusion_laion as laion
    from tinydiffusion_torch.models.unet_latent import LatentUNet
    from tinydiffusion_torch.train.trainer import create_train_state, make_resident_laion_multi_step

    torch.set_num_threads(1)
    path = sys.argv[1]
    os.makedirs(path + "/clip")
    write_synthetic_clip(path + "/clip", seed=0)
    result = laion.run(laion.LaionDiffusionConfig(
        device="cpu", num_epochs=1, max_steps_per_epoch=2, batch_size=2, n_records=12,
        image_size=64, log_every=1, num_timesteps=4, compute_dtype="float32",
        sample_every_batches=0, sample_every_epoch=False, text_encoder="clip",
        clip_local_dir=path + "/clip", out_dir=path + "/out", model_save_path=path + "/ckpt"))
    assert result["state"].step == 2, result
    served = generate_laion.main(["--checkpoint", path + "/ckpt", "--device", "cpu",
                                  "--sampler", "ddim", "--sample-steps", "2",
                                  "--out", path + "/gen.png"])
    assert served["images"].shape == (4, 3, 64, 64), served

    torch.manual_seed(0)
    codec = SDVAECodec(AutoencoderKL((16, 32), 1, 4, 4))
    images = np.random.default_rng(0).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    data = DeviceDataset(images, 2, seed=0, device="cpu",
                         embeds=np.zeros((4, 32), np.float32),
                         u8_normalize=laion.LAION_U8_NORMALIZE)
    model = LatentUNet(time_dim=32, base_width=4, latent_size=8)
    state = create_train_state(model, torch.optim.Adam(model.parameters(),
                                                       lr=torch.tensor(1e-4)), 0)
    step = make_resident_laion_multi_step(codec, DiffusionSchedule.linear(10), data,
                                          laion.cosine_annealing_lr(1e-4, 1e-6, 10))
    losses = step(state, data.epoch_index_batches(0))
    assert losses.shape == (2,) and torch.isfinite(losses).all(), losses
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


# The FID tools and the importer, each as ``python -m``: the MNIST tool on a
# small IDX data root, the LAION tool at 64² (its feature net trained and
# saved, a random conv-VAE, two PNGs), the importer on a VAE ``.pth``.
_CHILD_TOOLS = _REFUSE + textwrap.dedent("""
    import gzip, runpy, struct

    import numpy as np
    import torch

    from tinydiffusion_torch.data.mnist import load_mnist_u8
    from tinydiffusion_torch.models.vae_mnist import VAEMnist
    from tinydiffusion_torch.obs.images import write_png

    torch.set_num_threads(1)
    path, repo = sys.argv[1], os.environ["PYTHONPATH"]
    for train, prefix in ((True, "train"), (False, "t10k")):
        images, labels = load_mnist_u8(path + "/synth", train=train, synthetic_n=64)
        for kind, array in (("images-idx3", images[..., 0]), ("labels-idx1", labels)):
            with gzip.open(f"{path}/{prefix}-{kind}-ubyte.gz", "wb") as f:
                f.write(struct.pack(">I", 0x0800 | array.ndim)
                        + struct.pack(f">{array.ndim}I", *array.shape)
                        + array.astype(np.uint8).tobytes())

    def run(module, *argv):
        sys.argv = [module, *argv, "--device", "cpu"]
        runpy.run_module(f"tinydiffusion_torch.tools.{module}", run_name="__main__")

    run("fid_eval", "--checkpoint", repo + "/checkpoints/diffusion_final", "--variants",
        "ddim2", "--n", "8", "--sample-batch", "8", "--data-root", path,
        "--classifier", repo + "/checkpoints/fid_classifier", "--json-out", path + "/m.jsonl")
    os.makedirs(path + "/samples")
    for i in range(2):
        write_png(f"{path}/samples/{i}.png", np.full((40, 40, 3), 60 * i, np.uint8))
    run("fid_eval_laion", "--image-size", "64", "--n", "8", "--batch", "8", "--n-train", "32",
        "--classifier", path + "/clf", "--vae-checkpoint", path + "/vae",
        "--samples-dir", path + "/samples", "--json-out", path + "/l.jsonl")
    torch.save({"model_state_dict": VAEMnist().state_dict(), "config": {}}, path + "/vae.pth")
    sys.argv = ["import_torch_checkpoint", "--model", "vae_mnist", "--pth", path + "/vae.pth",
                "--out", path + "/imported"]
    runpy.run_module("tinydiffusion_torch.tools.import_torch_checkpoint", run_name="__main__")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ISOLATED_OK")
""")


def _run_isolated(child: str, path: str, cwd: str) -> None:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", child, path, ",".join(BLOCKED)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED_OK" in proc.stdout


def test_port_imports_and_serves_without_the_jax_stack(tmp_path):
    path = str(tmp_path / "vae_random")
    _random_weights_npz(path, image_size=64)
    _run_isolated(_CHILD, path, str(tmp_path))
    assert os.path.getsize(path + "_grid.png") > 0


def test_port_trains_and_samples_without_the_jax_stack(tmp_path):
    path = str(tmp_path / "unet_ckpt")
    _run_isolated(_CHILD_TRAIN, path, str(tmp_path))
    for ext in (".pt", ".npz", ".json"):
        assert os.path.getsize(path + ext) > 0


def test_port_trains_the_conv_vae_without_the_jax_stack(tmp_path):
    _run_isolated(_CHILD_VAE_TRAIN, str(tmp_path), str(tmp_path))
    for ext in (".pt", ".npz", ".json"):
        assert os.path.getsize(tmp_path / "ckpt" / f"vae_laion_best{ext}") > 0
    assert os.path.getsize(tmp_path / "out" / "generated_samples.png") > 0


def test_port_trains_the_conv_vae_on_a_warm_cache_without_the_jax_stack(tmp_path):
    _run_isolated(_CHILD_VAE_WARM_CACHE, str(tmp_path), str(tmp_path))
    for run in ("cold", "warm"):
        assert os.path.getsize(tmp_path / f"{run}_ckpt" / "vae_laion_best.npz") > 0
    assert not (tmp_path / "data").exists()  # nothing in the default cache


def test_port_trains_the_bf16_conv_vae_resident_without_the_jax_stack(tmp_path):
    _run_isolated(_CHILD_VAE_TRAIN_BF16, str(tmp_path), str(tmp_path))
    with open(tmp_path / "out" / "vae_laion" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert sum("bce" in r for r in records) == 1  # one chunk of 2 steps, its first logged
    assert os.path.getsize(tmp_path / "ckpt" / "vae_laion_best.npz") > 0


def test_port_trains_conditional_and_serves_every_mode_without_the_jax_stack(tmp_path):
    _run_isolated(_CHILD_CONDITIONAL, str(tmp_path), str(tmp_path))
    for ext in (".pt", ".npz", ".json"):
        assert os.path.getsize(tmp_path / f"ckpt{ext}") > 0
    assert os.path.getsize(tmp_path / "gen.png") > 0
    assert os.path.getsize(tmp_path / "out" / "generated_digit_7.png") > 0


def test_port_trains_the_latent_family_and_serves_it_without_the_jax_stack(tmp_path):
    _run_isolated(_CHILD_LATENT, str(tmp_path), str(tmp_path))
    for ext in (".pt", ".npz", ".json"):
        assert os.path.getsize(tmp_path / "ckpt" / f"vae_mnist_best{ext}") > 0
        assert os.path.getsize(tmp_path / "mlp_unet" / f"ckpt{ext}") > 0
    assert os.path.getsize(tmp_path / "dit" / "generated_digit_7.png") > 0
    assert os.path.getsize(tmp_path / "gen.png") > 0


def test_port_trains_and_serves_laion_without_the_jax_stack(tmp_path):
    _run_isolated(_CHILD_LAION, str(tmp_path), str(tmp_path))
    for ext in (".pt", ".npz", ".json"):
        assert os.path.getsize(tmp_path / f"ckpt{ext}") > 0
    assert os.path.getsize(tmp_path / "out" / "final_samples.png") > 0
    assert os.path.getsize(tmp_path / "gen.png") > 0
    assert sorted(os.listdir(tmp_path / "dump")) == [f"sample_000_0{i}.png" for i in range(4)]


def test_port_trains_on_the_pretrained_seams_without_the_jax_stack(tmp_path):
    _run_isolated(_CHILD_SEAMS, str(tmp_path), str(tmp_path))
    for ext in (".pt", ".npz", ".json"):
        assert os.path.getsize(tmp_path / f"ckpt{ext}") > 0
    assert os.path.getsize(tmp_path / "gen.png") > 0


def test_port_fid_tools_and_importer_run_without_the_jax_stack(tmp_path):
    _random_weights_npz(str(tmp_path / "vae"), image_size=64)
    _run_isolated(_CHILD_TOOLS, str(tmp_path), str(tmp_path))
    with open(tmp_path / "m.jsonl") as f:
        assert [json.loads(line)["variant"] for line in f] == ["real-train", "noise", "ddim2"]
    with open(tmp_path / "l.jsonl") as f:
        row = json.loads(f.readline())
    assert {"vae_recon", "vae_prior_decode", "samples_dir[2]"} <= set(row)
    for ext in (".npz", ".json"):
        assert os.path.getsize(tmp_path / f"clf{ext}") > 0
    for ext in (".pt", ".npz", ".json"):
        assert os.path.getsize(tmp_path / f"imported{ext}") > 0


_CHILD_DECODERS = _REFUSE + textwrap.dedent("""
    import hashlib, json

    import numpy as np

    from tinydiffusion_torch.data import bmp, gif, jpeg, laion, png, webp  # noqa: F401

    fixtures = os.path.join(os.environ["PYTHONPATH"], "tests", "fixtures")
    with open(os.path.join(fixtures, "laion_loader_pillow.json")) as f:
        digests = json.load(f)
    for name, want in digests.items():
        if name == "note":
            continue
        with open(os.path.join(fixtures, name), "rb") as f:
            image = laion.decode_image(f.read())
        assert hashlib.sha256(image.tobytes()).hexdigest() == want["rgb_sha256"], name
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("ISOLATED_OK")
""")


def test_port_decodes_every_fixture_format_without_pillow(tmp_path):
    """The decoders of every format the loader reads (``data/jpeg.py``,
    ``png.py``, ``gif.py``, ``bmp.py``, ``webp.py``) import and decode the
    committed fixtures to Pillow's digests with PIL refused."""
    _run_isolated(_CHILD_DECODERS, str(tmp_path), str(tmp_path))
