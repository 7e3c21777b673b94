"""The port runs on a machine without the JAX stack.

The CUDA machines that serve the port have torch, numpy and the standard
library, and no jax, jaxlib, flax, optax, orbax, ml_dtypes or PIL. This test
stands in for that machine on the CPU: a subprocess whose import system
refuses those packages (and ``tinydiffusion_tpu``) imports every module of
``tinydiffusion_torch`` and ``chip_smoke``, then loads a conv-VAE from an npz
of random weights and serves it on ``device="cpu"``; another trains, samples
and checkpoints a small UNet28 on the CPU; a third trains the conv-VAE for
two steps through its ``run``.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_laion_best")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "PIL", "tinydiffusion_tpu")

_REFUSE = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

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
