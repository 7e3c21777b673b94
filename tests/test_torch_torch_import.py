"""The port's reference-checkpoint importer (``compat/torch_import.py`` and
``tools/import_torch_checkpoint.py``) against the JAX package, on the CPU.

For each of the five upstream models a seeded synthetic upstream
``state_dict`` is built with the reference's names (``enc1.0``,
``time_embedding.2``, ``transformer_blocks.0.attention.in_proj_weight``,
1x1-conv ``time_proj``, BatchNorm counters). JAX's
``compat/torch_import.py`` reads every one of its keys but the BatchNorm
counters, which neither framework uses, so the synthetic dict has the
reference's key set as JAX knows it. The port's import, run through the
port's model, equals JAX's import run through flax on the same inputs. The
tool takes a ``torch.save``d ``.pth`` of both shapes (a bare state dict, and
a dict with ``model_state_dict`` and ``config``) and writes checkpoints that
``load_pixel_checkpoint`` and ``load_latent_checkpoint`` serve.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinydiffusion_tpu.compat import torch_import as jax_import
from tinydiffusion_tpu.models.dit import DiT as JaxDiT
from tinydiffusion_tpu.models.mlp_unet import MLPUNetLatent as JaxMLPUNet
from tinydiffusion_tpu.models.unet28 import UNet28 as JaxUNet28
from tinydiffusion_tpu.models.vae_mnist import VAEMnist as JaxVAEMnist
from tinydiffusion_torch.compat import torch_import
from tinydiffusion_torch.experiments.common import load_latent_checkpoint, load_pixel_checkpoint
from tinydiffusion_torch.tools import import_torch_checkpoint as tool

# float32 forwards of the same weights: summation order only.
ATOL, RTOL = 2e-5, 2e-5
SMALL = {"unet28": {"time_dim": 32, "base_width": 8},
         "conditional_unet28": {"time_dim": 32, "base_width": 8, "num_classes": 10},
         "vae_mnist": {"latent_dim": 20, "hidden_dim": 400, "input_dim": 784},
         "mlp_unet": {"time_dim": 32, "num_classes": 10, "latent_dim": 20},
         "dit": {"time_dim": 256, "num_classes": 10, "latent_dim": 20}}

# Port name -> reference name, applied in order.
_RENAMES = [
    (r"^time_embedding\.fc1\.", "time_embedding.0."),
    (r"^time_embedding\.fc2\.", "time_embedding.2."),
    (r"\.block1\.(conv|fc)\.", ".0."), (r"\.block1\.bn\.", ".1."),
    (r"\.block2\.(conv|fc)\.", ".3."), (r"\.block2\.bn\.", ".4."),
    (r"^bottleneck\.(conv|fc)\.", "bottleneck.0."), (r"^bottleneck\.bn\.", "bottleneck.1."),
    (r"^block(\d+)\.attention\.out\.", r"transformer_blocks.\1.attention.out_proj."),
    (r"^block(\d+)\.ff1\.", r"transformer_blocks.\1.ff.0."),
    (r"^block(\d+)\.ff2\.", r"transformer_blocks.\1.ff.2."),
    (r"^block(\d+)\.", r"transformer_blocks.\1."),
    (r"^final_norm\.", "final_layer.0."), (r"^final_proj\.", "final_layer.1."),
]


class _Reads(dict):
    """A dict that records the keys read from it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def upstream_state_dict(model: str, seed: int) -> dict[str, np.ndarray]:
    """A seeded synthetic upstream state dict for ``model``, with the
    reference's names and layouts, built from the port model's slots. Its
    floats are bfloat16 values, so a checkpoint written in the JAX format
    (bfloat16 params) holds them exactly."""
    rng = np.random.default_rng(seed)
    port = tool.build_model(model, SMALL[model])
    out: dict[str, np.ndarray] = {}
    qkv: dict[str, list] = {}
    for name, t in port.state_dict().items():
        if name.endswith("num_batches_tracked"):
            value = np.asarray(int(rng.integers(0, 1000)), np.int64)
        elif name.endswith("running_var"):
            value = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
        else:
            value = (0.1 * rng.standard_normal(t.shape)).astype(np.float32)
        if value.dtype == np.float32:  # bfloat16 values: the npz keeps them exactly
            value = (value.view(np.uint32) & 0xFFFF0000).view(np.float32)
        m = re.match(r"^block(\d+)\.attention\.(query|key|value)\.(weight|bias)$", name)
        if m:  # MultiheadAttention packs q, k and v in one in_proj
            qkv.setdefault(f"transformer_blocks.{m[1]}.attention.in_proj_{m[3]}", []).append(value)
            continue
        if re.match(r"^time_proj\d\.weight$", name) and model.endswith("unet28"):
            value = value[:, :, None, None]  # the reference's 1x1 conv
        for pattern, repl in _RENAMES:
            name = re.sub(pattern, repl, name)
        out[name] = value
    out.update({k: np.concatenate(v) for k, v in qkv.items()})
    return out


def _jax_import(model: str, sd: dict):
    if model in ("unet28", "conditional_unet28"):
        return jax_import.import_unet28(sd, conditional=model == "conditional_unet28")
    return {"vae_mnist": jax_import.import_vae_mnist, "mlp_unet": jax_import.import_mlp_unet,
            "dit": jax_import.import_dit}[model](sd)


def _port_import(model: str, sd: dict):
    if model in ("unet28", "conditional_unet28"):
        return torch_import.import_unet28(sd, conditional=model == "conditional_unet28")
    return {"vae_mnist": torch_import.import_vae_mnist, "mlp_unet": torch_import.import_mlp_unet,
            "dit": torch_import.import_dit}[model](sd)


def _inputs(model: str, rng):
    b = 3
    t = np.array([0, 250, 999], np.int32)
    y = np.array([1, 7, 3], np.int32)
    if model.endswith("unet28"):
        return rng.standard_normal((b, 28, 28, 1)).astype(np.float32), t, y
    return rng.standard_normal((b, 20)).astype(np.float32), t, y


def _forwards(model: str, port: torch.nn.Module, variables: dict, rng):
    """(port output, flax output) as numpy, eval mode, on the same inputs."""
    port.eval()
    x, t, y = _inputs(model, rng)
    tt, ty = torch.from_numpy(t).long(), torch.from_numpy(y).long()
    cfg = SMALL[model]
    with torch.no_grad():
        if model == "vae_mnist":
            img = rng.uniform(0, 1, (3, 784)).astype(np.float32)
            jm = JaxVAEMnist()
            mu, logvar = jm.apply(variables, img, method=jm.encode)
            recon = jm.apply(variables, x, method=jm.decode)
            got = [*port.encode(torch.from_numpy(img)), port.decode(torch.from_numpy(x))]
            return [g.numpy() for g in got], [np.asarray(w) for w in (mu, logvar, recon)]
        if model.endswith("unet28"):
            jm = JaxUNet28(time_dim=cfg["time_dim"], base_width=cfg["base_width"],
                           num_classes=cfg.get("num_classes"), dtype=jnp.float32)
            args = (x, t, y) if "num_classes" in cfg else (x, t)
            want = jax.jit(lambda v: jm.apply(v, *args, train=False))(variables)
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2), tt,
                       ty if "num_classes" in cfg else None).permute(0, 2, 3, 1)
            return [got.numpy()], [np.asarray(want)]
        cls = JaxDiT if model == "dit" else JaxMLPUNet
        jm = cls(time_dim=cfg["time_dim"], num_classes=cfg["num_classes"], dtype=jnp.float32)
        want = jax.jit(lambda v: jm.apply(v, x, t, y, train=False))(variables)
        return [port(torch.from_numpy(x), tt, ty).numpy()], [np.asarray(want)]


@pytest.mark.parametrize("model", list(SMALL))
def test_import_matches_jax_import_and_forward(model):
    sd = upstream_state_dict(model, seed=len(model))
    tracked = _Reads(sd)
    variables = _jax_import(model, tracked)
    assert set(sd) - tracked.read == {k for k in sd if k.endswith("num_batches_tracked")}
    state_dict = _port_import(model, sd)
    assert torch_import.infer_config(model, state_dict) == {
        **({"backbone": model} if model in ("mlp_unet", "dit") else {}), **SMALL[model]}
    port = tool.build_model(model, SMALL[model])
    port.load_state_dict(state_dict)  # strict
    # Tensors in, numpy in: the same import.
    again = _port_import(model, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    for k, v in state_dict.items():
        assert torch.equal(again[k], v), k
    for got, want in zip(*_forwards(model, port, variables, np.random.default_rng(0))):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_import_refuses_keys_it_does_not_read():
    sd = upstream_state_dict("vae_mnist", seed=0)
    sd["fc5.weight"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="fc5.weight"):
        torch_import.import_vae_mnist(sd)


def test_tool_writes_checkpoints_the_loaders_serve(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    # A bare state dict (conditional_diffusion.py:300), the default --out under runs/.
    sd = {k: torch.from_numpy(v) for k, v in upstream_state_dict("conditional_unet28", 1).items()}
    torch.save(sd, tmp_path / "cond.pth")
    result = tool.main(["--model", "conditional_unet28", "--pth", str(tmp_path / "cond.pth")])
    assert result["out"] == "runs/imported/conditional_unet28"
    loaded = load_pixel_checkpoint(result["out"], "cpu")
    assert loaded["conditional"] and loaded["num_classes"] == 10 and not loaded["cfg_trained"]
    variables = _jax_import("conditional_unet28", {k: v.numpy() for k, v in sd.items()})
    for got, want in zip(*_forwards("conditional_unet28", loaded["model"], variables, rng)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    # Rich dicts with model_state_dict and config (vae.py:168-178): the VAE,
    # then a latent denoiser served over it.
    paths = {}
    for model in ("vae_mnist", "mlp_unet"):
        sd = {k: torch.from_numpy(v) for k, v in upstream_state_dict(model, 2).items()}
        torch.save({"model_state_dict": sd, "config": {"learning_rate": 5e-4}, "epoch": 3},
                   tmp_path / f"{model}.pth")
        paths[model] = str(tmp_path / "out" / model)
        result = tool.main(["--model", model, "--pth", str(tmp_path / f"{model}.pth"),
                            "--out", paths[model]])
        assert result["config"]["learning_rate"] == 5e-4
    latent = load_latent_checkpoint(paths["mlp_unet"], paths["vae_mnist"], device="cpu")
    assert latent["latent_dim"] == 20 and latent["cfg"]["backbone"] == "mlp_unet"
    variables = jax_import.import_mlp_unet(upstream_state_dict("mlp_unet", 2))
    for got, want in zip(*_forwards("mlp_unet", latent["model"], variables, rng)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    vae_variables = jax_import.import_vae_mnist(upstream_state_dict("vae_mnist", 2))
    for got, want in zip(*_forwards("vae_mnist", latent["vae"], vae_variables, rng)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
