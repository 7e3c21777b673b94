"""Convert a tiny-diffusion reference checkpoint (``.pth``) into a port one.

    python -m tinydiffusion_torch.tools.import_torch_checkpoint --model unet28 \
        --pth best_model.pth --out runs/imported/unet28

Counterpart of ``tools/import_torch_checkpoint.py``. The ``.pth`` holds a
bare ``state_dict`` (conditional_diffusion.py:300) or a dict with
``model_state_dict`` and ``config`` (vae.py:168-178). The weights go through
``compat.torch_import`` into the port's model, and a fresh train state
around it (Adam at the config's ``learning_rate``, default 1e-3) is written
by ``io.checkpoint.save_checkpoint``: ``<out>.pt``, ``<out>.npz`` (the JAX
package's weights format) and ``<out>.json``. The sidecar's config is the
``.pth``'s, completed with the widths read from the weights (and
``backbone`` for the latent denoisers), so that ``load_pixel_checkpoint``,
``generate.py``, ``load_latent_checkpoint`` (pass its ``vae_checkpoint``)
and latent diffusion's VAE loader rebuild the model. The default ``--out``
is under ``runs/``, never ``checkpoints/``.

Models: unet28 | conditional_unet28 | vae_mnist | mlp_unet | dit
"""

from __future__ import annotations

import argparse

import torch

MODELS = ("unet28", "conditional_unet28", "vae_mnist", "mlp_unet", "dit")


def build_model(model: str, cfg: dict) -> torch.nn.Module:
    """The port's model of ``model`` at the widths of ``cfg`` (``infer_config``'s)."""
    from tinydiffusion_torch.models.dit import DiT
    from tinydiffusion_torch.models.mlp_unet import MLPUNetLatent
    from tinydiffusion_torch.models.unet28 import UNet28
    from tinydiffusion_torch.models.vae_mnist import VAEMnist

    if model in ("unet28", "conditional_unet28"):
        return UNet28(time_dim=cfg["time_dim"], num_classes=cfg.get("num_classes"),
                      base_width=cfg["base_width"])
    if model == "vae_mnist":
        return VAEMnist(cfg["latent_dim"], cfg["hidden_dim"], cfg["input_dim"])
    cls = DiT if model == "dit" else MLPUNetLatent
    return cls(time_dim=cfg["time_dim"], num_classes=cfg["num_classes"],
               latent_dim=cfg["latent_dim"])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True, choices=MODELS)
    parser.add_argument("--pth", required=True)
    parser.add_argument("--out", default=None,
                        help="checkpoint path without extension (default runs/imported/<model>)")
    args = parser.parse_args(argv)

    from tinydiffusion_torch.compat import torch_import as ti
    from tinydiffusion_torch.io.checkpoint import save_checkpoint
    from tinydiffusion_torch.train.trainer import create_train_state

    out = args.out or f"runs/imported/{args.model}"
    raw = torch.load(args.pth, map_location="cpu", weights_only=True)
    rich = isinstance(raw, dict) and "model_state_dict" in raw
    sd = raw["model_state_dict"] if rich else raw
    config = dict(raw.get("config", {})) if rich else {}

    state_dict = {
        "unet28": ti.import_unet28,
        "conditional_unet28": lambda s: ti.import_unet28(s, conditional=True),
        "vae_mnist": ti.import_vae_mnist,
        "mlp_unet": ti.import_mlp_unet,
        "dit": ti.import_dit,
    }[args.model](sd)
    widths = ti.infer_config(args.model, state_dict)
    for key, value in widths.items():
        config.setdefault(key, value)
    model = build_model(args.model, widths)
    model.load_state_dict(state_dict)
    optimizer = torch.optim.Adam(model.parameters(), lr=float(config.get("learning_rate", 1e-3)))
    save_checkpoint(out, create_train_state(model, optimizer, seed=0), config=config,
                    metadata={"imported_from": args.pth, "model": args.model})
    n = sum(p.numel() for p in model.parameters())
    print(f"imported {args.model} ({n:,} params) from {args.pth} -> {out}")
    return {"out": out, "config": config, "params": n}


if __name__ == "__main__":
    main()
