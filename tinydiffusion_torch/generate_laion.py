"""Serving CLI: text-to-image samples from a LAION diffusion checkpoint.

Counterpart of the root ``generate_laion.py``, with its flags and its parser
errors, plus ``--device``. It restores a checkpoint written by
``conditional_diffusion_laion.py`` (the JAX package's or the port's:
``<path>.npz`` weights and the ``<path>.json`` sidecar with the config and,
for the patch codec, its calibrated basis), embeds the ``--prompt`` strings
with the checkpoint's text encoder (the hash encoder, or CLIP-L from the
sidecar's ``clip_local_dir``), and samples with the T-step DDPM chain or
DDIM, with classifier-free guidance on a checkpoint trained with caption
dropout, decoding with the checkpoint's codec (the patch codec, or the
SD-VAE through diffusers). The UNet runs in the sidecar's compute dtype, the
chain in ``--sample-dtype`` (the sidecar's by default); the EMA shadow is
served when the run kept one::

    python -m tinydiffusion_torch.generate_laion --checkpoint checkpoints/laion_diffusion_1000ep \\
        --prompt "a photo of a cat" --prompt "a photo of a dog" \\
        --sampler ddim --sample-steps 50 --out laion.png [--device cpu]

``--dump-dir`` also writes each sample as a PNG (``sample_RRR_II.png``),
for ``--repeat`` batches drawn with the seeds ``seed .. seed + repeat - 1``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from tinydiffusion_torch.compat.latent_codec import get_latent_codec
from tinydiffusion_torch.compat.text_encoder import get_text_encoder
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.device import disable_tf32, resolve_device
from tinydiffusion_torch.experiments.common import resolve_dtype
from tinydiffusion_torch.experiments.conditional_diffusion_laion import (
    SAMPLE_PROMPTS,
    config_from_sidecar,
    make_laion_sampler,
    resolve_seams,
    to_nhwc,
)
from tinydiffusion_torch.io.checkpoint import load_sidecar, load_weights_arrays
from tinydiffusion_torch.io.from_jax import state_dict_by_name
from tinydiffusion_torch.models.unet_latent import LatentUNet
from tinydiffusion_torch.obs.images import save_image_grid, write_png


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True,
                        help="path written by conditional_diffusion_laion (.npz + .json)")
    parser.add_argument("--prompt", action="append", default=None,
                        help="repeatable; defaults to the experiment's four fixed sample prompts")
    parser.add_argument("--out", default="laion_generated.png")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sampler", choices=["ddpm", "ddim"], default="ddpm",
                        help="ddpm = faithful T-step chain; ddim = accelerated serving path")
    parser.add_argument("--sample-steps", type=int, default=50,
                        help="DDIM model forwards (ignored for ddpm)")
    parser.add_argument("--eta", type=float, default=0.0,
                        help="DDIM stochasticity (0 = deterministic)")
    parser.add_argument("--guidance-scale", type=float, default=1.0,
                        help="classifier-free guidance (checkpoints trained with "
                             "--caption-dropout only; 1 = off)")
    parser.add_argument("--sample-dtype", default=None,
                        help="override the sidecar's sample dtype")
    parser.add_argument("--dump-dir", default=None,
                        help="also write every sample as an individual PNG")
    parser.add_argument("--repeat", type=int, default=1,
                        help="with --dump-dir: sample this many batches (seeds seed .. "
                             "seed + repeat - 1)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: the CUDA card)")
    return parser


def load_laion_checkpoint(path: str, device: str | torch.device = "cuda") -> dict:
    """A LAION diffusion checkpoint rebuilt for serving from ``<path>.npz`` +
    ``<path>.json``: ``model`` (the ``LatentUNet``, eval mode on ``device``,
    holding the EMA shadow when the sidecar says the run kept one), ``codec``
    (on ``device``; the patch codec in the sidecar's calibrated basis),
    ``text_encoder`` (CLIP on ``device``), ``schedule``, ``config`` (the
    sidecar's, as a ``LaionDiffusionConfig``), ``step`` and ``use_ema``.
    Raises ``ValueError`` when the sidecar has no ``codec_state`` for a codec
    that takes one, or says EMA where the npz has none. On a card TF32 is
    turned off."""
    device = resolve_device(device)
    if device.type == "cuda":
        disable_tf32()
    sidecar = load_sidecar(path)
    config = config_from_sidecar(sidecar.get("config", {}))
    codec_name, encoder_name = resolve_seams(config)
    codec = get_latent_codec(codec_name, config.image_size)
    if hasattr(codec, "load_state_dict"):  # the patch codec's basis; the SD-VAE has none
        codec_state = sidecar.get("metadata", {}).get("codec_state")
        if codec_state is None:
            raise ValueError("checkpoint sidecar has no codec_state — the denoiser's latent "
                             "basis is unrecoverable (re-save from a run that persists it)")
        codec.load_state_dict(codec_state)
    flat = load_weights_arrays(path)
    use_ema = config.ema_decay > 0
    if use_ema and not any(k.startswith("ema_params/") for k in flat):
        raise ValueError("the sidecar says the run kept an EMA, but the npz holds no ema_params")
    model = LatentUNet(time_dim=config.time_dim, in_channels=config.latent_channels,
                       latent_size=config.latent_size)
    model.load_state_dict(state_dict_by_name(flat, params="ema_params" if use_ema else "params"))
    return {
        "model": model.to(device).eval(),
        "codec": codec.to(device),
        "text_encoder": get_text_encoder(encoder_name, config.time_dim, config.clip_local_dir,
                                         device=device),
        "schedule": DiffusionSchedule.linear(config.num_timesteps).to(device),
        "config": config,
        "step": int(flat["step"]) if "step" in flat else 0,
        "use_ema": use_ema,
    }


def main(argv=None) -> dict:
    """Serve one request. Returns ``images`` ((n, 3, S, S) in [0, 1], on the
    device), ``prompts``, ``forwards`` (model forwards of the first batch),
    ``sample_seconds`` (its sampling time, synchronized), ``out`` and
    ``dumped`` (the per-sample PNGs written)."""
    parser = _parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    config = config_from_sidecar(load_sidecar(args.checkpoint).get("config", {}))
    if args.guidance_scale != 1.0 and not config.caption_dropout > 0:
        parser.error("--guidance-scale needs a checkpoint trained with --caption-dropout > 0 "
                     "(the null conditioning was never trained)")
    try:
        loaded = load_laion_checkpoint(args.checkpoint, device)
    except ValueError as e:
        parser.error(str(e))
    model, text_encoder = loaded["model"], loaded["text_encoder"]
    print(f"loaded {args.checkpoint} (step {loaded['step']}"
          + (", sampling from EMA params)" if loaded["use_ema"] else ")"))
    prompts = args.prompt or list(SAMPLE_PROMPTS)
    embeds = torch.from_numpy(text_encoder.encode(prompts)).to(device)
    null_embed = (torch.from_numpy(text_encoder.encode([""])[0]).to(device)
                  if config.caption_dropout > 0 else None)
    sampler = make_laion_sampler(
        model, loaded["schedule"], loaded["codec"], len(prompts), config.latent_size,
        config.latent_channels, dtype=resolve_dtype(args.sample_dtype or config.sample_dtype),
        compute_dtype=resolve_dtype(config.compute_dtype), guidance_scale=args.guidance_scale,
        null_embed=null_embed, method=args.sampler, sample_steps=args.sample_steps, eta=args.eta)

    forwards = 0

    def count_forward(*_):
        nonlocal forwards
        forwards += 1

    def sample(seed: int) -> torch.Tensor:
        return sampler(torch.Generator(device).manual_seed(seed), embeds)

    hook = model.register_forward_pre_hook(count_forward)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    images = sample(args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sample_seconds = time.perf_counter() - t0
    hook.remove()
    nrow = max(int(np.ceil(np.sqrt(len(prompts)))), 1)
    save_image_grid(to_nhwc(images), args.out, nrow=nrow, normalize=False, labels=prompts)
    print(f"wrote {len(prompts)} samples to {args.out} ({forwards} model forwards, "
          f"{sample_seconds:.3f} s)")

    dumped = []
    if args.dump_dir:
        os.makedirs(args.dump_dir, exist_ok=True)
        for r in range(args.repeat):
            batch = images if r == 0 else sample(args.seed + r)
            for i, image in enumerate(to_nhwc(batch)):
                path = os.path.join(args.dump_dir, f"sample_{r:03d}_{i:02d}.png")
                write_png(path, (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8))
                dumped.append(path)
            print(f"dumped batch {r + 1}/{args.repeat}")
        print(f"wrote {len(dumped)} individual PNGs to {args.dump_dir}")
    return {"images": images, "prompts": prompts, "forwards": forwards,
            "sample_seconds": sample_seconds, "out": args.out, "dumped": dumped}


if __name__ == "__main__":
    main()
