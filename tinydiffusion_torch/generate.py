"""Serving CLI: sample images from a trained checkpoint of the MNIST zoo.

Counterpart of the root ``generate.py`` (the JAX package's one serving entry
point), with its flags and its parser errors, plus ``--device``. It serves
any UNet28 checkpoint of the zoo (``.npz`` +
``.json``, from the JAX package or the port): the 1000-step ancestral DDPM,
DDIM (eta, img2img from a PNG, inpainting from a PNG and a mask), the
second-order DPM-Solver++(2M), classifier-free guidance on a checkpoint
trained with label dropout, and v-prediction; the schedule and the target
come from the sidecar, and the EMA shadow is served when the run kept one.
As in JAX the model runs in bfloat16 and the chain in ``--sample-dtype``::

    python -m tinydiffusion_torch.generate --checkpoint checkpoints/conditional_cfg_ema_best \\
        --digit 7 --guidance-scale 2.0 --sampler dpmpp --sample-steps 15 --out out.png
    python -m tinydiffusion_torch.generate --checkpoint checkpoints/diffusion_final \\
        --sampler ddim --init-image in.png --strength 0.6 --device cpu

A latent-family checkpoint (a ``backbone`` in the sidecar: the MLP UNet or
the DiT over the MNIST VAE) is served with any ``--sampler`` through its
recorded VAE, which decodes the latent chain's end
(``experiments.common.load_latent_checkpoint``); img2img, inpainting and
guidance are pixel modes, and a latent checkpoint refuses them::

    python -m tinydiffusion_torch.generate --checkpoint checkpoints/diffusion_transformer_best \\
        --digit 7 --sampler dpmpp --sample-steps 15 --out out.png
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tinydiffusion_torch.core.process import q_sample_with_noise
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.device import resolve_device
from tinydiffusion_torch.experiments.common import (
    load_latent_checkpoint,
    load_pixel_checkpoint,
    make_latent_pixel_sampler,
    make_sampler,
    resolve_dtype,
    to_nhwc01,
)
from tinydiffusion_torch.io.checkpoint import load_sidecar
from tinydiffusion_torch.obs.images import load_image28, save_image_grid


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--n", type=int, default=16)
    parser.add_argument("--out", default="generated.png")
    parser.add_argument("--digit", type=int, default=None,
                        help="class label (conditional checkpoints only)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-timesteps", type=int, default=1000)
    parser.add_argument("--sample-dtype", default="float32")
    parser.add_argument("--sampler", choices=["ddpm", "ddim", "dpmpp"], default="ddpm",
                        help="ddpm = reference-faithful T-step ancestral chain; ddim = "
                             "accelerated serving path; dpmpp = DPM-Solver++(2M)")
    parser.add_argument("--sample-steps", type=int, default=50,
                        help="ddim/dpmpp model forwards (ignored for ddpm)")
    parser.add_argument("--eta", type=float, default=0.0,
                        help="DDIM stochasticity (0 = deterministic)")
    parser.add_argument("--guidance-scale", type=float, default=1.0,
                        help="classifier-free guidance scale (checkpoints trained with "
                             "--label-dropout only; 1 = off)")
    parser.add_argument("--init-image", default=None,
                        help="img2img: PNG to start from (DDIM only); the chain denoises "
                             "from --strength of the way up")
    parser.add_argument("--strength", type=float, default=0.6,
                        help="img2img noise level in (0, 1]: fraction of the chain re-run")
    parser.add_argument("--inpaint-image", default=None,
                        help="inpainting: PNG with the known content")
    parser.add_argument("--inpaint-mask", default=None,
                        help="inpainting: PNG mask (white = keep known)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: the CUDA card)")
    return parser


def _nchw(image28: np.ndarray, device: torch.device) -> torch.Tensor:
    """A (28, 28, 1) image as a (1, 1, 28, 28) tensor on ``device``."""
    return torch.from_numpy(image28.reshape(1, 1, 28, 28).copy()).to(device)


def _labels(args, num_classes: int | None, generator, device) -> torch.Tensor | None:
    if num_classes is None:
        return None
    if args.digit is not None:
        return torch.full((args.n,), args.digit, dtype=torch.int64, device=device)
    return torch.randint(0, num_classes, (args.n,), generator=generator, device=device)


def _serve(args, device: torch.device, counts: dict, request) -> dict:
    """Run ``request() -> (samples in [-1, 1], labels or None)`` timed to the
    device's end, with the model forwards, graph captures and replays of its
    sampler's ``counts``, write the grid, and return ``main``'s result."""

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    before = dict(counts)
    synchronize()
    t0 = time.perf_counter()
    samples, y = request()
    synchronize()
    sample_seconds = time.perf_counter() - t0
    forwards, captures, replays = (counts[k] - before[k]
                                   for k in ("forwards", "captures", "replays"))

    labels = None if y is None else y.tolist()
    save_image_grid(to_nhwc01(samples), args.out, nrow=max(int(np.sqrt(args.n)), 1), labels=labels)
    print(f"wrote {args.n} samples to {args.out} ({forwards} model forwards, "
          f"{captures} graph captures, {replays} replays, {sample_seconds:.3f} s)")
    return {"samples": samples, "labels": labels, "forwards": forwards, "captures": captures,
            "replays": replays, "sample_seconds": sample_seconds, "out": args.out}


def _generate_latent(args, parser: argparse.ArgumentParser, device: torch.device) -> dict:
    """A latent-family checkpoint: the latent chain (any ``--sampler``), the
    denoiser in the sidecar's compute dtype, then the recorded VAE's decode
    (latent_diffusion.py:308-347, outside the training loop)."""
    if args.init_image or args.inpaint_image or args.guidance_scale != 1.0:
        parser.error("img2img/inpainting/guidance are pixel-checkpoint modes; latent "
                     "checkpoints support plain sampling with any --sampler")
    loaded = load_latent_checkpoint(args.checkpoint, device=device)
    print(f"loaded {args.checkpoint} (backbone {loaded['cfg']['backbone']}, step "
          f"{loaded['step']}" + (", sampling from EMA params)" if loaded["use_ema"] else ")"))
    sampler = make_latent_pixel_sampler(loaded, args.n, method=args.sampler,
                                        sample_steps=args.sample_steps, eta=args.eta,
                                        dtype=resolve_dtype(args.sample_dtype))

    def request():
        generator = torch.Generator(device).manual_seed(args.seed)
        y = _labels(args, loaded["num_classes"], generator, device)
        return sampler(generator, y), y

    return _serve(args, device, sampler.counts, request)


def main(argv=None) -> dict:
    """Serve one request. Returns ``samples`` ((n, 1, 28, 28) in [-1, 1], on
    the device), ``labels`` (or None), ``forwards`` (model forwards run),
    ``captures`` and ``replays`` (the CUDA graphs the chain captured and
    replayed; 0 on the CPU), ``sample_seconds`` (the request's sampling
    time, synchronized) and ``out``."""
    parser = _parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    # One serving CLI for the MNIST zoo: the sidecar's 'backbone' marks a
    # latent checkpoint, which samples in latent space and decodes.
    if "backbone" in load_sidecar(args.checkpoint).get("config", {}):
        return _generate_latent(args, parser, device)

    loaded = load_pixel_checkpoint(args.checkpoint, device)
    model, cfg, schedule = loaded["model"], loaded["cfg"], loaded["schedule"]
    conditional, num_classes = loaded["conditional"], loaded["num_classes"]
    if "num_timesteps" not in cfg and args.num_timesteps != 1000:
        # Sidecars record T; the flag only matters for a checkpoint without one.
        schedule = DiffusionSchedule.make(cfg.get("noise_schedule", "linear"),
                                          args.num_timesteps).to(device)
    T = schedule.num_timesteps

    if args.guidance_scale != 1.0 and not loaded["cfg_trained"]:
        parser.error("--guidance-scale needs a checkpoint trained with --label-dropout > 0 "
                     "(no null-class embedding row here)")
    print(f"loaded {args.checkpoint} (step {loaded['step']}"
          + (", sampling from EMA params)" if loaded["use_ema"] else ")"))

    t_start = mask = x_known = None
    if args.init_image:
        if args.sampler != "ddim":
            parser.error("--init-image (img2img) requires --sampler ddim")
        if not 0.0 < args.strength <= 1.0:
            parser.error("--strength must be in (0, 1]")
        t_start = max(int(round(args.strength * (T - 1))), 1)
    if (args.inpaint_image is None) != (args.inpaint_mask is None):
        parser.error("inpainting needs BOTH --inpaint-image and --inpaint-mask")
    if args.inpaint_image:
        if args.sampler == "dpmpp":
            parser.error("inpainting requires --sampler ddpm or ddim")
        x_known = _nchw(load_image28(args.inpaint_image), device)
        mask = (_nchw(load_image28(args.inpaint_mask), device) >= 0.0).float()

    # The schedule and the target come from the sidecar: a checkpoint trained
    # with --noise-schedule cosine or --prediction v is served with its math.
    sampler = make_sampler(
        model, schedule, (args.n, 1, 28, 28), conditional=conditional,
        dtype=resolve_dtype(args.sample_dtype), method=args.sampler,
        sample_steps=args.sample_steps, eta=args.eta, guidance_scale=args.guidance_scale,
        null_label=num_classes if loaded["cfg_trained"] else None,
        prediction=cfg.get("prediction", "eps"), t_start=t_start, mask=mask, x_known=x_known,
        compute_dtype=torch.bfloat16)

    def request():
        generator = torch.Generator(device).manual_seed(args.seed)
        x_init = None
        if args.init_image:
            x0 = _nchw(load_image28(args.init_image), device).expand(args.n, 1, 28, 28)
            noise = torch.randn(x0.shape, generator=generator, device=device)
            t_vec = torch.full((args.n,), t_start, dtype=torch.int64, device=device)
            x_init = q_sample_with_noise(schedule, x0, t_vec, noise)
            print(f"img2img from {args.init_image} at t_start={t_start} "
                  f"(strength {args.strength})")
        y = _labels(args, num_classes if conditional else None, generator, device)
        return sampler(generator, params=loaded["params"], y=y, x_init=x_init), y

    return _serve(args, device, sampler.counts, request)


if __name__ == "__main__":
    main()
