"""Shared experiment plumbing: dtypes, checkpoints, the sampler factories, CLI.

Counterpart of ``tinydiffusion_tpu/experiments/common.py`` (``resolve_dtype``,
``load_pixel_checkpoint``, ``make_sampler``, ``make_trajectory_sampler``,
``RESIDENT_AUTO_LIMIT_BYTES`` and ``resolve_data_placement`` for one card,
``add_config_flags``, ``config_from_args``, and the latent family's
``load_latent_checkpoint`` and ``make_latent_pixel_sampler``). The flag
names are the JAX ones, so the two CLIs take the same arguments.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging

import numpy as np
import torch
from torch import nn

from tinydiffusion_torch.core.process import eps_from_v
from tinydiffusion_torch.core.sampler import (
    ddim_sample,
    ddpm_denoising_trajectory,
    ddpm_sample,
    dpmpp_sample,
)
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.device import disable_tf32, resolve_device
from tinydiffusion_torch.io.checkpoint import load_sidecar, load_weights_arrays, weights_exist
from tinydiffusion_torch.io.from_jax import state_dict_by_name
from tinydiffusion_torch.models.unet28 import UNet28


def resolve_dtype(name: str) -> torch.dtype:
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported compute dtype {name!r}; choose one of {sorted(table)}")
    return table[name]


def _load_for_serving(model: nn.Module, flat: dict, device: torch.device):
    """``(model, params, use_ema)``: ``model`` holding the npz's ``params``
    (and BatchNorm statistics), in eval mode on ``device``; ``params`` (name
    -> tensor) the EMA shadow when the npz holds one, else the model's own."""
    model.load_state_dict(state_dict_by_name(flat, params="params"))
    model = model.to(device).eval()
    use_ema = any(k.startswith("ema_params/") for k in flat)
    if use_ema:
        ema = state_dict_by_name(flat, params="ema_params")
        params = {n: ema[n].to(device) for n, _ in model.named_parameters()}
    else:
        params = {n: p.detach() for n, p in model.named_parameters()}
    return model, params, use_ema


def load_pixel_checkpoint(path: str, device: str | torch.device = "cuda") -> dict:
    """A pixel-space UNet28 rebuilt from ``<path>.npz`` + ``<path>.json`` (a
    checkpoint of the JAX package or of the port), everything serving needs
    derived from the sidecar's config, as in JAX: conditionality, time_dim,
    the noise schedule, T, the prediction target and the EMA.

    Returns ``model`` (eval mode on ``device``, holding the trained params
    and the BatchNorm statistics), ``step``, ``params`` (name -> tensor on
    ``device``: the EMA shadow when the run kept one, else the model's own
    parameters; pass it to a sampler), ``schedule`` (on ``device``), ``cfg``,
    ``conditional``, ``num_classes``, ``cfg_trained`` and ``use_ema``.

    A run trained with ``label_dropout > 0`` (classifier-free guidance)
    reserves one more embedding row, the null class ``num_classes``: the
    table has ``num_classes + 1`` rows, and only such a checkpoint can serve
    a guidance scale other than 1. The npz may hold float32 or the
    bfloat16-bits format (``io.checkpoint.load_weights_arrays`` reads both).
    On a card TF32 is turned off: a float32 forward is full float32.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    cfg = load_sidecar(path).get("config", {})
    num_classes = int(cfg["num_classes"]) if "num_classes" in cfg else None
    conditional = num_classes is not None
    cfg_trained = conditional and float(cfg.get("label_dropout", 0.0)) > 0
    flat = load_weights_arrays(path)
    model = UNet28(
        time_dim=int(cfg.get("time_dim", 256)),
        num_classes=(num_classes + 1) if cfg_trained else num_classes,
        base_width=int(cfg.get("base_width", 64)),
    )
    model, params, use_ema = _load_for_serving(model, flat, dev)
    schedule = DiffusionSchedule.make(cfg.get("noise_schedule", "linear"),
                                      int(cfg.get("num_timesteps", 1000))).to(dev)
    return {
        "model": model,
        "step": int(flat["step"]) if "step" in flat else 0,
        "params": params,
        "schedule": schedule,
        "cfg": cfg,
        "conditional": conditional,
        "num_classes": num_classes,
        "cfg_trained": cfg_trained,
        "use_ema": use_ema,
    }


def load_unet28(path: str, device: str | torch.device = "cuda") -> UNet28:
    """The UNet28 of a checkpoint (``load_pixel_checkpoint``) in eval mode on
    ``device``, with its serving params (the EMA shadow when the run kept
    one) loaded into it."""
    loaded = load_pixel_checkpoint(path, device)
    model = loaded["model"]
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(loaded["params"][name])
    return model


def load_latent_checkpoint(path: str, vae_checkpoint: str | None = None, *,
                           device: str | torch.device = "cuda") -> dict:
    """A latent-family denoiser (the MLP UNet or the DiT) and its VAE decoder
    rebuilt from ``<path>.npz`` + ``<path>.json`` (the JAX package's or the
    port's), for serving: the sidecar's ``backbone`` marks such a
    checkpoint, and the VAE is the one it recorded at train time
    (``vae_checkpoint`` overrides the path, for relocated files).

    Unlike training's ``load_vae`` this raises ``FileNotFoundError`` when the
    VAE checkpoint is missing: a fresh random decoder would serve noise.

    Returns ``model`` (eval mode on ``device``), ``step``, ``params`` (name
    -> tensor: the EMA shadow when the run kept one, else the model's own),
    ``vae``, ``latent_dim``, ``schedule``, ``cfg``, ``num_classes``,
    ``prediction``, ``use_ema`` and ``compute_dtype`` (the sidecar's, the
    denoiser's forward dtype in serving: bfloat16 in the committed recipes).
    On a card TF32 is turned off."""
    from tinydiffusion_torch.experiments.latent_diffusion import (
        LatentDiffusionConfig,
        build_denoiser,
        load_vae,
    )

    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    cfg = load_sidecar(path).get("config", {})
    if "backbone" not in cfg:
        raise ValueError(f"{path} is not a latent-family checkpoint (sidecar has no "
                         "'backbone'); pixel checkpoints load via load_pixel_checkpoint")
    known = {f.name for f in dataclasses.fields(LatentDiffusionConfig)}
    lcfg = LatentDiffusionConfig(**{k: v for k, v in cfg.items() if k in known})
    if vae_checkpoint is not None:
        lcfg = dataclasses.replace(lcfg, vae_checkpoint=vae_checkpoint)
    if not weights_exist(lcfg.vae_checkpoint):
        raise FileNotFoundError(
            f"VAE checkpoint {lcfg.vae_checkpoint!r} (recorded in {path}'s sidecar) not "
            "found; pass vae_checkpoint= to point at it")
    vae, latent_dim = load_vae(lcfg, dev)
    flat = load_weights_arrays(path)
    model, params, use_ema = _load_for_serving(build_denoiser(lcfg, latent_dim), flat, dev)
    return {
        "model": model,
        "step": int(flat["step"]) if "step" in flat else 0,
        "params": params,
        "vae": vae,
        "latent_dim": latent_dim,
        "schedule": DiffusionSchedule.make(lcfg.noise_schedule, lcfg.num_timesteps).to(dev),
        "cfg": cfg,
        "num_classes": lcfg.num_classes,
        "prediction": lcfg.prediction,
        "use_ema": use_ema,
        "compute_dtype": resolve_dtype(lcfg.compute_dtype),
    }


def make_latent_pixel_sampler(loaded: dict, n: int, method: str = "ddpm",
                              sample_steps: int = 50, eta: float = 0.0,
                              dtype: torch.dtype = torch.float32):
    """The pixel-space sampler of a ``load_latent_checkpoint``: the latent
    reverse chain (``make_sampler``'s DDPM, DDIM or DPM++ over (n,
    latent_dim), the denoiser in the checkpoint's ``compute_dtype``, the
    chain in ``dtype``) and the VAE's decode. ``fn(generator, y,
    x_init=None, noise_stream=None) -> (n, 1, 28, 28)`` images in [-1, 1],
    as the pixel models serve them."""
    from tinydiffusion_torch.experiments.latent_diffusion import make_latent_sampler

    sampler = make_latent_sampler(
        loaded["vae"], loaded["model"], loaded["schedule"], n, loaded["latent_dim"],
        dtype=dtype, prediction=loaded["prediction"], compute_dtype=loaded["compute_dtype"],
        method=method, sample_steps=sample_steps, eta=eta)

    def sample_fn(generator, y, x_init=None, noise_stream=None):
        x = sampler(generator, params=loaded["params"], y=y, x_init=x_init,
                    noise_stream=noise_stream)
        return x * 2.0 - 1.0  # the decoder's [0, 1] to the pixel models' [-1, 1]

    return sample_fn


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


def _denoiser(model, schedule, params, y, conditional, prediction, compute_dtype,
              guidance_scale=1.0, null_label=None):
    """``apply_fn(x, t) -> eps_hat`` over ``model`` in eval mode, with
    ``params`` (name -> tensor, e.g. an EMA shadow) in place of its own. The
    model runs in ``compute_dtype`` (bfloat16: under ``torch.autocast``),
    whatever the chain's dtype; its float32 output goes back to the chain.

    With guidance, the conditional and the null-label predictions come from
    one forward at doubled batch (``[y, null]`` stacked; eval-mode BatchNorm
    makes the rows independent): ``eps_n + s * (eps_c - eps_n)``."""
    guided = conditional and guidance_scale != 1.0
    if guided:
        y = torch.cat([y, torch.full_like(y, null_label)])
    args = (y,) if conditional else ()

    def forward(x, t_vec):
        with torch.autocast(x.device.type, dtype=compute_dtype,
                            enabled=compute_dtype != torch.float32):
            if params is None:
                out = model(x, t_vec, *args)
            else:
                out = torch.func.functional_call(model, params, (x, t_vec, *args))
        return eps_from_v(schedule, x, out, t_vec) if prediction == "v" else out

    def apply_fn(x, t_vec):
        x = x.float()
        if not guided:
            return forward(x, t_vec)
        eps_c, eps_n = forward(torch.cat([x, x]), torch.cat([t_vec, t_vec])).chunk(2)
        return eps_n + guidance_scale * (eps_c - eps_n)

    return apply_fn


def to_nhwc01(x: torch.Tensor) -> np.ndarray:
    """Samples in [-1, 1] (B, C, H, W) -> [0, 1] NHWC numpy, for the grids."""
    return ((x.float() + 1) / 2).permute(0, 2, 3, 1).cpu().numpy()


def _check_prediction(prediction: str) -> None:
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}; use 'eps' or 'v'")


def _check_labels(conditional: bool, y, n: int) -> None:
    if conditional:
        if y is None:
            raise ValueError("Conditional model requires labels y for sampling")
        if tuple(y.shape) != (n,):
            raise ValueError(f"y must have shape ({n},) to match n_samples, got {tuple(y.shape)}")


def make_sampler(
    model: nn.Module,
    schedule: DiffusionSchedule,
    sample_shape: tuple[int, ...],
    conditional: bool = False,
    dtype: torch.dtype = torch.float32,
    method: str = "ddpm",
    sample_steps: int = 50,
    eta: float = 0.0,
    guidance_scale: float = 1.0,
    null_label: int | None = None,
    prediction: str = "eps",
    t_start: int | None = None,
    mask: torch.Tensor | None = None,
    x_known: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """The sampler over ``model`` in eval mode: ``sample_fn(generator,
    params=None, y=None, n=None, x_init=None, noise_stream=None,
    known_stream=None) -> x_0`` of ``sample_shape`` (NCHW), on the
    schedule's device.

    - ``method``: ``"ddpm"``, the T-step ancestral chain; ``"ddim"``,
      ``sample_steps`` forwards (deterministic at ``eta`` = 0); ``"dpmpp"``,
      DPM-Solver++(2M) in ``sample_steps`` forwards (``core.sampler``).
    - ``dtype`` is the chain's; ``compute_dtype`` the model's forward (JAX's
      model dtype: its serving path runs a bfloat16 UNet28 under a float32
      chain).
    - ``guidance_scale`` != 1 on a conditional model trained with label
      dropout samples with classifier-free guidance against ``null_label``,
      the reserved embedding row.
    - ``prediction="v"`` converts the output to eps (``core.process.eps_from_v``).
    - ``t_start`` (DDIM only) runs the img2img partial chain: pass the noised
      image as ``x_init``. ``mask``/``x_known`` inpaint (DDPM or DDIM).

    ``params`` replaces the model's parameters (an EMA shadow); the model's
    own buffers (BatchNorm statistics) are used, as JAX samples with the live
    ``batch_stats``. The arguments are checked here, on the host, with JAX's
    ``ValueError``s."""
    if method not in ("ddpm", "ddim", "dpmpp"):
        raise ValueError(f"unknown sampler method {method!r}; use 'ddpm', 'ddim', or 'dpmpp'")
    _check_prediction(prediction)
    if t_start is not None and method != "ddim":
        raise ValueError("t_start (img2img) requires method='ddim'")
    if method == "dpmpp" and (mask is not None or x_known is not None):
        raise ValueError("inpainting (mask/x_known) requires 'ddpm' or 'ddim'")
    if conditional and guidance_scale != 1.0 and null_label is None:
        raise ValueError("guidance_scale != 1 needs null_label (a model trained with "
                         "label_dropout; the reserved null embedding row)")

    def sample_fn(generator=None, params=None, y=None, n=None, x_init=None, noise_stream=None,
                  known_stream=None):
        shape = tuple(sample_shape) if n is None else (n,) + tuple(sample_shape[1:])
        _check_labels(conditional, y, shape[0])
        apply_fn = _denoiser(model, schedule, params, y, conditional, prediction, compute_dtype,
                             guidance_scale, null_label)
        with _eval_mode(model):
            if method == "dpmpp":
                return dpmpp_sample(apply_fn, schedule, shape, generator,
                                    num_steps=sample_steps, dtype=dtype, x_init=x_init)
            if method == "ddim":
                return ddim_sample(apply_fn, schedule, shape, generator, num_steps=sample_steps,
                                   eta=eta, dtype=dtype, x_init=x_init, t_start=t_start,
                                   mask=mask, x_known=x_known, noise_stream=noise_stream,
                                   known_stream=known_stream)
            return ddpm_sample(apply_fn, schedule, shape, generator, dtype=dtype, x_init=x_init,
                               noise_stream=noise_stream, mask=mask, x_known=x_known,
                               known_stream=known_stream)

    return sample_fn


def make_trajectory_sampler(
    model: nn.Module,
    schedule: DiffusionSchedule,
    sample_shape: tuple[int, ...],
    stride: int = 100,
    conditional: bool = False,
    dtype: torch.dtype = torch.float32,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
):
    """The coarse denoising-trajectory sampler (the reference's
    ``visualize_denoising_process``): ``traj_fn(generator, params=None,
    y=None, x_init=None, noise_stream=None) -> (T // stride,
    *sample_shape)``, the chain in ``dtype``, the model in ``compute_dtype``."""
    _check_prediction(prediction)

    def traj_fn(generator=None, params=None, y=None, x_init=None, noise_stream=None):
        _check_labels(conditional, y, sample_shape[0])
        apply_fn = _denoiser(model, schedule, params, y, conditional, prediction, compute_dtype)
        with _eval_mode(model):
            return ddpm_denoising_trajectory(apply_fn, schedule, sample_shape, generator,
                                             stride=stride, dtype=dtype, x_init=x_init,
                                             noise_stream=noise_stream)

    return traj_fn


# The largest dataset that ``data_placement="auto"`` keeps in device memory:
# the JAX package's ceiling. MNIST uint8 (47 MB) is far under it, and 4 GiB
# leaves an 80 GB card its memory for weights, optimizer and activations.
RESIDENT_AUTO_LIMIT_BYTES = 4 << 30


def resolve_data_placement(placement: str, dataset_bytes: int, name: str = "experiment") -> bool:
    """Whether a config's ``data_placement`` takes the resident path, by the
    JAX package's rule on one device: ``"host"`` streams batches from the
    host, ``"device"`` keeps the dataset in device memory
    (``data.device.DeviceDataset``), and ``"auto"``, the default, does so
    whenever the dataset fits under ``RESIDENT_AUTO_LIMIT_BYTES``."""
    if placement not in ("host", "device", "auto"):
        raise ValueError(f"data_placement={placement!r}; choose 'host', 'device', or 'auto'")
    if placement == "host":
        return False
    if placement == "auto" and dataset_bytes > RESIDENT_AUTO_LIMIT_BYTES:
        logging.getLogger(f"tinydiffusion_torch.{name}").info(
            "data_placement=auto: dataset (%.1f GB) exceeds the %.0f GB resident "
            "ceiling; streaming from host",
            dataset_bytes / 2**30, RESIDENT_AUTO_LIMIT_BYTES / 2**30)
        return False
    return True


def add_config_flags(parser: argparse.ArgumentParser, config) -> None:
    """Expose every dataclass config field as a ``--flag``."""
    for f in dataclasses.fields(config):
        val = getattr(config, f.name)
        flag = f"--{f.name.replace('_', '-')}"
        if isinstance(val, bool):
            parser.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=val)
        elif val is None:
            parser.add_argument(flag, type=str, default=None)
        else:
            parser.add_argument(flag, type=type(val), default=val)


def config_from_args(config_cls, args: argparse.Namespace):
    return config_cls(**{
        f.name: getattr(args, f.name) for f in dataclasses.fields(config_cls)
        if hasattr(args, f.name)
    })
