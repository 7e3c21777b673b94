"""Shared experiment plumbing: dtypes, the sampler factories, weights, CLI.

Counterpart of ``tinydiffusion_tpu/experiments/common.py`` (``resolve_dtype``,
the ``ddpm`` branch of ``make_sampler``, ``make_trajectory_sampler``,
``RESIDENT_AUTO_LIMIT_BYTES`` and ``resolve_data_placement`` for one card,
``add_config_flags``, ``config_from_args``). The flag names are the JAX
ones, so the two CLIs take the same arguments. DDIM, DPM-Solver++,
inpainting and classifier-free guidance come with the serving slice.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging

import torch
from torch import nn

from tinydiffusion_torch.core.process import eps_from_v
from tinydiffusion_torch.core.sampler import ddpm_denoising_trajectory, ddpm_sample
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.device import disable_tf32, resolve_device
from tinydiffusion_torch.io.checkpoint import load_sidecar, load_weights_arrays
from tinydiffusion_torch.io.from_jax import unet28_state_dict
from tinydiffusion_torch.models.unet28 import UNet28


def resolve_dtype(name: str) -> torch.dtype:
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported compute dtype {name!r}; choose one of {sorted(table)}")
    return table[name]


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


def _denoiser(model, schedule, params, y, conditional, prediction, dtype):
    """``apply_fn(x, t) -> eps_hat`` over ``model`` in eval mode, with
    ``params`` (name -> tensor, e.g. an EMA shadow) in place of its own."""
    args = (y,) if conditional else ()
    autocast = dtype != torch.float32

    def apply_fn(x, t_vec):
        with torch.autocast(x.device.type, dtype=dtype, enabled=autocast):
            if params is None:
                out = model(x, t_vec, *args)
            else:
                out = torch.func.functional_call(model, params, (x, t_vec, *args))
        return eps_from_v(schedule, x, out, t_vec) if prediction == "v" else out

    return apply_fn


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
    prediction: str = "eps",
):
    """The T-step ancestral DDPM sampler over ``model`` in eval mode:
    ``sample_fn(generator, params=None, y=None, n=None, x_init=None,
    noise_stream=None) -> x_0`` of ``sample_shape`` (NCHW), on the
    schedule's device, with the chain in ``dtype``.

    ``params`` replaces the model's parameters (an EMA shadow); the model's
    own buffers (BatchNorm statistics) are used, as JAX samples with the
    live ``batch_stats``. ``prediction='v'`` converts the model's output to
    eps (``core.process.eps_from_v``)."""
    _check_prediction(prediction)

    def sample_fn(generator=None, params=None, y=None, n=None, x_init=None, noise_stream=None):
        shape = sample_shape if n is None else (n,) + tuple(sample_shape[1:])
        _check_labels(conditional, y, shape[0])
        apply_fn = _denoiser(model, schedule, params, y, conditional, prediction, dtype)
        with _eval_mode(model):
            return ddpm_sample(apply_fn, schedule, shape, generator, dtype=dtype,
                               x_init=x_init, noise_stream=noise_stream)

    return sample_fn


def make_trajectory_sampler(
    model: nn.Module,
    schedule: DiffusionSchedule,
    sample_shape: tuple[int, ...],
    stride: int = 100,
    dtype: torch.dtype = torch.float32,
    prediction: str = "eps",
):
    """The coarse denoising-trajectory sampler of an unconditional model (the
    reference's ``visualize_denoising_process``): ``traj_fn(generator,
    params=None, x_init=None, noise_stream=None) -> (T // stride,
    *sample_shape)``."""
    _check_prediction(prediction)

    def traj_fn(generator=None, params=None, x_init=None, noise_stream=None):
        apply_fn = _denoiser(model, schedule, params, None, False, prediction, dtype)
        with _eval_mode(model):
            return ddpm_denoising_trajectory(apply_fn, schedule, sample_shape, generator,
                                             stride=stride, dtype=dtype, x_init=x_init,
                                             noise_stream=noise_stream)

    return traj_fn


def load_unet28(path: str, device: str | torch.device = "cuda") -> UNet28:
    """The UNet28 of ``<path>.npz`` + ``<path>.json`` (a checkpoint of the
    JAX package or of the port), in eval mode on ``device``; its EMA shadow
    when the run kept one. On a card it turns TF32 off: the model is served
    in float32."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    config = load_sidecar(path)["config"]
    flat = load_weights_arrays(path)
    model = UNet28(
        time_dim=config.get("time_dim", 256),
        num_classes=config.get("num_classes"),
        base_width=config.get("base_width", 64),
    )
    ema = any(k.startswith("ema_params/") for k in flat)
    model.load_state_dict(unet28_state_dict(flat, params="ema_params" if ema else "params"))
    return model.to(dev).eval()


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
