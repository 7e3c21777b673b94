"""Unconditional MNIST DDPM: train the UNet28, sample, write grids and a checkpoint.

Counterpart of ``tinydiffusion_tpu/experiments/diffusion.py`` (``run``,
``main``, ``DiffusionConfig``), the system's main path. Reference recipe:
MNIST in [-1, 1], batch 128 shuffled, Adam lr 1e-3, T = 1000 linear betas;
after each epoch, 16 samples from the 1000-step ancestral sampler saved as a
4x4 PNG grid; at the end, the coarse denoising trajectory and the
checkpoint (``<checkpoint_path>.pt`` to resume, ``.npz`` in the JAX format,
``.json``).

Run on the card (the default) or, when asked, on the CPU::

    python -m tinydiffusion_torch.experiments.diffusion --num-epochs 2 \\
        --max-steps-per-epoch 25 --out-dir /tmp/d --data-root /tmp/d/data \\
        --checkpoint-path /tmp/d/ckpt [--device cpu]

The flags are the JAX CLI's, plus ``--device`` and ``--base-width``. By
default, as in JAX, the set is resident on the device and each chunk of
``log_every`` steps runs as replays of one captured CUDA graph (eagerly on
the CPU, which has no graphs). Under ``torchrun --nproc_per_node N`` the run
is data-parallel over N processes (one a card, or gloo on the CPU;
``parallel/``): ``--batch-size`` is the global batch, and rank 0 alone
samples, logs and writes.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data.loader import BatchIterator
from tinydiffusion_torch.data.mnist import MNIST_SCALE, MNIST_SHIFT, load_mnist_u8
from tinydiffusion_torch.device import disable_tf32, resolve_device
from tinydiffusion_torch.experiments.common import (
    add_config_flags,
    config_from_args,
    make_sampler,
    make_trajectory_sampler,
    resolve_data_placement,
    resolve_dtype,
    to_nhwc01,
)
from tinydiffusion_torch.io.checkpoint import save_checkpoint
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.obs.images import save_image_grid
from tinydiffusion_torch.obs.metrics import MetricsLogger, Throughput
from tinydiffusion_torch.parallel.distributed import maybe_initialize_distributed
from tinydiffusion_torch.parallel.mesh import is_main, make_mesh_for_batch, shard
from tinydiffusion_torch.train.trainer import (
    create_train_state,
    make_resident_multi_step,
    make_train_step,
)


@dataclasses.dataclass
class DiffusionConfig:
    """The JAX ``DiffusionConfig``'s fields and defaults (all but one, below),
    plus ``device`` and ``base_width``.

    - ``compute_dtype``: ``"bfloat16"`` (the JAX default) runs the model's
      forward, in training and in sampling, in bfloat16 as flax's ``dtype=``;
      ``"float32"`` runs it in full float32. The sampling chain runs in
      ``sample_dtype``, as in JAX. On a card ``run`` turns TF32 off for the
      process, whatever the dtypes, so float32 is full float32.
    - ``use_mesh``: as in JAX, the run is data-parallel over every process
      of the group that ``main`` joins (``parallel.mesh.make_mesh_for_batch``:
      the largest count that divides ``batch_size``); one process, or
      ``use_mesh`` false, trains on one device.
    - ``data_placement``: JAX's rule (``experiments.common.resolve_data_placement``).
      ``"host"`` streams uint8 batches from the host; ``"device"`` keeps the
      uint8 set on the device (``data.device.DeviceDataset``) and runs each
      chunk of ``log_every`` index batches through
      ``train.trainer.make_resident_multi_step``: on a card, replays of one
      captured CUDA graph, on the CPU the same step eagerly. ``"auto"`` is
      ``"device"`` when the set fits under 4 GiB (MNIST always does), and
      ``"host"`` when ``fused_qsample`` is set, as in JAX, so that the two
      CLIs take the same path for the same flags.
    - ``fused_qsample`` selects nothing else: the port's step draws its
      noise with the fused q_sample on both paths (the CUDA kernel on a
      card, its plain version on the CPU), where JAX's resident path draws
      it with ``jax.random``.
    - ``checkpoint_path`` defaults under ``runs/``, not to the JAX default
      ``checkpoints/diffusion_final``: the port's ``.npz`` export would
      overwrite the committed JAX weights there.
    """

    num_epochs: int = 100
    batch_size: int = 128
    lr: float = 1e-3
    num_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    time_dim: int = 256
    n_samples: int = 16
    seed: int = 0
    data_root: str = "./data"
    out_dir: str = "runs/diffusion"
    compute_dtype: str = "bfloat16"
    use_mesh: bool = True
    log_every: int = 100
    sample_every_epoch: bool = True
    visualize_denoising: bool = True
    denoising_stride: int = 100
    checkpoint_path: str = "runs/diffusion/diffusion_final"
    sample_dtype: str = "float32"
    max_steps_per_epoch: int = 0  # 0 = unlimited
    fused_qsample: bool = False
    data_placement: str = "auto"
    noise_schedule: str = "linear"
    prediction: str = "eps"
    ema_decay: float = 0.0
    base_width: int = 64
    device: str = "cuda"


def use_resident_path(config: DiffusionConfig, dataset_bytes: int, data_axis: int = 1) -> bool:
    """Whether ``run`` keeps the set on the device: JAX's rule, where
    ``"auto"`` with ``fused_qsample`` resolves to the host path."""
    placement = config.data_placement
    if placement == "auto" and config.fused_qsample:
        placement = "host"
    return resolve_data_placement(placement, dataset_bytes, "diffusion", config.batch_size,
                                  data_axis)


def run(config: DiffusionConfig) -> dict:
    """Train, sample and checkpoint as the config says. Returns ``losses``
    (the logged ones), ``samples_per_sec`` (the last epoch's), ``epochs``
    (per epoch: ``samples_per_sec``, ``epoch_seconds``, ``sample_seconds``),
    ``resident`` (whether the set stayed on the device) and the final
    ``state``. Under data parallelism every rank returns these (the losses
    are the group's); a rank left idle by the gcd rule returns
    ``{"idle": True}`` without training."""
    dp = make_mesh_for_batch(config.batch_size) if config.use_mesh else None
    if dp is not None and not dp.active:
        return {"idle": True}
    main = is_main(dp)
    device = resolve_device(config.device)
    dtype = resolve_dtype(config.compute_dtype)
    sample_dtype = resolve_dtype(config.sample_dtype)
    if device.type == "cuda":
        disable_tf32()  # float32 is full float32, in the step and in the chain

    images_u8, _ = load_mnist_u8(config.data_root, train=True)
    resident = use_resident_path(config, images_u8.nbytes, 1 if dp is None else dp.size)
    if resident:
        data = DeviceDataset(images_u8, config.batch_size, seed=config.seed, device=device)
    else:
        data = BatchIterator([images_u8], config.batch_size, shuffle=True, seed=config.seed,
                             u8_normalize=(MNIST_SCALE, MNIST_SHIFT))
    if config.noise_schedule == "linear":
        schedule = DiffusionSchedule.linear(config.num_timesteps, config.beta_start,
                                            config.beta_end)
    else:
        schedule = DiffusionSchedule.make(config.noise_schedule, config.num_timesteps)
    schedule = schedule.to(device)

    with torch.random.fork_rng(devices=[]):  # seeded init, global RNG untouched
        torch.manual_seed(config.seed)
        model = UNet28(time_dim=config.time_dim, base_width=config.base_width)
    model = model.to(device)
    # A captured step needs Adam's step count on the device.
    optimizer = torch.optim.Adam(model.parameters(), lr=config.lr,
                                 capturable=resident and device.type == "cuda")
    use_ema = config.ema_decay > 0
    state = create_train_state(model, optimizer, config.seed, ema=use_ema)
    step_options = dict(ema_decay=config.ema_decay if use_ema else None,
                        prediction=config.prediction, compute_dtype=dtype, dp=dp)
    if resident:
        train_chunk = make_resident_multi_step(schedule, data, **step_options)
    else:
        train_step = make_train_step(schedule, **step_options)
    sampler = make_sampler(model, schedule, (config.n_samples, 1, 28, 28),
                           dtype=sample_dtype, prediction=config.prediction, compute_dtype=dtype)
    sample_gen = torch.Generator(device).manual_seed(config.seed + 2)

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    logger = MetricsLogger("diffusion", config.out_dir, dataclasses.asdict(config), enabled=main)
    throughput = Throughput()
    result = {"losses": [], "samples_per_sec": 0.0, "epochs": [], "resident": resident}
    for epoch in range(config.num_epochs):
        epoch_t0 = time.perf_counter()
        throughput.reset()
        if resident:
            # One chunk of log_every steps a call; losses[0] is the loss at
            # batch index `start`, as the host path logs it.
            idxs = data.epoch_index_batches(epoch)
            if config.max_steps_per_epoch:
                idxs = idxs[: config.max_steps_per_epoch]
            for start in range(0, len(idxs), config.log_every):
                chunk = idxs[start : start + config.log_every]
                losses = train_chunk(state, shard(dp, chunk, dim=1))
                throughput.add(len(chunk) * config.batch_size)
                loss_val = float(losses[0])  # syncs, once a chunk
                logger.log({"epoch": epoch, "batch": start, "loss": loss_val},
                           step=state.step - len(chunk))
                result["losses"].append(loss_val)
        else:
            for batch_idx, batch in enumerate(data.epoch(epoch)):
                if config.max_steps_per_epoch and batch_idx >= config.max_steps_per_epoch:
                    break
                (x0,) = data.to_device([shard(dp, a) for a in batch], device)
                x0 = x0.permute(0, 3, 1, 2)  # NHWC -> NCHW; C = 1, so no copy
                loss = train_step(state, x0)
                throughput.add(config.batch_size)
                if batch_idx % config.log_every == 0:
                    loss_val = float(loss)  # syncs, at log points only
                    logger.log({"epoch": epoch, "batch": batch_idx, "loss": loss_val},
                               step=state.step - 1)
                    result["losses"].append(loss_val)
        synchronize()
        sps = throughput.samples_per_sec
        result["samples_per_sec"] = sps
        sample_seconds = None
        if config.sample_every_epoch and main:
            t0 = time.perf_counter()
            samples = sampler(sample_gen, params=state.ema_params)
            synchronize()
            sample_seconds = time.perf_counter() - t0
            grid = f"{config.out_dir}/generated_mnist_epoch_{epoch}.png"
            save_image_grid(to_nhwc01(samples), grid, nrow=4)
            logger.log_image("samples", grid, state.step)
        epoch_seconds = time.perf_counter() - epoch_t0
        logger.log({"epoch": epoch, "train_samples_per_sec": sps,
                    "epoch_seconds": epoch_seconds}, step=state.step)
        result["epochs"].append({"samples_per_sec": sps, "epoch_seconds": epoch_seconds,
                                 "sample_seconds": sample_seconds})

    if config.visualize_denoising and main:
        traj_fn = make_trajectory_sampler(model, schedule, (4, 1, 28, 28),
                                          stride=config.denoising_stride, dtype=sample_dtype,
                                          prediction=config.prediction, compute_dtype=dtype)
        trajectory = traj_fn(sample_gen, params=state.ema_params)
        for i, frame in enumerate(trajectory):
            t_label = config.num_timesteps - i * config.denoising_stride
            save_image_grid(to_nhwc01(frame), f"{config.out_dir}/denoising_t{t_label}.png",
                            nrow=2)

    if config.checkpoint_path and main:
        save_checkpoint(config.checkpoint_path, state, config=dataclasses.asdict(config))

    result["state"] = state
    logger.finish()
    return result


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_config_flags(parser, DiffusionConfig())
    config = config_from_args(DiffusionConfig, parser.parse_args(argv))
    maybe_initialize_distributed(config.device)
    device = resolve_device(config.device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    run(config)


if __name__ == "__main__":
    main()
