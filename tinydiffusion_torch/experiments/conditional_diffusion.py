"""Class-conditional MNIST DDPM with classifier-free guidance: train, validate,
keep the best checkpoint, sample labelled grids.

Counterpart of ``tinydiffusion_tpu/experiments/conditional_diffusion.py``
(``ConditionalDiffusionConfig``, ``run``, ``main``). Reference recipe: the
UNet28 with an ``Embedding(10, 256)`` added to its time embedding; an 80/20
train/val split (seed 42); Adam 1e-3; per epoch the mean train loss, an
eval-mode val pass, the best-val checkpoint and 16 samples at random labels
in a labelled grid; after training, 16 samples of the digit 7 and a
labelled denoising trajectory. With ``label_dropout`` > 0 each train label
becomes the null class (one more embedding row) at that rate, and
``guidance_scale`` samples with classifier-free guidance.

Run on the card (the default) or, when asked, on the CPU::

    python -m tinydiffusion_torch.experiments.conditional_diffusion \\
        --num-epochs 2 --max-steps-per-epoch 25 --label-dropout 0.1 \\
        --guidance-scale 2.0 --ema-decay 0.999 --out-dir /tmp/c \\
        --data-root /tmp/c/data --model-save-path /tmp/c/ckpt [--device cpu]

By default, as in JAX, the train split sits on the device and each chunk of
``log_every`` steps runs as replays of one captured CUDA graph (eagerly on
the CPU); the val split sits there too and its pass reads the losses once.
Under ``torchrun --nproc_per_node N`` the run is data-parallel over N
processes (``parallel/``; ``--batch-size`` is the global batch); rank 0
alone samples, logs and writes.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data.loader import BatchIterator
from tinydiffusion_torch.data.mnist import (
    MNIST_SCALE,
    MNIST_SHIFT,
    load_mnist_u8,
    train_val_split,
)
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
from tinydiffusion_torch.io.checkpoint import BestKeeper
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.obs.images import save_image_grid
from tinydiffusion_torch.obs.metrics import MetricsLogger, Throughput
from tinydiffusion_torch.parallel.distributed import maybe_initialize_distributed
from tinydiffusion_torch.parallel.mesh import is_main, make_mesh_for_batch, shard
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.train.trainer import (
    create_train_state,
    make_eval_step,
    make_resident_eval,
    make_resident_multi_step,
    make_train_step,
)

# The val pass's key: (seed + 1, epoch * VAL_FOLD_STRIDE + batch), JAX's
# fold_in cadence.
VAL_FOLD_STRIDE = 10000


@dataclasses.dataclass
class ConditionalDiffusionConfig:
    """The JAX ``ConditionalDiffusionConfig``'s fields and defaults (all but
    one, below), plus ``device`` and ``base_width``.

    - ``compute_dtype`` is the model's (train, val and sampling forwards,
      flax's ``dtype=``, ``nn.layers.computing_in``); the sampling chain runs in
      ``sample_dtype``. On a card ``run`` turns TF32 off for the process.
    - ``data_placement``: JAX's rule (``experiments.common.resolve_data_placement``);
      ``"auto"`` keeps both splits on the device.
    - ``use_mesh``: data parallelism over the processes of the group that
      ``main`` joins, as in ``experiments.diffusion``.
    - ``model_save_path`` defaults under ``runs/``, not to the JAX default
      ``checkpoints/conditional_diffusion_best``: the port's ``.npz`` export
      would overwrite the committed JAX weights there.
    """

    num_epochs: int = 100
    batch_size: int = 128
    lr: float = 1e-3
    num_timesteps: int = 1000
    num_classes: int = 10
    time_dim: int = 256
    n_samples: int = 16
    seed: int = 0
    val_frac: float = 0.2
    split_seed: int = 42
    data_root: str = "./data"
    out_dir: str = "runs/conditional_diffusion"
    model_save_path: str = "runs/conditional_diffusion/conditional_diffusion_best"
    compute_dtype: str = "bfloat16"
    sample_dtype: str = "float32"
    use_mesh: bool = True
    log_every: int = 100
    sample_every_epoch: bool = True
    visualize_denoising: bool = True
    denoising_stride: int = 100
    max_steps_per_epoch: int = 0
    data_placement: str = "auto"
    ema_decay: float = 0.0
    label_dropout: float = 0.0
    guidance_scale: float = 1.0
    noise_schedule: str = "linear"
    prediction: str = "eps"
    base_width: int = 64
    device: str = "cuda"


def run(config: ConditionalDiffusionConfig) -> dict:
    """Train, validate, checkpoint and sample as the config says. Returns
    ``losses`` (the logged ones), ``val_losses`` (per epoch),
    ``samples_per_sec`` (the last epoch's), ``epochs`` (per epoch: the mean
    ``train_loss``, ``samples_per_sec``, ``train_seconds``, ``val_seconds``,
    ``sample_seconds``), ``resident``, ``graph`` (the resident step's
    counts of eager steps, captures and replays), ``qsample_launches`` (the
    kernel's launches in the ``train`` steps and the ``eval`` passes; 0 on
    the CPU), ``digit7_seconds`` and the final ``state``. A rank left idle
    by the data axis's gcd rule returns ``{"idle": True}``."""
    dp = make_mesh_for_batch(config.batch_size) if config.use_mesh else None
    if dp is not None and not dp.active:
        return {"idle": True}
    main = is_main(dp)
    device = resolve_device(config.device)
    dtype = resolve_dtype(config.compute_dtype)
    sample_dtype = resolve_dtype(config.sample_dtype)
    if device.type == "cuda":
        disable_tf32()

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    images_u8, labels = load_mnist_u8(config.data_root, train=True)
    xt, yt, xv, yv = train_val_split(images_u8, labels, config.val_frac, seed=config.split_seed)
    resident = resolve_data_placement(config.data_placement, xt.nbytes + yt.nbytes,
                                      "conditional", config.batch_size,
                                      1 if dp is None else dp.size)
    schedule = DiffusionSchedule.make(config.noise_schedule, config.num_timesteps).to(device)
    use_cfg = config.label_dropout > 0
    null_label = config.num_classes
    with torch.random.fork_rng(devices=[]):  # seeded init, global RNG untouched
        torch.manual_seed(config.seed)
        model = UNet28(time_dim=config.time_dim, base_width=config.base_width,
                       num_classes=config.num_classes + (1 if use_cfg else 0))
    model = model.to(device)
    # A captured step needs Adam's step count on the device.
    optimizer = torch.optim.Adam(model.parameters(), lr=config.lr,
                                 capturable=resident and device.type == "cuda")
    use_ema = config.ema_decay > 0
    state = create_train_state(model, optimizer, config.seed, ema=use_ema)
    step_options = dict(ema_decay=config.ema_decay if use_ema else None,
                        prediction=config.prediction, compute_dtype=dtype, conditional=True,
                        label_dropout=config.label_dropout, null_label=null_label, dp=dp)
    eval_step = make_eval_step(schedule, conditional=True, prediction=config.prediction,
                               compute_dtype=dtype, dp=dp)
    u8 = (MNIST_SCALE, MNIST_SHIFT)
    if resident:
        train_data = DeviceDataset(xt, config.batch_size, seed=config.seed, device=device,
                                   labels=yt)
        val_data = DeviceDataset(xv, config.batch_size, seed=config.seed, device=device,
                                 labels=yv, shuffle=False)
        train_chunk = make_resident_multi_step(schedule, train_data, **step_options)
        resident_eval = make_resident_eval(eval_step, val_data, config.seed + 1, VAL_FOLD_STRIDE)
    else:
        train_it = BatchIterator([xt, yt], config.batch_size, shuffle=True, seed=config.seed,
                                 u8_normalize=u8)
        val_it = BatchIterator([xv, yv], config.batch_size, shuffle=False, u8_normalize=u8)
        train_step = make_train_step(schedule, **step_options)
    sampler = make_sampler(
        model, schedule, (config.n_samples, 1, 28, 28), conditional=True, dtype=sample_dtype,
        guidance_scale=config.guidance_scale, null_label=null_label if use_cfg else None,
        prediction=config.prediction, compute_dtype=dtype)
    sample_gen = torch.Generator(device).manual_seed(config.seed + 2)

    logger = MetricsLogger("conditional-diffusion-mnist", config.out_dir,
                           dataclasses.asdict(config), enabled=main)
    keeper = BestKeeper(config.model_save_path, enabled=main)
    throughput = Throughput()
    result = {"losses": [], "val_losses": [], "samples_per_sec": 0.0, "epochs": [],
              "resident": resident, "qsample_launches": {"train": 0, "eval": 0}}
    launches = result["qsample_launches"]
    for epoch in range(config.num_epochs):
        epoch_t0 = time.perf_counter()
        throughput.reset()
        before = qsample.qsample_launches
        losses = []  # device tensors, read once at the epoch's end
        if resident:
            idxs = train_data.epoch_index_batches(epoch)
            if config.max_steps_per_epoch:
                idxs = idxs[: config.max_steps_per_epoch]
            for start in range(0, len(idxs), config.log_every):
                chunk = idxs[start : start + config.log_every]
                chunk_losses = train_chunk(state, shard(dp, chunk, dim=1))
                losses.append(chunk_losses)
                throughput.add(len(chunk) * config.batch_size)
                loss_val = float(chunk_losses[0])  # syncs, once a chunk
                logger.log({"epoch": epoch, "batch": start, "batch_train_loss": loss_val},
                           step=state.step - len(chunk))
                result["losses"].append(loss_val)
        else:
            for batch_idx, batch in enumerate(train_it.epoch(epoch)):
                if config.max_steps_per_epoch and batch_idx >= config.max_steps_per_epoch:
                    break
                x0, y = train_it.to_device([shard(dp, a) for a in batch], device)
                loss = train_step(state, x0.permute(0, 3, 1, 2), y.long())
                losses.append(loss.view(1))
                throughput.add(config.batch_size)
                if batch_idx % config.log_every == 0:
                    loss_val = float(loss)  # syncs, at log points only
                    logger.log({"epoch": epoch, "batch": batch_idx,
                                "batch_train_loss": loss_val}, step=state.step - 1)
                    result["losses"].append(loss_val)
        avg_train_loss = torch.cat(losses).double().mean().item() if losses else 0.0  # syncs
        sps = throughput.samples_per_sec
        result["samples_per_sec"] = sps
        train_seconds = time.perf_counter() - epoch_t0
        launches["train"] += qsample.qsample_launches - before

        # Validation: eval-mode BN, a fixed draw per (epoch, batch).
        val_t0 = time.perf_counter()
        before = qsample.qsample_launches
        if resident:
            vidxs = val_data.epoch_index_batches(0)
            if config.max_steps_per_epoch:
                vidxs = vidxs[: config.max_steps_per_epoch]
            val_losses = resident_eval(state.model, epoch, shard(dp, vidxs, dim=1))
        else:
            val_losses = []
            for batch_idx, batch in enumerate(val_it.epoch()):
                if config.max_steps_per_epoch and batch_idx >= config.max_steps_per_epoch:
                    break
                x0, y = val_it.to_device([shard(dp, a) for a in batch], device)
                key = (config.seed + 1, epoch * VAL_FOLD_STRIDE + batch_idx)
                val_losses.append(eval_step(state.model, x0.permute(0, 3, 1, 2), key,
                                            y.long()).view(1))
            val_losses = torch.cat(val_losses) if val_losses else torch.zeros(0)
        launches["eval"] += qsample.qsample_launches - before
        avg_val_loss = (val_losses.double().mean().item() if len(val_losses)
                        else avg_train_loss)
        val_seconds = time.perf_counter() - val_t0
        result["val_losses"].append(avg_val_loss)
        logger.log({"epoch": epoch, "train_loss": avg_train_loss, "val_loss": avg_val_loss,
                    "train_samples_per_sec": sps}, step=state.step)
        if keeper.update(avg_val_loss, state, config=dataclasses.asdict(config),
                         epoch=epoch) and main:
            print(f"Saved best model at epoch {epoch} with val loss: {avg_val_loss:.4f}")

        sample_seconds = None
        if config.sample_every_epoch and main:
            t0 = time.perf_counter()
            y_sample = torch.randint(0, config.num_classes, (config.n_samples,),
                                     generator=sample_gen, device=device)
            samples = sampler(sample_gen, params=state.ema_params, y=y_sample)
            synchronize()
            sample_seconds = time.perf_counter() - t0
            grid = f"{config.out_dir}/generated_mnist_epoch_{epoch}.png"
            save_image_grid(to_nhwc01(samples), grid, nrow=4, labels=y_sample.tolist())
            logger.log_image("samples", grid, state.step)
        result["epochs"].append({"train_loss": avg_train_loss, "samples_per_sec": sps,
                                 "train_seconds": train_seconds, "val_seconds": val_seconds,
                                 "sample_seconds": sample_seconds})

    # The digit-7 grid (conditional_diffusion.py:474-485).
    result["digit7_seconds"] = None
    if main:
        synchronize()
        t0 = time.perf_counter()
        y7 = torch.full((config.n_samples,), 7, dtype=torch.int64, device=device)
        samples = sampler(sample_gen, params=state.ema_params, y=y7)
        synchronize()
        result["digit7_seconds"] = time.perf_counter() - t0
        grid = f"{config.out_dir}/generated_digit_7.png"
        save_image_grid(to_nhwc01(samples), grid, nrow=4, labels=[7] * config.n_samples)
        logger.log_image("final_samples", grid, state.step)

    if config.visualize_denoising and main:
        traj_fn = make_trajectory_sampler(
            model, schedule, (4, 1, 28, 28), stride=config.denoising_stride, conditional=True,
            dtype=sample_dtype, prediction=config.prediction, compute_dtype=dtype)
        y_traj = torch.randint(0, config.num_classes, (4,), generator=sample_gen, device=device)
        trajectory = traj_fn(sample_gen, params=state.ema_params, y=y_traj)
        y_labels = y_traj.tolist()
        for i, frame in enumerate(trajectory):
            t_label = config.num_timesteps - i * config.denoising_stride
            save_image_grid(to_nhwc01(frame), f"{config.out_dir}/denoising_t{t_label}.png",
                            nrow=2, labels=y_labels)
        logger.log_image("denoising_trajectory", f"{config.out_dir}/denoising_t0.png",
                         state.step)

    result["graph"] = dict(train_chunk.counts) if resident else None
    result["state"] = state
    logger.finish()
    return result


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_config_flags(parser, ConditionalDiffusionConfig())
    config = config_from_args(ConditionalDiffusionConfig, parser.parse_args(argv))
    maybe_initialize_distributed(config.device)
    device = resolve_device(config.device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    run(config)


if __name__ == "__main__":
    main()
