"""Class-conditional latent diffusion over the MNIST VAE: the MLP UNet or the DiT.

Counterpart of ``tinydiffusion_tpu/experiments/latent_diffusion.py``
(``LatentDiffusionConfig``, ``steps_per_epoch_from_split``, ``load_vae``,
``build_denoiser``, ``make_latent_sampler``,
``make_latent_trajectory_sampler``, ``run``, ``main``). Two stages
(latent_diffusion.py:418-458): the VAE checkpoint written by ``python -m
tinydiffusion_torch.experiments.vae`` (or the JAX package's) is loaded with
its config and frozen; the denoiser trains on its 20-d latents (encode +
reparameterise per batch, in the step, without a gradient); Adam 1e-3, an
80/20 split (seed 42), the best-val checkpoint; per epoch 16 labelled
samples, whose 1000-step latent chain ends in the VAE's decoder; after
training the decoded denoising trajectory and a digit-7 grid, with the
faithful ``(x + 1) / 2`` on the decoder's [0, 1] output (451; each grid is
min/max-normalised anyway).

``backbone="dit"`` trains the transformer (the reference's
diffusion_transformer.py): Adam at 3e-4 with a per-epoch cosine schedule
over ``num_epochs`` (176-177, 288), whatever ``lr`` says, as in JAX.

Run on the card (the default) or, when asked, on the CPU::

    python -m tinydiffusion_torch.experiments.latent_diffusion --backbone dit \\
        --num-epochs 2 --max-steps-per-epoch 20 --out-dir /tmp/l \\
        --data-root /tmp/l/data --model-save-path /tmp/l/ckpt [--device cpu]

By default, as in JAX, the train split sits on the device and each chunk of
``log_every`` steps (the gather, the frozen encode, the CUDA q_sample kernel
at (B, latent_dim) and the update) runs as replays of one captured CUDA
graph (eagerly on the CPU); the val split sits there too. The DiT's learning
rate is a device tensor of the capturable Adam, set at each epoch's start,
so that the replays read the new value.

Stated deviations from the JAX run (torch cannot draw JAX's bits): the
denoiser's init is torch's default from ``torch.manual_seed(seed)``; the
step's draws come from the state's generator on the model's device; the val
pass's from ``np.random.default_rng([seed + 11, epoch * 10000 + i])`` (JAX:
``fold_in(PRNGKey(seed + 11), epoch * 10000 + i)``); the samples' labels and
chains from a generator seeded with ``seed + 2``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch
from torch import nn

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
from tinydiffusion_torch.io.checkpoint import (
    BestKeeper,
    load_sidecar,
    load_weights_arrays,
    weights_exist,
)
from tinydiffusion_torch.io.from_jax import vae_mnist_state_dict
from tinydiffusion_torch.models.dit import DiT
from tinydiffusion_torch.models.mlp_unet import MLPUNetLatent
from tinydiffusion_torch.models.vae_mnist import VAEMnist
from tinydiffusion_torch.obs.images import save_image_grid
from tinydiffusion_torch.obs.metrics import MetricsLogger, Throughput
from tinydiffusion_torch.parallel.distributed import maybe_initialize_distributed
from tinydiffusion_torch.parallel.mesh import is_main, make_mesh_for_batch, shard
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.train.trainer import (
    create_train_state,
    make_latent_eval_step,
    make_latent_train_step,
    make_resident_eval,
    make_resident_latent_multi_step,
)

# The val pass's key: (seed + 11, epoch * VAL_FOLD_STRIDE + batch), JAX's
# fold_in cadence.
VAL_FOLD_STRIDE = 10000
# The DiT recipe's peak learning rate (diffusion_transformer.py:176-177).
DIT_LR = 3e-4


@dataclasses.dataclass
class LatentDiffusionConfig:
    """The JAX ``LatentDiffusionConfig``'s fields and defaults (all but one,
    below), plus ``device``.

    - ``model_save_path`` defaults under ``runs/``, not to the JAX default
      ``checkpoints/latent_diffusion_best``: the port's ``.npz`` would
      overwrite the committed JAX weights there. ``vae_checkpoint`` defaults
      to what the port's stage A (``experiments/vae.py``) writes,
      ``runs/vae/checkpoints/vae_mnist_best``, as JAX's stage B reads what
      its stage A writes; the committed VAE is
      ``checkpoints/vae_mnist_best``, passed by name.
    - ``compute_dtype`` is the denoiser's (train, val and sampling forwards,
      bfloat16 under ``torch.autocast``); the frozen VAE runs in float32
      and the sampling chain in ``sample_dtype``. On a card ``run`` turns
      TF32 off for the process.
    - ``data_placement``: JAX's rule; ``"auto"`` keeps both splits on the device.
    - ``use_mesh``: data parallelism over the processes of the group that
      ``main`` joins, as in ``experiments.diffusion``.
    """

    backbone: str = "mlp_unet"
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
    out_dir: str = "runs/latent_diffusion"
    vae_checkpoint: str = "runs/vae/checkpoints/vae_mnist_best"
    model_save_path: str = "runs/latent_diffusion/latent_diffusion_best"
    compute_dtype: str = "bfloat16"
    sample_dtype: str = "float32"
    visualize_denoising: bool = True
    denoising_stride: int = 100
    use_mesh: bool = True
    log_every: int = 100
    sample_every_epoch: bool = True
    max_steps_per_epoch: int = 0
    data_placement: str = "auto"
    ema_decay: float = 0.0
    noise_schedule: str = "linear"
    prediction: str = "eps"
    device: str = "cuda"


def steps_per_epoch_from_split(n_train: int, batch_size: int,
                               max_steps_per_epoch: int = 0) -> int:
    """Train steps per epoch of the train split (full batches only),
    capped by ``max_steps_per_epoch``."""
    steps = n_train // batch_size
    if max_steps_per_epoch:
        steps = min(steps, max_steps_per_epoch)
    return max(steps, 1)


def cosine_decay(init_value: float, decay_steps: int):
    """optax ``cosine_decay_schedule(init_value, decay_steps)``:
    ``count -> init * (1 + cos(pi * min(count, decay_steps) / decay_steps)) / 2``."""

    def schedule(count: int) -> float:
        return init_value * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps)
                                                  / decay_steps))

    return schedule


def load_vae(config: LatentDiffusionConfig, device: str | torch.device = "cuda"):
    """The frozen VAE and its latent size, ``(vae, latent_dim)``: the
    checkpoint at ``config.vae_checkpoint`` (``.npz`` + ``.json``, the JAX
    package's or the port's) built from its sidecar's config
    (latent_diffusion.py:422-434), in eval mode on ``device``, its
    parameters frozen. With no checkpoint there, a fresh default VAE, as
    JAX (and the reference) falls back to."""
    dev = resolve_device(device)
    if weights_exist(config.vae_checkpoint):
        cfg = load_sidecar(config.vae_checkpoint).get("config", {})
        vae = VAEMnist(int(cfg.get("latent_dim", 20)), int(cfg.get("hidden_dim", 400)),
                       int(cfg.get("input_dim", 784)))
        vae.load_state_dict(vae_mnist_state_dict(load_weights_arrays(config.vae_checkpoint)))
        print(f"Loaded VAE from checkpoint: {config.vae_checkpoint}")
    else:
        print(f"VAE checkpoint not found at {config.vae_checkpoint}; using fresh VAE")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            vae = VAEMnist()
    return vae.to(dev).eval().requires_grad_(False), vae.latent_dim


def build_denoiser(config: LatentDiffusionConfig, latent_dim: int) -> nn.Module:
    """The backbone of ``config`` at its widths, float32 params on the CPU
    (the compute dtype is the forward's autocast)."""
    if config.backbone == "dit":
        return DiT(time_dim=config.time_dim, num_classes=config.num_classes,
                   latent_dim=latent_dim)
    if config.backbone != "mlp_unet":
        raise ValueError(f"backbone={config.backbone!r}; choose 'mlp_unet' or 'dit'")
    return MLPUNetLatent(time_dim=config.time_dim, num_classes=config.num_classes,
                         latent_dim=latent_dim)


def make_latent_sampler(vae: VAEMnist, model: nn.Module, schedule: DiffusionSchedule,
                        n_samples: int, latent_dim: int, dtype: torch.dtype = torch.float32,
                        prediction: str = "eps", compute_dtype: torch.dtype = torch.float32,
                        **sampler_options):
    """The latent reverse chain and the decode (latent_diffusion.py:308-347):
    ``sample_fn(generator, params=None, y=None, x_init=None,
    noise_stream=None) -> (n, 1, 28, 28)`` pixel probabilities in [0, 1].
    The chain is ``make_sampler``'s over (n, latent_dim) (DDPM unless
    ``sampler_options`` say ``method``), the denoiser in ``compute_dtype``,
    the decoder in float32."""
    sampler = make_sampler(model, schedule, (n_samples, latent_dim), conditional=True,
                           dtype=dtype, prediction=prediction, compute_dtype=compute_dtype,
                           **sampler_options)

    def sample_fn(generator=None, params=None, y=None, x_init=None, noise_stream=None):
        z = sampler(generator, params=params, y=y, x_init=x_init, noise_stream=noise_stream)
        with torch.no_grad():
            return vae.decode(z.float()).reshape(-1, 1, 28, 28)

    return sample_fn


def make_latent_trajectory_sampler(vae: VAEMnist, model: nn.Module,
                                   schedule: DiffusionSchedule, n_samples: int,
                                   latent_dim: int, stride: int,
                                   dtype: torch.dtype = torch.float32, prediction: str = "eps",
                                   compute_dtype: torch.dtype = torch.float32):
    """The coarse strided latent trajectory, each frame decoded
    (latent_diffusion.py:378-415): ``traj_fn(generator, params=None, y=None,
    x_init=None, noise_stream=None) -> (T // stride, n, 1, 28, 28)`` in [0, 1]."""
    traj = make_trajectory_sampler(model, schedule, (n_samples, latent_dim), stride=stride,
                                   conditional=True, dtype=dtype, prediction=prediction,
                                   compute_dtype=compute_dtype)

    def traj_fn(generator=None, params=None, y=None, x_init=None, noise_stream=None):
        frames = traj(generator, params=params, y=y, x_init=x_init, noise_stream=noise_stream)
        with torch.no_grad():
            decoded = vae.decode(frames.reshape(-1, latent_dim).float())
        return decoded.reshape(len(frames), n_samples, 1, 28, 28)

    return traj_fn


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's learning rate: in place where it is a device tensor
    (a captured step reads it there at each replay), else as a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def run(config: LatentDiffusionConfig) -> dict:
    """Train, validate, checkpoint and sample as the config says. Returns
    ``losses`` (the logged ones), ``val_losses`` (per epoch),
    ``samples_per_sec`` (the last epoch's), ``epochs`` (per epoch: the mean
    ``train_loss``, ``lr``, ``samples_per_sec``, ``train_seconds``,
    ``val_seconds``, ``sample_seconds``), ``resident``, ``graph`` (the
    resident step's counts), ``qsample_launches`` (the kernel's launches in
    the ``train`` steps and the ``eval`` passes; 0 on the CPU),
    ``digit7_seconds`` and the final ``state``. A rank left idle by the data
    axis's gcd rule returns ``{"idle": True}``; rank 0 alone samples, logs
    and writes."""
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

    vae, latent_dim = load_vae(config, device)
    with torch.random.fork_rng(devices=[]):  # seeded init, global RNG untouched
        torch.manual_seed(config.seed)
        model = build_denoiser(config, latent_dim)
    model = model.to(device)
    schedule = DiffusionSchedule.make(config.noise_schedule, config.num_timesteps).to(device)
    images_u8, labels = load_mnist_u8(config.data_root, train=True)
    xt, yt, xv, yv = train_val_split(images_u8, labels, config.val_frac, seed=config.split_seed)
    resident = resolve_data_placement(config.data_placement, xt.nbytes + yt.nbytes, "latent",
                                      config.batch_size, 1 if dp is None else dp.size)
    capturable = resident and device.type == "cuda"
    dit = config.backbone == "dit"
    steps_per_epoch = steps_per_epoch_from_split(len(xt), config.batch_size,
                                                 config.max_steps_per_epoch)
    lr_schedule = cosine_decay(DIT_LR, config.num_epochs) if dit else None
    lr = DIT_LR if dit else config.lr
    # A captured step needs Adam's step count, and a learning rate that
    # changes under the graph, on the device.
    optimizer = torch.optim.Adam(
        model.parameters(), capturable=capturable,
        lr=torch.tensor(lr, device=device) if capturable and dit else lr)
    use_ema = config.ema_decay > 0
    state = create_train_state(model, optimizer, config.seed, ema=use_ema)
    step_options = dict(ema_decay=config.ema_decay if use_ema else None,
                        prediction=config.prediction, compute_dtype=dtype, dp=dp)
    eval_step = make_latent_eval_step(vae, schedule, prediction=config.prediction,
                                      compute_dtype=dtype, dp=dp)
    if resident:
        train_data = DeviceDataset(xt, config.batch_size, seed=config.seed, device=device,
                                   labels=yt)
        val_data = DeviceDataset(xv, config.batch_size, seed=config.seed, device=device,
                                 labels=yv, shuffle=False)
        train_chunk = make_resident_latent_multi_step(vae, schedule, train_data,
                                                      **step_options)
        resident_eval = make_resident_eval(eval_step, val_data, config.seed + 11,
                                           VAL_FOLD_STRIDE)
    else:
        u8 = (MNIST_SCALE, MNIST_SHIFT)
        train_it = BatchIterator([xt, yt], config.batch_size, shuffle=True, seed=config.seed,
                                 u8_normalize=u8)
        val_it = BatchIterator([xv, yv], config.batch_size, shuffle=False, u8_normalize=u8)
        train_step = make_latent_train_step(vae, schedule, **step_options)
    sampler = make_latent_sampler(vae, model, schedule, config.n_samples, latent_dim,
                                  dtype=sample_dtype, prediction=config.prediction,
                                  compute_dtype=dtype)
    sample_gen = torch.Generator(device).manual_seed(config.seed + 2)

    project = ("dit-latent-diffusion-mnist" if dit
               else "conditional-latent-diffusion-mnist")
    logger = MetricsLogger(project, config.out_dir, dataclasses.asdict(config), enabled=main)
    keeper = BestKeeper(config.model_save_path, enabled=main)
    throughput = Throughput()
    result = {"losses": [], "val_losses": [], "samples_per_sec": 0.0, "epochs": [],
              "resident": resident, "qsample_launches": {"train": 0, "eval": 0}}
    launches = result["qsample_launches"]
    for epoch in range(config.num_epochs):
        if dit:  # JAX's schedule(step // steps_per_epoch), at the epoch's first step
            set_lr(optimizer, lr_schedule(state.step // steps_per_epoch))
        epoch_lr = float(optimizer.param_groups[0]["lr"])
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

        val_t0 = time.perf_counter()
        before = qsample.qsample_launches
        if resident:
            vidxs = val_data.epoch_index_batches(0)
            if config.max_steps_per_epoch:
                vidxs = vidxs[: config.max_steps_per_epoch]
            val_losses = resident_eval(model, epoch, shard(dp, vidxs, dim=1))
        else:
            val_losses = []
            for batch_idx, batch in enumerate(val_it.epoch()):
                if config.max_steps_per_epoch and batch_idx >= config.max_steps_per_epoch:
                    break
                x0, y = val_it.to_device([shard(dp, a) for a in batch], device)
                key = (config.seed + 11, epoch * VAL_FOLD_STRIDE + batch_idx)
                val_losses.append(eval_step(model, x0.permute(0, 3, 1, 2), key,
                                            y.long()).view(1))
            val_losses = torch.cat(val_losses) if val_losses else torch.zeros(0)
        launches["eval"] += qsample.qsample_launches - before
        avg_val_loss = (val_losses.double().mean().item() if len(val_losses)
                        else avg_train_loss)
        val_seconds = time.perf_counter() - val_t0
        result["val_losses"].append(avg_val_loss)
        logger.log({"epoch": epoch, "train_loss": avg_train_loss, "val_loss": avg_val_loss,
                    "train_samples_per_sec": sps, "lr": epoch_lr}, step=state.step)
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
            # (x + 1) / 2 on the decoder's [0, 1]: the reference's quirk, kept.
            save_image_grid(to_nhwc01(samples), grid, nrow=4, labels=y_sample.tolist())
            logger.log_image("samples", grid, state.step)
        result["epochs"].append({"train_loss": avg_train_loss, "lr": epoch_lr,
                                 "samples_per_sec": sps, "train_seconds": train_seconds,
                                 "val_seconds": val_seconds, "sample_seconds": sample_seconds})

    if config.visualize_denoising and main:
        traj_fn = make_latent_trajectory_sampler(
            vae, model, schedule, 4, latent_dim, config.denoising_stride, dtype=sample_dtype,
            prediction=config.prediction, compute_dtype=dtype)
        y_traj = torch.randint(0, config.num_classes, (4,), generator=sample_gen, device=device)
        trajectory = traj_fn(sample_gen, params=state.ema_params, y=y_traj)
        for i, frame in enumerate(trajectory):
            t_label = config.num_timesteps - i * config.denoising_stride
            save_image_grid(to_nhwc01(frame), f"{config.out_dir}/denoising_t{t_label}.png",
                            nrow=2)

    # The digit-7 grid (latent_diffusion.py:450-456).
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

    result["graph"] = dict(train_chunk.counts) if resident else None
    result["state"] = state
    logger.finish()
    return result


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_config_flags(parser, LatentDiffusionConfig())
    config = config_from_args(LatentDiffusionConfig, parser.parse_args(argv))
    maybe_initialize_distributed(config.device)
    device = resolve_device(config.device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    run(config)


if __name__ == "__main__":
    main()
