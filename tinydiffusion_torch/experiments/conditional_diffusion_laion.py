"""Text-conditional latent diffusion on LAION-style data: train, validate,
keep the best checkpoint, sample the fixed prompts.

Counterpart of ``tinydiffusion_tpu/experiments/conditional_diffusion_laion.py``
(``LaionDiffusionConfig``, ``SAMPLE_PROMPTS``, ``cosine_annealing_lr``,
``_window_contains_multiple``, ``make_laion_sampler``, ``run``, ``main``; its
steps are ``train/trainer.py``'s ``make_laion_train_step``,
``make_resident_laion_multi_step`` and ``make_laion_eval_step``). Reference
recipe (conditional_diffusion_laion.py:360-667): 256² images encoded to
4x32x32 latents by a frozen codec and captions embedded to 768-d vectors by
a frozen text encoder; the ``LatentUNet`` (``time_dim`` 768) trained on eps
at batch 8 in bfloat16, Adam 1e-4 with torch's ``CosineAnnealingLR`` to 1e-6
stepped per batch with ``T_max = num_epochs`` (and not clamped past it: the
rate oscillates with period ``2 T_max``), gradients clipped to norm 10; an
80/20 split (seed 42); the batch loss every ``log_every`` batches, a
1000-step sample of the four ``SAMPLE_PROMPTS`` every
``sample_every_batches`` batches and per epoch; a per-epoch val pass and the
best-val checkpoint, whose sidecar keeps the patch codec's basis.

The seams (``resolve_seams``): the latent codec is the patch codec
(``compat/latent_codec.py``; ``"auto"`` offline), calibrated on the first 64
images or restored from an existing checkpoint's sidecar, or the SD-VAE
(``"sd"``, ``compat/sdvae.py``, through diffusers' ``from_pretrained``); the
text encoder is the hash encoder (``compat/text_encoder.py``; ``"auto"``
without a ``clip_local_dir``) or CLIP-L (``"clip"``, ``compat/clip.py``:
from ``clip_local_dir``'s ``clip_text.pth``, ``vocab.json`` and
``merges.txt`` with no network, else ``from_pretrained``), run on the run's
device. The records are synthetic (``data/laion.py``): ``offline=False``
raises, as the online loader (HF ``datasets``, HTTP fetches, JPEG decoding)
is not ported.

Run on the card (the default) or, when asked, on the CPU::

    python -m tinydiffusion_torch.experiments.conditional_diffusion_laion \\
        --num-epochs 2 --n-records 40 --max-steps-per-epoch 3 --log-every 1 \\
        --out-dir /tmp/l --model-save-path /tmp/l/ckpt [--device cpu]

By default, as in JAX, the train split (uint8 images and their text
embeddings) sits on the device and each chunk of ``max(steps_per_dispatch,
log_every)`` steps runs as replays of one captured CUDA graph (eagerly on
the CPU): the gather, the codec's encode, the CUDA q_sample kernel at
(B, 4096), the UNet, the clip, the learning rate (computed on the device
from Adam's step count) and the update. The val split sits there too.
``data_placement="host"`` streams batches one step at a time.

Stated deviations from the JAX run (torch cannot draw JAX's bits): the
UNet's init is torch's default from ``torch.manual_seed(seed)``; the step's
draws come from the state's generator on the model's device (the SD codec's
Gaussian, t, the q_sample seed, the caption dropout); the val pass's from
``np.random.default_rng([seed + 3, epoch * 10000 + i])`` (JAX:
``fold_in(PRNGKey(seed + 3), epoch * 10000 + i)``); the sampling chains from
a generator seeded with ``seed + 2``. The images are synthesized, never read
back from a JPEG cache, so ``image_cache_dir`` and ``failed_urls_cache`` are
not used (``data/laion.py``); the host path steps one batch at a time, so
``steps_per_dispatch`` sets only the resident chunk.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from tinydiffusion_torch.compat.latent_codec import get_latent_codec
from tinydiffusion_torch.compat.text_encoder import get_text_encoder
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data.laion import load_laion_dataset, precache_records
from tinydiffusion_torch.data.loader import BatchIterator
from tinydiffusion_torch.device import disable_tf32, resolve_device
from tinydiffusion_torch.experiments.common import (
    add_config_flags,
    config_from_args,
    make_sampler,
    resolve_data_placement,
    resolve_dtype,
    with_eager,
)
from tinydiffusion_torch.io.checkpoint import (
    BestKeeper,
    checkpoint_exists,
    load_sidecar,
    restore_checkpoint,
)
from tinydiffusion_torch.models.unet_latent import LatentUNet
from tinydiffusion_torch.obs.images import save_image_grid
from tinydiffusion_torch.obs.metrics import MetricsLogger
from tinydiffusion_torch.parallel.distributed import maybe_initialize_distributed
from tinydiffusion_torch.parallel.mesh import is_main, make_mesh_for_batch, shard
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.train.trainer import (
    create_train_state,
    make_laion_eval_step,
    make_laion_train_step,
    make_resident_eval,
    make_resident_laion_multi_step,
)

SAMPLE_PROMPTS = [
    "a photo of a cat",
    "a photo of a dog",
    "a photo of a horse",
    "a photo of a cow",
]
# ToTensor + Normalize(0.5, 0.5): uint8 to [-1, 1].
LAION_U8_NORMALIZE = (2.0 / 255.0, -1.0)
# The val pass's key: (seed + 3, epoch * VAL_FOLD_STRIDE + batch), JAX's fold_in cadence.
VAL_FOLD_STRIDE = 10000


@dataclasses.dataclass
class LaionDiffusionConfig:
    """The JAX ``LaionDiffusionConfig``'s fields and defaults (all but one,
    below), plus ``device``.

    - ``model_save_path`` defaults under ``runs/``, not to the JAX default
      ``checkpoints/laion_diffusion_best``: the port's files would land
      beside the committed sidecars there.
    - ``offline`` must stay True (the online loader is not ported);
      ``image_cache_dir`` and ``failed_urls_cache`` are kept for the flags
      and not used.
    - ``use_mesh``: data parallelism over the processes of the group that
      ``main`` joins (``parallel/``; ``batch_size`` is the global batch), as
      in ``experiments.diffusion``; rank 0 alone samples, logs and writes.
    - On a card ``run`` turns TF32 off for the process.
    """

    num_epochs: int = 1000
    batch_size: int = 8
    lr: float = 1e-4
    lr_min: float = 1e-6
    clip_norm: float = 10.0
    num_timesteps: int = 1000
    time_dim: int = 768
    image_size: int = 256
    latent_size: int = 32
    latent_channels: int = 4
    n_records: int = 10_000
    seed: int = 0
    split_seed: int = 42
    out_dir: str = "runs/conditional_diffusion_laion"
    image_cache_dir: str = "data/laion"
    failed_urls_cache: str = "data/failed_urls.json"
    model_save_path: str = "runs/conditional_diffusion_laion/laion_diffusion_best"
    text_encoder: str = "auto"
    clip_local_dir: str = ""
    latent_codec: str = "auto"
    compute_dtype: str = "bfloat16"
    sample_dtype: str = "float32"
    use_mesh: bool = True
    log_every: int = 10
    sample_every_batches: int = 100
    sample_every_epoch: bool = True
    sample_every_epochs: int = 1
    offline: bool = True
    max_steps_per_epoch: int = 0
    scheduler_t_max: int = 0
    steps_per_dispatch: int = 1
    ema_decay: float = 0.0
    caption_dropout: float = 0.0
    guidance_scale: float = 1.0
    data_placement: str = "auto"
    device: str = "cuda"


def cosine_annealing_lr(lr: float, lr_min: float, t_max: int):
    """torch's ``CosineAnnealingLR`` at integer step ``count``:
    ``lr_min + (lr - lr_min) (1 + cos(pi count / T_max)) / 2``, not clamped
    past ``T_max`` (the reference steps it per batch, so its 1000-epoch
    recipe crosses ``T_max`` inside epoch 2 and oscillates after). The
    schedule maps a float32 tensor ``count`` to a float32 tensor on its
    device, in JAX's float32 operations, so a captured step computes it on
    the card."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        cos_term = 0.5 * (1.0 + torch.cos(math.pi * count / t_max))
        return lr_min + (lr - lr_min) * cos_term

    return schedule


def _window_contains_multiple(lo: int, hi: int, every: int, positive_only: bool = False) -> bool:
    """Whether the batch-index window [lo, hi] holds a multiple of ``every``
    (a positive one with ``positive_only``): the chunked form of the
    reference's per-batch ``batch_idx % every == 0`` gates."""
    if every <= 0:
        return False
    if positive_only:
        lo = max(lo, 1)
        if hi < 1:
            return False
    return hi // every > (lo - 1) // every


def config_from_sidecar(cfg: dict) -> LaionDiffusionConfig:
    """The config a sidecar's ``config`` records (fields this config does not
    have are left out; missing ones take the defaults)."""
    known = {f.name for f in dataclasses.fields(LaionDiffusionConfig)}
    return LaionDiffusionConfig(**{k: v for k, v in cfg.items() if k in known})


def resolve_seams(config: LaionDiffusionConfig) -> tuple[str, str]:
    """``(codec name, text encoder name)`` with ``"auto"`` resolved the
    offline way (JAX's ``run`` and ``generate_laion``): the patch codec, and
    the hash encoder unless a ``clip_local_dir`` asks for CLIP."""
    codec, encoder = config.latent_codec, config.text_encoder
    if config.offline:
        codec = "patch" if codec == "auto" else codec
        if encoder == "auto":
            encoder = "clip" if config.clip_local_dir else "hash"
    return codec, encoder


def make_laion_sampler(model: torch.nn.Module, schedule: DiffusionSchedule, codec,
                       n_samples: int, latent_size: int, latent_channels: int,
                       dtype: torch.dtype = torch.float32,
                       compute_dtype: torch.dtype = torch.float32,
                       guidance_scale: float = 1.0, null_embed: torch.Tensor | None = None,
                       method: str = "ddpm", sample_steps: int = 50, eta: float = 0.0):
    """The LAION sampler (conditional_diffusion_laion.py:560-599):
    ``sample_fn(generator, text_embeds, params=None, x_init=None,
    noise_stream=None) -> (n, 3, S, S)`` images in [0, 1], on the schedule's
    device.

    The chain over (n, latent_channels, latent_size, latent_size) latents is
    ``make_sampler``'s: ``method`` ``"ddpm"`` (T steps) or ``"ddim"``
    (``sample_steps``, ``eta``), in ``dtype``, the UNet in ``compute_dtype``
    with the (n, D) ``text_embeds`` as its context. ``guidance_scale`` != 1
    (a model trained with caption dropout; ``null_embed`` is the empty-string
    embedding) takes the text and the null predictions from one forward at
    doubled batch: ``eps_n + s (eps_t - eps_n)``. Then the codec's decode in
    float32, ``clip(x / 2 + 0.5, 0, 1)`` and non-finite pixels set to 0: on
    a card one graph of its own after the chain's (``sample_fn.eager`` and
    ``sample_fn.counts`` as ``make_sampler``'s). ``params`` replaces the
    model's parameters (an EMA shadow); ``x_init`` and ``noise_stream``
    replace the chain's draws (``core.sampler``), the seam through which the
    tests replay JAX's."""
    if method not in ("ddpm", "ddim"):
        raise ValueError(f"unknown sampler method {method!r}; use 'ddpm' or 'ddim'")
    if guidance_scale != 1.0 and null_embed is None:
        raise ValueError("guidance_scale != 1 needs null_embed (a model trained with "
                         "caption_dropout; the empty-string embedding)")

    def decode(latents):
        images = torch.clamp(codec.decode(latents.float()) / 2 + 0.5, 0.0, 1.0)
        return torch.where(torch.isfinite(images), images, torch.zeros_like(images))

    sampler = make_sampler(model, schedule, (n_samples, latent_channels, latent_size, latent_size),
                           conditional=True, dtype=dtype, method=method,
                           sample_steps=sample_steps, eta=eta, guidance_scale=guidance_scale,
                           null_label=null_embed, compute_dtype=compute_dtype, decode=decode,
                           decode_reads=codec)

    def sample(eager, generator, text_embeds: torch.Tensor, params=None, x_init=None,
               noise_stream=None) -> torch.Tensor:
        run = sampler.eager if eager else sampler
        return run(generator, params=params, y=text_embeds, x_init=x_init,
                   noise_stream=noise_stream)

    return with_eager(sample, sampler.counts)


def to_nhwc(images: torch.Tensor) -> np.ndarray:
    """(n, 3, S, S) images in [0, 1] -> NHWC numpy, for the grids."""
    return images.permute(0, 2, 3, 1).float().cpu().numpy()


def _restore_codec(config: LaionDiffusionConfig, codec, images: np.ndarray) -> None:
    """The patch codec's basis: an existing checkpoint's (its sidecar's
    ``codec_state``), so that a resumed denoiser keeps the latent basis it
    was trained in; else calibrated on the first 64 images. A codec without
    ``calibrate`` (the SD-VAE, whose scaling factor ships with its weights)
    is left as it is."""
    if not hasattr(codec, "calibrate"):
        return
    codec_state = None
    if checkpoint_exists(config.model_save_path):
        try:
            codec_state = load_sidecar(config.model_save_path).get("metadata", {}).get(
                "codec_state")
        except (OSError, ValueError) as e:
            print(f"Could not read codec state from sidecar: {e}")
    if codec_state is not None:
        codec.load_state_dict(codec_state)
        print(f"restored calibrated codec basis from {config.model_save_path} "
              f"(scaling factor {codec.scaling_factor:.4f})")
        return
    sample = images[: min(64, len(images))].astype(np.float32) * (2 / 255) - 1
    sf = codec.calibrate(torch.from_numpy(sample).permute(0, 3, 1, 2))
    print(f"calibrated latent scaling factor: {sf:.4f}")


def run(config: LaionDiffusionConfig) -> dict:
    """Train, validate, checkpoint and sample as the config says. Returns
    ``losses`` (the logged ones), ``val_losses`` (per epoch),
    ``samples_per_sec`` (the last epoch's), ``epochs`` (per epoch: the mean
    ``train_loss``, ``lr`` (the rate of its last update), ``steps``,
    ``samples_per_sec`` and ``train_seconds`` (the steps alone, synchronized),
    ``val_seconds``, ``sample_seconds`` (its grids)), ``grids`` (the paths
    written), ``resident``, ``graph`` (the resident step's counts),
    ``qsample_launches`` (the kernel's launches in the ``train`` steps and
    the ``eval`` passes; 0 on the CPU), ``data_seconds`` (synthesizing and
    embedding the records), ``final_seconds`` (the final grid), ``codec`` and
    the final ``state``. A rank left idle by the data axis's gcd rule
    returns ``{"idle": True}``."""
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

    codec_name, encoder_name = resolve_seams(config)
    codec = get_latent_codec(codec_name, config.image_size)
    text_encoder = get_text_encoder(encoder_name, config.time_dim, config.clip_local_dir,
                                    device=device)

    # Data: the valid subset and the 80/20 split (conditional_diffusion_laion.py:403-433).
    # offline=False raises here: the online loader is not ported.
    data_t0 = time.perf_counter()
    images, texts = precache_records(load_laion_dataset(config.n_records, config.offline),
                                     config.image_size)
    if not len(images):
        raise RuntimeError("No valid samples after pre-caching!")
    print(f"Using {len(images)} valid samples for training.")
    embeds = text_encoder.encode(texts).astype(np.float32)
    data_seconds = time.perf_counter() - data_t0
    _restore_codec(config, codec, images)
    codec.to(device)
    perm = np.random.default_rng(config.split_seed).permutation(len(images))
    n_val = len(images) // 5
    val_idx, train_idx = perm[:n_val], perm[n_val:]

    schedule = DiffusionSchedule.linear(config.num_timesteps).to(device)
    with torch.random.fork_rng(devices=[]):  # seeded init, global RNG untouched
        torch.manual_seed(config.seed)
        model = LatentUNet(time_dim=config.time_dim, in_channels=config.latent_channels)
    model = model.to(device)
    resident = resolve_data_placement(
        config.data_placement, images[train_idx].nbytes + embeds[train_idx].nbytes, "laion",
        config.batch_size, 1 if dp is None else dp.size)
    # The rate is a tensor that the step writes from Adam's step count; on a
    # card Adam keeps that count on the device (capturable) on either path.
    optimizer = torch.optim.Adam(model.parameters(), lr=torch.tensor(config.lr, device=device),
                                 capturable=device.type == "cuda")
    lr_schedule = cosine_annealing_lr(config.lr, config.lr_min,
                                      max(config.scheduler_t_max or config.num_epochs, 1))
    use_ema = config.ema_decay > 0
    state = create_train_state(model, optimizer, config.seed, ema=use_ema)
    # CFG: the null condition is the encoder's empty-string embedding.
    use_cfg = config.caption_dropout > 0 or config.guidance_scale != 1.0
    null_embed = (torch.from_numpy(text_encoder.encode([""])[0]).to(device) if use_cfg
                  else None)
    if checkpoint_exists(config.model_save_path):  # conditional_diffusion_laion.py:376-383
        try:
            restore_checkpoint(config.model_save_path, state)
            print(f"Loaded model weights from {config.model_save_path}")
        except (OSError, RuntimeError, KeyError, ValueError) as e:
            print(f"Error loading model from {config.model_save_path}: {e}; "
                  "starting from scratch")

    step_options = dict(lr_schedule=lr_schedule, clip_norm=config.clip_norm,
                        ema_decay=config.ema_decay if use_ema else None, compute_dtype=dtype,
                        caption_dropout=config.caption_dropout, null_embed=null_embed, dp=dp)
    eval_step = make_laion_eval_step(codec, schedule, dtype, dp=dp)
    if resident:
        common = dict(batch_size=config.batch_size, seed=config.seed, device=device,
                      u8_normalize=LAION_U8_NORMALIZE)
        train_data = DeviceDataset(images[train_idx], embeds=embeds[train_idx], **common)
        val_data = DeviceDataset(images[val_idx], embeds=embeds[val_idx], shuffle=False, **common)
        train_chunk = make_resident_laion_multi_step(codec, schedule, train_data, **step_options)
        resident_eval = make_resident_eval(eval_step, val_data, config.seed + 3, VAL_FOLD_STRIDE)
    else:
        train_it = BatchIterator([images[train_idx], embeds[train_idx]], config.batch_size,
                                 shuffle=True, seed=config.seed, u8_normalize=LAION_U8_NORMALIZE)
        val_it = BatchIterator([images[val_idx], embeds[val_idx]], config.batch_size,
                               shuffle=False, u8_normalize=LAION_U8_NORMALIZE)
        train_step = make_laion_train_step(codec, schedule, **step_options)
    sampler = make_laion_sampler(model, schedule, codec, len(SAMPLE_PROMPTS), config.latent_size,
                                 config.latent_channels, dtype=sample_dtype, compute_dtype=dtype,
                                 guidance_scale=config.guidance_scale, null_embed=null_embed)
    sample_embeds = torch.from_numpy(text_encoder.encode(SAMPLE_PROMPTS)).to(device)
    sample_gen = torch.Generator(device).manual_seed(config.seed + 2)

    logger = MetricsLogger("laion-diffusion-model", config.out_dir, dataclasses.asdict(config),
                           enabled=main)
    keeper = BestKeeper(config.model_save_path, enabled=main)
    result = {"losses": [], "val_losses": [], "samples_per_sec": 0.0, "epochs": [],
              "grids": [], "resident": resident, "qsample_launches": {"train": 0, "eval": 0},
              "data_seconds": data_seconds}
    launches = result["qsample_launches"]

    def grid(path: str, labels=None) -> float:
        """Sample the prompts (the EMA shadow when kept) into ``path``; its
        seconds (rank 0's work: 0 elsewhere)."""
        if not main:
            return 0.0
        synchronize()
        t0 = time.perf_counter()
        imgs = sampler(sample_gen, sample_embeds, params=state.ema_params)
        save_image_grid(to_nhwc(imgs), path, nrow=2, normalize=False, labels=labels)
        result["grids"].append(path)
        return time.perf_counter() - t0

    def log_batch(epoch: int, batch: int, loss_val: float) -> None:
        logger.log({"epoch": epoch, "batch": batch, "batch_train_loss": loss_val},
                   step=state.step)
        result["losses"].append(loss_val)

    for epoch in range(config.num_epochs):
        epoch_t0 = time.perf_counter()
        sample_seconds = 0.0
        before = qsample.qsample_launches
        losses = []  # device tensors, read once at the epoch's end
        if resident:
            idxs = train_data.epoch_index_batches(epoch)
            if config.max_steps_per_epoch:
                idxs = idxs[: config.max_steps_per_epoch]
            g = max(config.steps_per_dispatch, config.log_every, 1)
            for start in range(0, len(idxs), g):
                chunk_losses = train_chunk(state, shard(dp, idxs[start : start + g], dim=1))
                losses.append(chunk_losses)
                end = start + len(chunk_losses) - 1
                host = chunk_losses.tolist()  # syncs, once a chunk
                for j, loss_val in enumerate(host):
                    if (start + j) % config.log_every == 0:
                        log_batch(epoch, start + j, loss_val)
                # Mid-epoch grids fire at the chunk's end past each multiple
                # (conditional_diffusion_laion.py:479-496, JAX's cadence).
                if _window_contains_multiple(start, end, config.sample_every_batches,
                                             positive_only=True):
                    sample_seconds += grid(f"{config.out_dir}/sampled_epoch{epoch}_batch{end}.png")
            steps = len(idxs)
        else:
            steps = 0
            for batch_idx, batch in enumerate(train_it.epoch(epoch)):
                if config.max_steps_per_epoch and batch_idx >= config.max_steps_per_epoch:
                    break
                x, emb = train_it.to_device([shard(dp, a) for a in batch], device)
                loss = train_step(state, x.permute(0, 3, 1, 2), emb)
                losses.append(loss.view(1))
                steps += 1
                if batch_idx % config.log_every == 0:
                    log_batch(epoch, batch_idx, float(loss))  # syncs, at log points only
                if _window_contains_multiple(batch_idx, batch_idx, config.sample_every_batches,
                                             positive_only=True):
                    sample_seconds += grid(
                        f"{config.out_dir}/sampled_epoch{epoch}_batch{batch_idx}.png")
        avg_train_loss = torch.cat(losses).double().mean().item() if losses else 0.0  # syncs
        train_seconds = time.perf_counter() - epoch_t0 - sample_seconds
        sps = steps * config.batch_size / train_seconds if train_seconds > 0 else 0.0
        result["samples_per_sec"] = sps
        launches["train"] += qsample.qsample_launches - before
        epoch_lr = float(optimizer.param_groups[0]["lr"])

        val_t0 = time.perf_counter()
        before = qsample.qsample_launches
        if resident:
            vidxs = val_data.epoch_index_batches(0)
            if config.max_steps_per_epoch:
                vidxs = vidxs[: config.max_steps_per_epoch]
            val_losses = resident_eval(model, epoch, shard(dp, vidxs, dim=1))
        else:
            val_losses = []
            for i, batch in enumerate(val_it.epoch()):
                if config.max_steps_per_epoch and i >= config.max_steps_per_epoch:
                    break
                x, emb = val_it.to_device([shard(dp, a) for a in batch], device)
                key = (config.seed + 3, epoch * VAL_FOLD_STRIDE + i)
                val_losses.append(eval_step(model, x.permute(0, 3, 1, 2), key, emb).view(1))
            val_losses = torch.cat(val_losses) if val_losses else torch.zeros(0)
        launches["eval"] += qsample.qsample_launches - before
        # Tiny configs can leave the val split without a full batch: the
        # train loss stands in, as in JAX.
        avg_val_loss = (val_losses.double().mean().item() if len(val_losses)
                        else avg_train_loss)
        val_seconds = time.perf_counter() - val_t0
        result["val_losses"].append(avg_val_loss)
        logger.log({"epoch": epoch, "epoch_train_loss": avg_train_loss, "val_loss": avg_val_loss,
                    "train_samples_per_sec": sps, "lr": epoch_lr}, step=state.step)
        # The patch codec's basis goes with the checkpoint; the SD-VAE has none.
        codec_meta = {"codec_state": codec.state_dict()} if hasattr(codec, "state_dict") else {}
        if keeper.update(avg_val_loss, state, config=dataclasses.asdict(config), epoch=epoch,
                         **codec_meta) and main:
            print(f"Saved best model at epoch {epoch} with val loss: {avg_val_loss:.4f}")

        if config.sample_every_epoch and (epoch + 1) % max(1, config.sample_every_epochs) == 0:
            path = f"{config.out_dir}/samples_epoch_{epoch}.png"
            sample_seconds += grid(path, labels=SAMPLE_PROMPTS)
            logger.log_image("samples", path, state.step)
        result["epochs"].append({"train_loss": avg_train_loss, "lr": epoch_lr, "steps": steps,
                                 "samples_per_sec": sps, "train_seconds": train_seconds,
                                 "val_seconds": val_seconds, "sample_seconds": sample_seconds})

    # The final grid, whatever the per-epoch flag says.
    path = f"{config.out_dir}/final_samples.png"
    result["final_seconds"] = grid(path, labels=SAMPLE_PROMPTS)
    logger.log_image("final_samples", path, state.step)
    result["graph"] = dict(train_chunk.counts) if resident else None
    result["codec"] = codec
    result["state"] = state
    logger.finish()
    return result


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_config_flags(parser, LaionDiffusionConfig())
    config = config_from_args(LaionDiffusionConfig, parser.parse_args(argv))
    maybe_initialize_distributed(config.device)
    device = resolve_device(config.device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    run(config)


if __name__ == "__main__":
    main()
