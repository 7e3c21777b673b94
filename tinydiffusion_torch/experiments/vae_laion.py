"""The LAION conv beta-VAE: train it, and serve it (reconstruct, decode prior samples).

Counterpart of ``tinydiffusion_tpu/experiments/vae_laion.py`` and of the
conv-VAE rows of ``tools/fid_eval_laion.py``. Reference recipe: 256x256
images, batch 4, ``clip_by_global_norm(10)`` then Adam 1e-4, float32
compute, ``BCE(sum) + 0.1 * perceptual MSE(sum) + beta * KLD``; all-zero
batches skipped; a held-out 10 % split evaluated each epoch with an
original-vs-reconstructed panel and the best checkpoint kept on its loss;
16 prior samples at the end. Every flash-attention site of the train step
runs the CUDA forward and backward kernels on a card
(``ops.attention._FlashT``), their bfloat16 instantiations with
``--compute-dtype bfloat16``.

Data placement, JAX's rule (``experiments.common.resolve_data_placement``):
``"auto"`` (the default) keeps the uint8 train set on the device whenever it
fits (10 000 images at 256² are 1.97 GB), with all-zero images (failed
downloads) excluded once, when it is pinned; each step gathers its batch
there and, on a card, is a replay of one captured CUDA graph
(``make_conv_vae_resident_step``, JAX's ``make_conv_vae_resident_step``);
the val split is resident too when it holds no all-zero image. ``"host"``
streams uint8 batches from the host and skips all-zero batches.

Run on the card (the default) or, when asked, on the CPU::

    python -m tinydiffusion_torch.experiments.vae_laion --epochs 2 \\
        --max-steps-per-epoch 3 --n-records 40 --image-size 128 \\
        --out-dir /tmp/v --checkpoint-dir /tmp/v/ckpt [--device cpu]

The flags are the JAX CLI's, plus ``--device``. Serving::

    model = load_conv_vae("checkpoints/vae_laion_best")
    recon = reconstruct(model, x01, eps)  # x01 (B, 3, 256, 256) in [0, 1]
    samples = sample_prior(model, 16, torch.Generator("cuda").manual_seed(0))

Precision: the model is served and, by default, trained in float32, so on
a card ``run`` and ``load_conv_vae`` turn TF32 off for cuDNN convolutions
and for matmuls (process-wide backend flags): PyTorch lets cuDNN convolve
float32 in TF32 by default, which keeps only ~3 decimal digits.

Stated deviations from the JAX run (torch cannot draw JAX's bits):

- the perceptual net's seeded init draws flax's distribution from a torch
  generator, so its weights differ from JAX's ``PRNGKey(123)`` ones;
- the reparameterisation noise comes from a ``torch.Generator`` on the
  model's device (``ConvVAETrainState.generator``), each val batch's from a
  host generator seeded with ``(seed + 5, epoch * 1000 + i)``
  (``train.trainer.keyed_normal``; JAX: ``fold_in(PRNGKey(seed + 5),
  epoch * 1000 + i)``), the final samples' latents from one seeded with
  ``seed + 2``;
- the model's init is torch's default (JAX: flax init from ``PRNGKey(seed)``).

Value parity with JAX goes through the seams instead: the step's ``eps``,
the weight bridge (``io.from_jax``) and ``perceptual_state_dict``. The port
has no JPEG cache: its images are the synthetic bytes, which equal what the
JAX loader returns on a cold cache (on a warm one it returns the JPEG-95
copy); JAX's ``run`` here reads each record once, so it trains on those bytes.

Under ``torchrun --nproc_per_node N`` the run is data-parallel over N
processes (``parallel/``; ``--batch-size`` is the global batch, and the
reference's batch 4 spreads over up to 4 ranks by the gcd rule): the summed
loss and its gradients are summed over the ranks before the clip, and rank 0
alone logs and writes.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch

from tinydiffusion_torch.compat.vgg import load_vgg16_perceptual
from tinydiffusion_torch.core.graphs import GraphedCall
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data.laion import synthesize_image
from tinydiffusion_torch.data.loader import BatchIterator
from tinydiffusion_torch.device import disable_tf32, resolve_device
from tinydiffusion_torch.experiments.common import (
    add_config_flags,
    config_from_args,
    resolve_data_placement,
)
from tinydiffusion_torch.io.checkpoint import (
    BestKeeper,
    checkpoint_exists,
    load_sidecar,
    load_weights_arrays,
    restore_checkpoint,
)
from tinydiffusion_torch.io.from_jax import conv_vae_jax_variables, conv_vae_state_dict
from tinydiffusion_torch.models.vae_conv import (
    ConvVAE,
    ConvVAEConfig,
    PerceptualNet,
    conv_vae_loss,
    reparameterize,
)
from tinydiffusion_torch.obs.images import save_image_grid
from tinydiffusion_torch.obs.metrics import LossAccumulator, MetricsLogger
from tinydiffusion_torch.parallel.distributed import maybe_initialize_distributed
from tinydiffusion_torch.parallel.mesh import (
    DataParallel,
    global_batch,
    is_main,
    make_mesh_for_batch,
    shard,
    sync_batch_norm_,
)
from tinydiffusion_torch.train.trainer import (
    clip_by_global_norm_,
    keyed_normal,
    load_optimizer_state_,
    make_resident_eval,
    make_resident_steps,
)


@dataclasses.dataclass
class VAELaionConfig:
    """Every field of the JAX ``VAELaionConfig`` (its ``ConvVAEConfig``
    base included), with JAX's defaults but for ``checkpoint_dir``, plus
    ``device``.

    - ``checkpoint_dir`` defaults under ``runs/``: the JAX default
      ``checkpoints`` would put the port's ``vae_laion_best.npz`` over the
      committed JAX weights.
    - ``use_mesh``: data parallelism over the processes of the group that
      ``main`` joins, as in ``experiments.diffusion``.
    - ``hidden_channels``, ``image_cache_dir`` and ``failed_urls_cache``
      have no effect: the JAX model ignores the first too, and the port
      makes its images in memory, with no cache.
    - ``data_placement``: JAX's rule; ``"auto"`` and ``"device"`` keep the
      train set (and an all-nonzero val split) on the device.
    - ``compute_dtype``: ``"float32"`` or ``"bfloat16"`` (the model's and
      the perceptual net's flax ``dtype``; the params stay float32).
    - ``offline=False`` (the online LAION dataset) raises: the port has no
      network path.
    """

    latent_dim: int = 128
    hidden_channels: int = 64
    input_channels: int = 3
    image_size: int = 256
    batch_size: int = 4
    epochs: int = 100
    learning_rate: float = 1e-4
    checkpoint_dir: str = "runs/vae_laion/checkpoints"
    image_cache_dir: str = "data/laion"
    failed_urls_cache: str = "data/failed_urls.json"
    n_images_to_log: int = 8
    log_interval: int = 10
    beta: float = 1.0
    seed: int = 42
    n_records: int = 10_000
    out_dir: str = "runs/vae_laion"
    use_mesh: bool = True
    use_flash_attention: bool = True
    max_steps_per_epoch: int = 0
    offline: bool = True
    clip_norm: float = 10.0
    data_placement: str = "auto"
    perceptual: str = "seeded"
    perceptual_weights: str = ""
    compute_dtype: str = "float32"
    resume: bool = False
    device: str = "cuda"


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The val pass's noise key: (seed + 5, epoch * VAL_FOLD_STRIDE + batch), JAX's
# fold_in(PRNGKey(seed + 5), epoch * 1000 + i).
VAL_FOLD_STRIDE = 1000


def _check_config(config: VAELaionConfig) -> None:
    if config.data_placement not in ("host", "device", "auto"):
        raise ValueError(
            f"data_placement={config.data_placement!r}; choose 'host', 'device', or 'auto'")
    if config.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype={config.compute_dtype!r}; choose 'float32' or 'bfloat16'")
    if not config.offline:
        raise NotImplementedError(
            "offline=False loads the online LAION dataset, which the port does not have; "
            "use offline=True (synthetic records)")
    if config.perceptual not in ("seeded", "vgg16"):
        raise ValueError(f"perceptual={config.perceptual!r}; choose 'seeded' or 'vgg16'")


@dataclasses.dataclass
class ConvVAETrainState:
    """Everything a step reads and writes (JAX's ``ConvVAETrainState``:
    step, params + batch_stats in the model, opt_state, rng); ``state_dict``
    resumes it exactly."""

    model: ConvVAE
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # on the model's device: the z noise
    step: int = 0
    # Bumped by ``load_state_dict``: a resident step captures its graph again.
    restores: int = 0

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict``; the optimizer keeps its own
        ``capturable`` (``train.trainer.load_optimizer_state_``)."""
        self.model.load_state_dict(sd["model"])
        load_optimizer_state_(self.optimizer, sd["optimizer"])
        self.step = int(sd["step"])
        self.generator.set_state(sd["generator"])
        self.restores += 1

    def jax_weights(self) -> dict[str, np.ndarray]:
        """The JAX npz keys: ``params``, ``batch_stats`` (BN statistics and
        the spectral norms' ``u`` and ``sigma``) and ``step``."""
        flat = conv_vae_jax_variables(self.model)
        flat["step"] = np.asarray(self.step, np.int32)
        return flat


def create_train_state(model: ConvVAE, optimizer: torch.optim.Optimizer,
                       seed: int) -> ConvVAETrainState:
    device = next(model.parameters()).device
    return ConvVAETrainState(model, optimizer, torch.Generator(device).manual_seed(seed))


def make_optimizer(model: ConvVAE, learning_rate: float,
                   capturable: bool = False) -> torch.optim.Adam:
    """optax ``adam(lr)``'s defaults: betas 0.9 / 0.999, eps 1e-8. The clip
    that precedes it in the chain is in the step (``clip_by_global_norm_``).
    ``capturable=True`` keeps Adam's step count on the device, as a step
    captured in a CUDA graph needs."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def _conv_vae_step_body(perceptual: PerceptualNet, beta: float, clip_norm: float,
                        dp: DataParallel | None = None):
    """``body(state, x, eps=None) -> (loss, components)``: one step's device
    work (JAX's ``_conv_vae_raw_step``), without the host's ``state.step``
    count, so that a CUDA graph can capture it."""

    def body(state: ConvVAETrainState, x: torch.Tensor, eps: torch.Tensor | None = None):
        model = state.model
        model.train()
        sync_batch_norm_(model, dp)
        if eps is None:
            eps = torch.randn(global_batch(dp, x.shape[0]), model.latent_dim,
                              generator=state.generator, device=x.device)
        recon, mu, logvar = model(x, shard(dp, eps))
        total, components = conv_vae_loss(recon, x, mu, logvar, perceptual(recon),
                                          perceptual(x), beta)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        total = total.detach()
        components = {k: v.detach() for k, v in components.items()}
        if dp is not None:
            # Sums over the batch: the gradients, the loss and its sums are
            # summed over the ranks before the clip; the maxima maximised.
            total, *sums = dp.all_reduce_grads_(
                model.parameters(), total, *(components[k] for k in SUM_COMPONENTS), op="sum")
            maxima = dp.all_reduce_(torch.stack([components[k] for k in MAX_COMPONENTS]), "max")
            components = {**dict(zip(SUM_COMPONENTS, sums)),
                          **dict(zip(MAX_COMPONENTS, maxima.unbind()))}
        if clip_norm:
            clip_by_global_norm_(model.parameters(), clip_norm)
        state.optimizer.step()
        return total, components

    return body


def make_conv_vae_train_step(perceptual: PerceptualNet, beta: float, clip_norm: float = 10.0,
                             dp: DataParallel | None = None):
    """The train step ``step(state, x, eps=None) -> (loss, components)``
    (JAX's ``_conv_vae_raw_step`` / ``make_conv_vae_train_step``).

    ``x`` (B, C, S, S) float32 in [0, 1] on the model's device. ``state`` is
    updated in place: the model's parameters (the gradient clipped to
    ``clip_norm`` by optax's rule, 0 for none, then ``state.optimizer``), its
    BN statistics and spectral-norm vectors (in its train-mode forward) and
    the step. ``eps`` (B, latent_dim), when given, replaces the step's own
    draw from ``state.generator``: the seam the tests use to give the port
    JAX's noise. The loss and components come back as device tensors. Under
    ``dp`` (``train.trainer``'s rules) ``x`` is this rank's rows, ``eps``
    the global batch's, and the loss and components the global batch's.
    """
    body = _conv_vae_step_body(perceptual, beta, clip_norm, dp)

    def step(state: ConvVAETrainState, x: torch.Tensor, eps: torch.Tensor | None = None):
        out = body(state, x, eps)
        state.step += 1
        return out

    return step


# The loss components a step returns beside its loss: sums over the batch,
# then maxima.
SUM_COMPONENTS = ("bce", "perceptual", "kld")
MAX_COMPONENTS = ("logvar_max", "mu_absmax")
COMPONENTS = SUM_COMPONENTS + MAX_COMPONENTS


def make_conv_vae_resident_step(perceptual: PerceptualNet, beta: float, clip_norm: float,
                                dataset: DeviceDataset,
                                dp: DataParallel | None = None) -> Callable:
    """Training over the resident image set (JAX's
    ``make_conv_vae_resident_step``): ``step(state, idxs, eps=None) ->
    (losses, components)``, ``losses`` (K,) and each of ``COMPONENTS`` (K,)
    on the device, one value a step. Each step gathers its uint8 NHWC batch
    from ``dataset``, normalises it and goes to NCHW inside the step, then
    runs the train step's body; on a card each is a replay of one captured
    CUDA graph (``train.trainer.make_resident_steps``: the clip, the
    spectral norms' ``u`` and ``sigma``, the BN statistics and the z draw
    from the state's generator are inside it). On the CPU ``eps`` (K, B,
    latent_dim) may replace the draws."""
    body = _conv_vae_step_body(perceptual, beta, clip_norm, dp)

    def batch_step(state, x: torch.Tensor, eps=None):
        return body(state, x.permute(0, 3, 1, 2).contiguous(), eps)

    return make_resident_steps(dataset, batch_step, outputs=COMPONENTS)


def make_conv_vae_eval_step(perceptual: PerceptualNet, beta: float,
                            dp: DataParallel | None = None):
    """``eval_step(model, x, eps) -> (loss, recon)`` with the model in eval
    mode (running BN statistics, no spectral-norm update), as JAX's
    ``make_conv_vae_eval_step``. Under ``dp`` ``x`` and ``eps`` are this
    rank's rows and the loss is summed over the ranks."""

    @torch.no_grad()
    def eval_step(model: ConvVAE, x: torch.Tensor, eps: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            recon, mu, logvar = model(x, eps)
            total, _ = conv_vae_loss(recon, x, mu, logvar, perceptual(recon), perceptual(x),
                                     beta)
        finally:
            model.train(was_training)
        return (total if dp is None else dp.all_reduce_(total, "sum")), recon

    return eval_step


def load_images(config: VAELaionConfig) -> np.ndarray:
    """The offline record set as one (n_records, S, S, 3) uint8 array: the
    synthetic images, made in memory (what the JAX loader returns on a cold
    cache)."""
    if not config.offline:
        raise NotImplementedError("the port loads offline (synthetic) records only")
    return np.stack([synthesize_image(i, config.image_size)[0] for i in range(config.n_records)])


def split_train_val(images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(train, val)``: the first 10 % (at least one image) are held out,
    as JAX's ``run`` does (vae_laion.py:260-261)."""
    n_val = max(len(images) // 10, 1)
    return images[n_val:], images[:n_val]


def _nonzero_batches(epoch_iter):
    """The all-zero-batch skip (failed downloads, vae_laion.py:377-385),
    checked on the uint8 bytes before they go to the device."""
    for batch_idx, (x,) in enumerate(epoch_iter):
        if not x.any():
            print(f"Batch {batch_idx} contains all-zero images, skipping.")
            continue
        yield (x,)


def _perceptual_net(config: VAELaionConfig) -> PerceptualNet:
    # JAX: PRNGKey(123) (vae_laion.py:244-249), in the compute dtype.
    net = PerceptualNet(seed=123, dtype=COMPUTE_DTYPES[config.compute_dtype])
    if config.perceptual == "vgg16":
        if not config.perceptual_weights:
            raise ValueError("perceptual='vgg16' needs --perceptual-weights "
                             "(a torch-saved vgg16 state dict; see compat/vgg.py)")
        net.load_state_dict(load_vgg16_perceptual(config.perceptual_weights))
        print(f"loaded VGG16 perceptual weights from {config.perceptual_weights}")
    return net.eval()


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).float().cpu().numpy()


def run(config: VAELaionConfig) -> dict:
    """Train, evaluate, checkpoint and sample as the config says. Returns
    ``test_losses`` (per epoch), ``epochs`` (per epoch: ``train_seconds``,
    ``images_per_sec``, ``steps``), ``resident``, ``graph`` (the resident
    step's counts of eager steps, captures and replays; None on the host
    path) and the final ``state``. A rank left idle by the data axis's gcd
    rule returns ``{"idle": True}``."""
    _check_config(config)
    dp = make_mesh_for_batch(config.batch_size) if config.use_mesh else None
    if dp is not None and not dp.active:
        return {"idle": True}
    main = is_main(dp)
    device = resolve_device(config.device)
    if device.type == "cuda":
        disable_tf32()
    dtype = COMPUTE_DTYPES[config.compute_dtype]

    with torch.random.fork_rng(devices=[]):  # seeded init, global RNG untouched
        torch.manual_seed(config.seed)
        model = ConvVAE(config.latent_dim, config.input_channels, config.image_size,
                        use_flash_attention=config.use_flash_attention, dtype=dtype)
    model = model.to(device)
    perceptual = _perceptual_net(config).to(device)
    train_images, val_images = split_train_val(load_images(config))
    resident = resolve_data_placement(config.data_placement, train_images.nbytes, "vae_laion",
                                      config.batch_size, 1 if dp is None else dp.size)
    # A captured step needs Adam's step count on the device.
    optimizer = make_optimizer(model, config.learning_rate,
                               capturable=resident and device.type == "cuda")
    state = create_train_state(model, optimizer, config.seed)
    eval_step = make_conv_vae_eval_step(perceptual, config.beta, dp)
    panel_step = make_conv_vae_eval_step(perceptual, config.beta)  # rank 0's, alone
    b = config.batch_size

    def val_eps(key, rows: int) -> torch.Tensor:
        """A val batch's noise: the global batch's, this rank's rows."""
        return shard(dp, keyed_normal(key, (global_batch(dp, rows), config.latent_dim), device))

    u8 = (1.0 / 255.0, 0.0)  # ToTensor: [0, 1]
    val_it = BatchIterator([val_images], b, shuffle=False, u8_normalize=u8)
    resident_eval = None
    if resident:
        # The host path skips all-zero batches per step (failed downloads);
        # the resident set leaves all-zero images out once, as JAX's does.
        nonzero = train_images.reshape(len(train_images), -1).any(axis=1)
        if not nonzero.all():
            print(f"Excluding {int((~nonzero).sum())} all-zero images from the "
                  "device-resident set.")
        train_data = DeviceDataset(train_images[nonzero], b, seed=config.seed, device=device,
                                   u8_normalize=u8)
        train_chunk = make_conv_vae_resident_step(perceptual, config.beta, config.clip_norm,
                                                  train_data, dp)
        # The val split on the device too when no all-zero batch would be
        # skipped, so that the resident pass sees the host pass's batches.
        if val_images.reshape(len(val_images), -1).any(axis=1).all():
            val_data = DeviceDataset(val_images, b, device=device, shuffle=False,
                                     u8_normalize=u8)
            resident_eval = make_resident_eval(
                lambda m, x, key: eval_step(m, x.contiguous(), val_eps(key, len(x)))[0],
                val_data, config.seed + 5, VAL_FOLD_STRIDE)
        else:
            print("val split contains all-zero images; keeping the host-streamed val pass "
                  "(all-zero-batch-skip parity).")
    else:
        train_it = BatchIterator([train_images], b, shuffle=True, seed=config.seed,
                                 u8_normalize=u8)
        train_step = make_conv_vae_train_step(perceptual, config.beta, config.clip_norm, dp)

    def to_nchw(batch, rows=True) -> torch.Tensor:
        """A global batch on the device, NCHW: this rank's rows, or all of
        them with ``rows=False``."""
        (x,) = val_it.to_device([shard(dp, a) if rows else a for a in batch], device)
        return x.permute(0, 3, 1, 2).contiguous()

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    logger = MetricsLogger("vae_laion", config.out_dir, dataclasses.asdict(config), enabled=main)
    ckpt_path = f"{config.checkpoint_dir}/vae_laion_best"
    keeper = BestKeeper(ckpt_path, enabled=main)
    result = {"test_losses": [], "epochs": [], "resident": resident}

    start_epoch = 1
    if config.resume:
        if checkpoint_exists(ckpt_path):
            restore_checkpoint(ckpt_path, state)
            meta = load_sidecar(ckpt_path).get("metadata", {})
            keeper.best = float(meta.get("metric", float("inf")))
            start_epoch = int(meta.get("epoch", 0)) + 1
            print(f"Resumed from {ckpt_path}: epoch {start_epoch - 1} (best loss "
                  f"{keeper.best:.4f}), continuing at epoch {start_epoch}")
        else:
            print(f"--resume set but {ckpt_path} not found; starting fresh")

    def log_batch(epoch: int, batch: int, step: int, loss: float, comp: dict) -> None:
        if not all(np.isfinite(v) for v in comp.values()):
            print(f"Loss components: {comp}")
        logger.log({"epoch": epoch, "batch": batch, "batch_train_loss": loss / b, **comp},
                   step=step)

    for epoch in range(start_epoch, config.epochs + 1):
        train_acc, n_seen = LossAccumulator(), 0
        comp_acc = {k: LossAccumulator() for k in COMPONENTS}
        synchronize()
        t0 = time.perf_counter()
        if resident:
            idxs = train_data.epoch_index_batches(epoch)
            if config.max_steps_per_epoch:
                idxs = idxs[: config.max_steps_per_epoch]

            def drain(pending) -> None:
                """One host read of a chunk: its first step's loss and
                components are logged (JAX's ``_drain``)."""
                start, step0, losses, comps = pending
                first = torch.stack([losses[0], *(comps[k][0] for k in COMPONENTS)]).tolist()
                log_batch(epoch, start, step0, first[0], dict(zip(COMPONENTS, first[1:])))

            # One chunk in flight: chunk i + 1 is queued before chunk i is read.
            pending = None
            for start in range(0, len(idxs), config.log_interval):
                chunk = idxs[start : start + config.log_interval]
                losses, comps = train_chunk(state, shard(dp, chunk, dim=1))
                train_acc.add(losses)
                for k in COMPONENTS:  # every step's, for the epoch maxima
                    comp_acc[k].add(comps[k])
                n_seen += len(chunk) * b
                if pending is not None:
                    drain(pending)
                pending = (start, state.step - len(chunk), losses, comps)
            if pending is not None:
                drain(pending)
        else:
            for batch_idx, batch in enumerate(_nonzero_batches(train_it.epoch(epoch))):
                if config.max_steps_per_epoch and batch_idx >= config.max_steps_per_epoch:
                    break
                x = to_nchw(batch)
                loss, components = train_step(state, x)
                train_acc.add(loss)
                # Every batch's components stay on the device (no sync): the
                # 256x256 recipe's blow-ups land between log points.
                for k, v in components.items():
                    comp_acc[k].add(v)
                n_seen += global_batch(dp, len(x))
                if batch_idx % config.log_interval == 0:
                    comp = {k: float(v) for k, v in components.items()}  # syncs, log points only
                    log_batch(epoch, batch_idx, state.step - 1, float(loss), comp)
        synchronize()
        train_seconds = time.perf_counter() - t0
        images_per_sec = n_seen / train_seconds if train_seconds > 0 else 0.0
        avg_train = train_acc.sum() / max(n_seen, 1)
        comp_max = {f"{k}_epoch_max": float(np.max(acc.values()))
                    for k, acc in comp_acc.items() if acc.count}

        # The val pass: finite batches only (vae_laion.py:523-545).
        test_acc, test_sizes = LossAccumulator(), []
        panel = None
        if resident_eval is not None:
            vidxs = val_data.epoch_index_batches(0)
            if config.max_steps_per_epoch:
                vidxs = vidxs[: config.max_steps_per_epoch]
            if len(vidxs):
                test_acc.add(resident_eval(model, epoch, shard(dp, vidxs, dim=1)))
                test_sizes = [b] * len(vidxs)
            # The panel from one streamed first batch: the pass returns losses only.
            first = next(iter(val_it.epoch()), None) if main else None
            if first is not None:
                x = to_nchw(first, rows=False)
                key = (config.seed + 5, epoch * VAL_FOLD_STRIDE)
                _, recon = panel_step(model, x, keyed_normal(key, (len(x), config.latent_dim),
                                                             device))
                panel = (x, recon)
        else:
            for i, batch in enumerate(_nonzero_batches(val_it.epoch())):
                if config.max_steps_per_epoch and i >= config.max_steps_per_epoch:
                    break
                x = to_nchw(batch)
                key = (config.seed + 5, epoch * VAL_FOLD_STRIDE + i)
                loss, recon = eval_step(model, x, val_eps(key, len(x)))
                test_acc.add(loss)
                test_sizes.append(global_batch(dp, len(x)))
                if i == 0:
                    panel = (x, recon)
        if panel is not None and main:  # rank 0's rows lead the first batch
            x, recon = panel
            n_img = min(config.n_images_to_log, len(x))
            grid = np.concatenate([_nhwc(x[:n_img]), _nhwc(recon[:n_img])], axis=0)
            panel_path = f"{config.out_dir}/original_vs_reconstructed_epoch_{epoch}.png"
            save_image_grid(grid, panel_path, nrow=n_img, normalize=False)
            logger.log_image("original_vs_reconstructed", panel_path)
        eval_bad = 0
        if not test_sizes:
            # A tiny config can leave the val split without a full batch:
            # the train loss stands in for the best-model policy.
            avg_test = avg_train
        else:
            vals, sizes = test_acc.values(), np.asarray(test_sizes, np.float64)
            finite = np.isfinite(vals)
            eval_bad = int((~finite).sum())
            if eval_bad:
                print(f"Epoch {epoch}: {eval_bad}/{len(vals)} eval batches non-finite, "
                      "excluded from test loss")
            avg_test = (float(vals[finite].sum() / sizes[finite].sum())
                        if finite.any() else float("inf"))
        result["test_losses"].append(avg_test)
        result["epochs"].append({"train_seconds": train_seconds,
                                 "images_per_sec": images_per_sec,
                                 "steps": train_acc.count})
        logger.log({"epoch": epoch, "train_loss": avg_train, "test_loss": avg_test,
                    "eval_nonfinite_batches": eval_bad, "train_images_per_sec": images_per_sec,
                    **comp_max}, step=state.step)
        if keeper.update(avg_test, state, config=dataclasses.asdict(config),
                         epoch=epoch) and main:
            print(f"Saved best model (epoch {epoch}, loss {avg_test:.4f})")

    # Final samples (vae_laion.py:465-477), from the live weights.
    if main:
        model.eval()
        samples = sample_prior(model, 16, torch.Generator(device).manual_seed(config.seed + 2))
        model.train()
        samples_path = f"{config.out_dir}/generated_samples.png"
        save_image_grid(_nhwc(samples), samples_path, nrow=4, normalize=False)
        logger.log_image("generated_samples", samples_path)
    result["graph"] = dict(train_chunk.counts) if resident else None
    result["state"] = state
    logger.finish()
    return result


def load_conv_vae(path: str, device: str | torch.device = "cuda") -> ConvVAE:
    """The conv-VAE of ``<path>.npz`` + ``<path>.json``, in eval mode on ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    sidecar = load_sidecar(path)["config"]
    config = ConvVAEConfig(**{f.name: sidecar[f.name] for f in dataclasses.fields(ConvVAEConfig)})
    model = ConvVAE(**dataclasses.asdict(config))
    model.load_state_dict(conv_vae_state_dict(load_weights_arrays(path)))
    return model.to(dev).eval()


def _device_of(model: ConvVAE) -> torch.device:
    return next(model.parameters()).device


# One CUDA graph each for serving, per model and batch (JAX jits both).
_RECONSTRUCT, _SAMPLE_PRIOR = GraphedCall(), GraphedCall()


def _graph_key(model: ConvVAE) -> tuple:
    """What a serving graph of ``model`` depends on besides its tensors."""
    return id(model), tuple((m.training, getattr(m, "use_flash", None)) for m in model.modules())


def _reconstruct(model: ConvVAE, x01: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    mu, logvar = model.encode(x01)
    return model.decode(reparameterize(mu, logvar, eps))


@torch.inference_mode()
def reconstruct(model: ConvVAE, x01: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Encode ``x01`` (B, C, S, S) in [0, 1], sample z with the noise ``eps``
    (B, latent_dim), decode: the reconstruction (B, C, S, S) in [0, 1]. On a
    card one CUDA graph per model and batch, after one eager call
    (``core.graphs.GraphedCall``); the flash forwards run inside it."""
    dev = _device_of(model)
    return _RECONSTRUCT(functools.partial(_reconstruct, model), _graph_key(model), model,
                        x01.to(dev, torch.float32), eps.to(dev, torch.float32))


@torch.inference_mode()
def sample_prior(model: ConvVAE, n: int, generator: torch.Generator) -> torch.Tensor:
    """Decode ``n`` latents z ~ N(0, I) drawn from ``generator`` (which lies on
    the model's device): images (n, C, S, S) in [0, 1]. The draw is eager;
    on a card the decode is one CUDA graph per model and batch, as
    ``reconstruct``'s."""
    dev = _device_of(model)
    z = torch.randn(n, model.latent_dim, generator=generator, device=dev)
    return _SAMPLE_PRIOR(model.decode, _graph_key(model), model, z)


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_config_flags(parser, VAELaionConfig())
    config = config_from_args(VAELaionConfig, parser.parse_args(argv))
    maybe_initialize_distributed(config.device)
    device = resolve_device(config.device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    run(config)


if __name__ == "__main__":
    main()
