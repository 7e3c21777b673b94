"""MNIST MLP VAE pretraining: train, test, keep the best checkpoint, sample.

Counterpart of ``tinydiffusion_tpu/experiments/vae.py``
(``VAEExperimentConfig``, the step, the resident step, the test step,
``run``, ``main``). Reference recipe (vae.py:79-213): MNIST in [-1, 1], Adam
1e-3, batch 128, 100 epochs; per epoch the train pass (the loss per sample
logged every ``log_every`` batches), a test pass over the 10k test split
with an original-vs-reconstructed panel of its first batch, and the
best-test checkpoint, whose sidecar carries the config that latent
diffusion reads back (``experiments.latent_diffusion.load_vae``); at the
end, 16 decodes of z ~ N(0, I).

Run on the card (the default) or, when asked, on the CPU::

    python -m tinydiffusion_torch.experiments.vae --epochs 2 \\
        --max-steps-per-epoch 20 --out-dir /tmp/v --data-root /tmp/v/data \\
        --checkpoint-dir /tmp/v/ckpt [--device cpu]

By default, as in JAX, the train set sits on the device and each chunk of
``log_every`` steps runs as replays of one captured CUDA graph (eagerly on
the CPU); the test split sits there too. Under ``torchrun --nproc_per_node
N`` the run is data-parallel over N processes (``parallel/``;
``--batch-size`` is the global batch; the summed loss and its gradients are
summed over the ranks); rank 0 alone logs and writes.

Stated deviations from the JAX run (torch cannot draw JAX's bits): the init
is torch's default from ``torch.manual_seed(seed)``; the step's
reparameterising noise comes from the state's generator on the model's
device; the test pass's from ``np.random.default_rng([seed + 7, epoch *
10000 + i])`` (JAX: ``fold_in(PRNGKey(seed + 7), epoch * 10000 + i)``); the
final samples' latents from a generator seeded with ``seed + 2``. Value
parity with JAX goes through the step's ``eps`` seam and the weight bridge.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data.loader import BatchIterator
from tinydiffusion_torch.data.mnist import MNIST_SCALE, MNIST_SHIFT, load_mnist_u8
from tinydiffusion_torch.device import disable_tf32, resolve_device
from tinydiffusion_torch.experiments.common import (
    add_config_flags,
    config_from_args,
    resolve_data_placement,
)
from tinydiffusion_torch.io.checkpoint import BestKeeper
from tinydiffusion_torch.models.vae_mnist import VAEMnist, vae_loss
from tinydiffusion_torch.obs.images import save_image_grid
from tinydiffusion_torch.obs.metrics import MetricsLogger, Throughput
from tinydiffusion_torch.parallel.distributed import maybe_initialize_distributed
from tinydiffusion_torch.parallel.mesh import (
    DataParallel,
    global_batch,
    is_main,
    make_mesh_for_batch,
    shard,
)
from tinydiffusion_torch.train.trainer import (
    DiffusionTrainState,
    create_train_state,
    keyed_normal,
    make_resident_eval,
    make_resident_steps,
    reduce_grads,
)

# The test pass's key: (seed + 7, epoch * TEST_FOLD_STRIDE + batch), JAX's
# fold_in cadence.
TEST_FOLD_STRIDE = 10000


@dataclasses.dataclass
class VAEExperimentConfig:
    """Every field of the JAX ``VAEExperimentConfig`` (its ``VAEConfig`` base
    included) with JAX's defaults but for ``checkpoint_dir``, plus ``device``.

    - ``checkpoint_dir`` defaults under ``runs/``: the JAX default
      ``checkpoints`` would put the port's ``vae_mnist_best.npz`` over the
      committed JAX weights.
    - ``data_placement``: JAX's rule (``experiments.common.resolve_data_placement``);
      ``"auto"`` keeps the train and test sets on the device.
    - ``use_mesh``: data parallelism over the processes of the group that
      ``main`` joins, as in ``experiments.diffusion``.
    """

    latent_dim: int = 20
    hidden_dim: int = 400
    input_dim: int = 784
    batch_size: int = 128
    epochs: int = 100
    learning_rate: float = 1e-3
    checkpoint_dir: str = "runs/vae/checkpoints"
    n_images_to_log: int = 8
    seed: int = 42
    data_root: str = "./data"
    out_dir: str = "runs/vae"
    use_mesh: bool = True
    log_every: int = 100
    max_steps_per_epoch: int = 0
    data_placement: str = "auto"
    device: str = "cuda"


def _vae_step_body(dp: DataParallel | None = None) -> Callable:
    """``body(state, x, eps=None) -> loss``: one step's device work (JAX's
    ``_vae_raw_step``), without the host's ``state.step`` count."""

    def body(state: DiffusionTrainState, x: torch.Tensor, eps=None) -> torch.Tensor:
        model = state.model
        model.train()
        if eps is None:
            eps = torch.randn(global_batch(dp, x.shape[0]), model.latent_dim,
                              generator=state.generator, device=x.device)
        recon, mu, logvar = model(x, shard(dp, eps))
        loss = vae_loss(recon, x, mu, logvar)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = reduce_grads(dp, model, loss.detach(), op="sum")  # a sum over the batch
        state.optimizer.step()
        return loss

    return body


def make_vae_train_step(dp: DataParallel | None = None) -> Callable:
    """The train step ``step(state, x, eps=None) -> loss``: ``x`` (B, 1, 28,
    28) float32 in [-1, 1] on the model's device, the summed loss of the
    batch back as a 0-d device tensor. ``eps`` (B, latent_dim) replaces the
    draw from ``state.generator``: the seam for JAX's noise. Under ``dp``
    (``train.trainer``'s rules) ``x`` is this rank's rows and the loss and
    gradients are the global batch's sums."""
    body = _vae_step_body(dp)

    def step(state: DiffusionTrainState, x: torch.Tensor, eps=None) -> torch.Tensor:
        loss = body(state, x, eps)
        state.step += 1
        return loss

    return step


def make_vae_resident_step(dataset: DeviceDataset, dp: DataParallel | None = None) -> Callable:
    """Training over the resident set (JAX's ``make_vae_resident_step``):
    ``step(state, idxs, eps=None) -> losses``, each step a replay of one
    captured CUDA graph on a card (``train.trainer.make_resident_steps``);
    on the CPU ``eps`` (K, B, latent_dim) may replace the draws."""
    body = _vae_step_body(dp)
    return make_resident_steps(dataset, lambda state, x, eps=None: body(state, x, eps))


def make_vae_eval_step(dp: DataParallel | None = None) -> Callable:
    """``eval_step(model, x, key, y=None) -> loss`` (JAX's
    ``make_vae_eval_step``'s loss): the reparameterising noise of ``key`` =
    (base seed, fold), no gradient. ``y`` is ignored (the test set has no
    labels here); it keeps ``make_resident_eval``'s call. Under ``dp`` the
    noise is the global batch's rows of this rank, the loss the global sum."""

    @torch.no_grad()
    def eval_step(model: VAEMnist, x: torch.Tensor, key: tuple[int, int], y=None):
        eps = keyed_normal(key, (global_batch(dp, x.shape[0]), model.latent_dim), x.device)
        recon, mu, logvar = model(x, shard(dp, eps))
        loss = vae_loss(recon, x, mu, logvar)
        return loss if dp is None else dp.all_reduce_(loss, "sum")

    return eval_step


def run(config: VAEExperimentConfig) -> dict:
    """Train, test, checkpoint and sample as the config says. Returns
    ``losses`` (the logged losses per sample), ``test_losses`` (per epoch),
    ``epochs`` (per epoch: ``train_loss``, JAX's sum over the whole set's
    size; ``steps``; ``loss_per_sample``, the mean over the samples seen;
    ``samples_per_sec``, ``train_seconds``, ``test_seconds``,
    ``test_batches``), ``resident``,
    ``graph`` (the resident step's counts of eager steps, captures and
    replays) and the final ``state``. A rank left idle by the data axis's
    gcd rule returns ``{"idle": True}``."""
    dp = make_mesh_for_batch(config.batch_size) if config.use_mesh else None
    if dp is not None and not dp.active:
        return {"idle": True}
    main = is_main(dp)
    device = resolve_device(config.device)
    if device.type == "cuda":
        disable_tf32()

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.random.fork_rng(devices=[]):  # seeded init, global RNG untouched
        torch.manual_seed(config.seed)
        model = VAEMnist(config.latent_dim, config.hidden_dim, config.input_dim)
    model = model.to(device)
    train_images, _ = load_mnist_u8(config.data_root, train=True)
    test_images, _ = load_mnist_u8(config.data_root, train=False)
    resident = resolve_data_placement(config.data_placement, train_images.nbytes, "vae",
                                      config.batch_size, 1 if dp is None else dp.size)
    # A captured step needs Adam's step count on the device.
    optimizer = torch.optim.Adam(model.parameters(), lr=config.learning_rate,
                                 capturable=resident and device.type == "cuda")
    state = create_train_state(model, optimizer, config.seed)
    eval_step = make_vae_eval_step(dp)
    b = config.batch_size
    if resident:
        train_data = DeviceDataset(train_images, b, seed=config.seed, device=device)
        test_data = DeviceDataset(test_images, b, device=device, shuffle=False)
        train_chunk = make_vae_resident_step(train_data, dp)
        resident_eval = make_resident_eval(eval_step, test_data, config.seed + 7,
                                           TEST_FOLD_STRIDE)
    else:
        u8 = (MNIST_SCALE, MNIST_SHIFT)
        train_it = BatchIterator([train_images], b, shuffle=True, seed=config.seed,
                                 u8_normalize=u8)
        test_it = BatchIterator([test_images], b, shuffle=False, u8_normalize=u8)
        train_step = make_vae_train_step(dp)

    logger = MetricsLogger("vae_mnist", config.out_dir, dataclasses.asdict(config), enabled=main)
    keeper = BestKeeper(f"{config.checkpoint_dir}/vae_mnist_best", enabled=main)
    throughput = Throughput()
    result = {"losses": [], "test_losses": [], "epochs": [], "resident": resident}
    # JAX's normalisers: the whole sets' full batches, whatever the step cap.
    n_train = len(train_images) - len(train_images) % b
    n_test = len(test_images) - len(test_images) % b

    def log_loss(epoch: int, batch: int, loss: torch.Tensor) -> None:
        value = float(loss) / b  # syncs, at log points only
        logger.log({"epoch": epoch, "batch": batch, "loss_per_sample": value})
        result["losses"].append(value)

    for epoch in range(1, config.epochs + 1):  # JAX counts epochs from 1
        synchronize()
        t0 = time.perf_counter()
        throughput.reset()
        losses = []  # device tensors, read once at the epoch's end
        if resident:
            idxs = train_data.epoch_index_batches(epoch)
            if config.max_steps_per_epoch:
                idxs = idxs[: config.max_steps_per_epoch]
            for start in range(0, len(idxs), config.log_every):
                chunk = idxs[start : start + config.log_every]
                chunk_losses = train_chunk(state, shard(dp, chunk, dim=1))
                losses.append(chunk_losses)
                throughput.add(len(chunk) * b)
                log_loss(epoch, start, chunk_losses[0])
        else:
            for batch_idx, batch in enumerate(train_it.epoch(epoch)):
                if config.max_steps_per_epoch and batch_idx >= config.max_steps_per_epoch:
                    break
                (x,) = train_it.to_device([shard(dp, a) for a in batch], device)
                loss = train_step(state, x.permute(0, 3, 1, 2))
                losses.append(loss.view(1))
                throughput.add(b)
                if batch_idx % config.log_every == 0:
                    log_loss(epoch, batch_idx, loss)
        train_sum = torch.cat(losses).double().sum().item() if losses else 0.0  # syncs
        avg_train_loss = train_sum / max(n_train, 1)
        steps = sum(len(x) for x in losses)
        sps = throughput.samples_per_sec
        train_seconds = time.perf_counter() - t0

        # The test pass (vae.py:129-163), then the panel of its first batch.
        t0 = time.perf_counter()
        if resident:
            tidxs = test_data.epoch_index_batches(0)
            if config.max_steps_per_epoch:
                tidxs = tidxs[: config.max_steps_per_epoch]
            test_losses = resident_eval(model, epoch, shard(dp, tidxs, dim=1))
            x_first = test_data.gather(torch.from_numpy(shard(dp, tidxs[0])).to(device))
        else:
            test_losses = []
            for i, batch in enumerate(test_it.epoch()):
                if config.max_steps_per_epoch and i >= config.max_steps_per_epoch:
                    break
                (x,) = test_it.to_device([shard(dp, a) for a in batch], device)
                if i == 0:
                    x_first = x
                test_losses.append(eval_step(model, x.permute(0, 3, 1, 2),
                                             (config.seed + 7, epoch * TEST_FOLD_STRIDE + i)
                                             ).view(1))
            test_losses = torch.cat(test_losses)
        avg_test_loss = test_losses.double().sum().item() / max(n_test, 1)
        test_seconds = time.perf_counter() - t0
        result["test_losses"].append(avg_test_loss)
        n_img = config.n_images_to_log
        if main:  # rank 0's rows lead the first batch
            with torch.no_grad():
                eps0 = keyed_normal((config.seed + 7, epoch * TEST_FOLD_STRIDE),
                                    (len(x_first), config.latent_dim), device)
                recon0, _, _ = model(x_first, eps0)
            originals = (x_first[:n_img].reshape(-1, 28, 28, 1).cpu().numpy() + 1) / 2
            recons = recon0[:n_img].reshape(-1, 28, 28, 1).cpu().numpy()
            panel_path = f"{config.out_dir}/original_vs_reconstructed_epoch_{epoch}.png"
            save_image_grid(np.concatenate([originals, recons]), panel_path, nrow=n_img,
                            normalize=False)
            logger.log_image("original_vs_reconstructed", panel_path)

        logger.log({"epoch": epoch, "train_loss": avg_train_loss, "test_loss": avg_test_loss,
                    "train_samples_per_sec": sps})
        result["epochs"].append({"train_loss": avg_train_loss, "steps": steps,
                                 "loss_per_sample": train_sum / max(steps * b, 1),
                                 "samples_per_sec": sps, "train_seconds": train_seconds,
                                 "test_seconds": test_seconds, "test_batches": len(test_losses)})
        if keeper.update(avg_test_loss, state, config=dataclasses.asdict(config),
                         epoch=epoch) and main:
            print(f"Saved best model (epoch {epoch}, test loss {avg_test_loss:.4f})")

    # Final samples: decode z ~ N(0, I) (vae.py:196-212).
    if main:
        z = torch.randn(16, config.latent_dim, generator=torch.Generator(device).manual_seed(
            config.seed + 2), device=device)
        with torch.no_grad():
            samples = model.decode(z)
        samples_path = f"{config.out_dir}/generated_samples.png"
        save_image_grid(samples.reshape(-1, 28, 28, 1).cpu().numpy(), samples_path, nrow=4,
                        normalize=False)
        logger.log_image("generated_samples", samples_path)
    result["graph"] = dict(train_chunk.counts) if resident else None
    result["state"] = state
    logger.finish()
    return result


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_config_flags(parser, VAEExperimentConfig())
    config = config_from_args(VAEExperimentConfig, parser.parse_args(argv))
    maybe_initialize_distributed(config.device)
    device = resolve_device(config.device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    run(config)


if __name__ == "__main__":
    main()
