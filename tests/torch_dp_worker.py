"""The steps that ``tests/test_torch_parallel.py`` runs in each rank of a gloo
group and, for comparison, in one process.

It imports torch and the port only, so that the ranks (spawned processes)
start quickly. Each ``*_step`` function takes the inputs that the test wrote
(``inputs``: a dict of numpy arrays and paths) and a data axis ``dp``
(``None`` for one process on the global batch), takes one SGD step on this
rank's rows of the global batch, and returns what the test compares: the
loss and the weights in the JAX package's npz keys.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.experiments import latent_diffusion
from tinydiffusion_torch.io.checkpoint import load_weights_arrays
from tinydiffusion_torch.io.from_jax import state_dict_by_name
from tinydiffusion_torch.models.mlp_unet import MLPUNetLatent
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.parallel import distributed, mesh
from tinydiffusion_torch.train import trainer

LR = 1e-2
UNET_SMALL = {"time_dim": 32, "base_width": 8}


def _schedule(inputs: dict) -> DiffusionSchedule:
    return DiffusionSchedule(*(torch.from_numpy(inputs[f"schedule_{name}"])
                               for name in ("betas", "alphas", "alphas_cumprod")))


def _rows(dp, a: np.ndarray) -> torch.Tensor:
    """This rank's rows of a global-batch array."""
    return mesh.shard(dp, torch.from_numpy(np.array(a)))


def _seams(inputs: dict, prefix: str, names: tuple[str, ...], jax_draws: bool) -> dict:
    """JAX's draws of the global batch (the seams), or none (the step's own)."""
    if not jax_draws:
        return {}
    return {name: torch.from_numpy(np.array(inputs[f"{prefix}_{name}"]))
            for name in names}


def _results(state, loss: torch.Tensor) -> dict:
    out = {"loss": np.asarray(loss.item())}
    out.update({k: v for k, v in state.jax_weights().items() if k != "step"})
    return out


def unet_step(inputs: dict, dp=None, jax_draws: bool = False) -> dict:
    """One SGD step of the small UNet28 (BatchNorm in train mode) from the
    test's weights, on the global batch ``x0`` (B, 1, 28, 28)."""
    model = UNet28(**UNET_SMALL)
    model.load_state_dict(torch.load(inputs["unet_weights"]))
    state = trainer.create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    step = trainer.make_train_step(_schedule(inputs), dp=dp)
    loss = step(state, _rows(dp, inputs["unet_x0"]),
                **_seams(inputs, "unet", ("t", "noise"), jax_draws))
    return _results(state, loss)


def unet_eval(inputs: dict, dp=None) -> dict:
    """The validation loss of the same UNet28 on the global batch."""
    model = UNet28(**UNET_SMALL)
    model.load_state_dict(torch.load(inputs["unet_weights"]))
    eval_step = trainer.make_eval_step(_schedule(inputs), dp=dp)
    return {"loss": np.asarray(eval_step(model, _rows(dp, inputs["unet_x0"]), (3, 7)).item())}


def latent_step(inputs: dict, dp=None, jax_draws: bool = False) -> dict:
    """One SGD step of the committed MLP UNet (BatchNorm1d in train mode) on
    the committed MNIST VAE's latents of the global batch."""
    vae, _ = latent_diffusion.load_vae(
        latent_diffusion.LatentDiffusionConfig(vae_checkpoint=inputs["vae_checkpoint"]),
        device="cpu")
    model = MLPUNetLatent()
    model.load_state_dict(state_dict_by_name(load_weights_arrays(inputs["mlp_checkpoint"])))
    state = trainer.create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    step = trainer.make_latent_train_step(vae, _schedule(inputs), dp=dp)
    loss = step(state, _rows(dp, inputs["latent_x0"]), _rows(dp, inputs["latent_y"]).long(),
                **_seams(inputs, "latent", ("z_eps", "t", "noise"), jax_draws))
    return _results(state, loss)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_rank(rank: int, world: int, init_file: str, inputs_path: str, out_dir: str) -> None:
    """Rank ``rank`` of ``world``: join the gloo group at ``init_file``, run
    every step with the data axis and, for the teeth check, with each rank's
    own BatchNorm statistics, and write the results to
    ``out_dir/rank<rank>.npz`` (keys ``<case>/<name>``)."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        assert distributed.maybe_initialize_distributed("cpu")  # joined: a no-op
        inputs = dict(np.load(inputs_path, allow_pickle=True))
        inputs = {k: (v.item() if v.dtype == object or v.dtype.kind == "U" else v)
                  for k, v in inputs.items()}
        records = _Records()
        logging.getLogger("tinydiffusion_torch.mesh").addHandler(records)
        batch = len(inputs["unet_x0"])
        dp = mesh.make_mesh_for_batch(batch)
        idle = mesh.make_mesh_for_batch(world * batch + 1)  # gcd 1: ranks past 0 idle
        results = {
            "mesh/size": np.asarray(dp.size), "mesh/rank": np.asarray(dp.rank),
            "mesh/local_batch_slice": np.asarray(distributed.local_batch_slice(batch)),
            "idle/size": np.asarray(idle.size), "idle/active": np.asarray(idle.active),
            "idle/warnings": np.asarray(records.messages),
        }
        cases = {
            "unet": lambda: unet_step(inputs, dp),
            "unet_jax": lambda: unet_step(inputs, dp, jax_draws=True),
            "unet_eval": lambda: unet_eval(inputs, dp),
            "latent": lambda: latent_step(inputs, dp),
            "latent_jax": lambda: latent_step(inputs, dp, jax_draws=True),
        }
        for case, fn in cases.items():
            results.update({f"{case}/{k}": v for k, v in fn().items()})
        # Each rank's own BatchNorm statistics (the gradients still reduced).
        trainer.sync_batch_norm_ = lambda model, dp: model
        results.update({f"unet_local_bn/{k}": v for k, v in unet_step(inputs, dp).items()})
        results.update({f"latent_local_bn/{k}": v for k, v in latent_step(inputs, dp).items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    finally:
        dist.destroy_process_group()


# --- the six train entry points, data-parallel ----------------------------------


def entry_configs(data_root: str, out: str, use_mesh: bool = True) -> dict:
    """Each train entry point's ``(run, config)`` at a tiny size on the CPU,
    its outputs under ``out/<name>``: a global batch that two ranks split,
    two steps (an epoch), and its val or test pass."""
    from tinydiffusion_torch.experiments import (
        conditional_diffusion,
        conditional_diffusion_laion,
        diffusion,
        vae,
        vae_laion,
    )

    def paths(name: str) -> dict:
        return {"out_dir": os.path.join(out, name)}

    # Each rank's and each run's own cold cache of the LAION records.
    laion_cache = {"image_cache_dir": os.path.join(out, "laion_cache"),
                   "failed_urls_cache": os.path.join(out, "failed_urls.json")}

    mnist = dict(device="cpu", data_root=data_root, use_mesh=use_mesh)
    pixel = dict(mnist, num_epochs=1, max_steps_per_epoch=2, batch_size=16, log_every=1,
                 num_timesteps=20, n_samples=4, denoising_stride=10, compute_dtype="float32",
                 **UNET_SMALL)
    return {
        "diffusion": (diffusion.run, diffusion.DiffusionConfig(
            **pixel, **paths("diffusion"), visualize_denoising=False,
            checkpoint_path=os.path.join(out, "diffusion", "ckpt"))),
        # The host-streamed path: each rank's rows of the host's batches.
        "diffusion_host": (diffusion.run, diffusion.DiffusionConfig(
            **pixel, **paths("diffusion_host"), visualize_denoising=False,
            data_placement="host", sample_every_epoch=False, checkpoint_path="")),
        "conditional_diffusion": (conditional_diffusion.run,
                                  conditional_diffusion.ConditionalDiffusionConfig(
            **pixel, **paths("conditional_diffusion"), label_dropout=0.5, guidance_scale=2.0,
            ema_decay=0.9, visualize_denoising=False,
            model_save_path=os.path.join(out, "conditional_diffusion", "ckpt"))),
        "vae": (vae.run, vae.VAEExperimentConfig(
            **mnist, epochs=1, max_steps_per_epoch=2, batch_size=16, log_every=1,
            **paths("vae"), checkpoint_dir=os.path.join(out, "vae", "ckpt"))),
        "latent_diffusion": (latent_diffusion.run, latent_diffusion.LatentDiffusionConfig(
            **mnist, num_epochs=1, max_steps_per_epoch=2, batch_size=16, log_every=1,
            num_timesteps=20, n_samples=4, denoising_stride=10, compute_dtype="float32",
            visualize_denoising=False, vae_checkpoint=os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints",
                "vae_mnist_best"),
            **paths("latent_diffusion"),
            model_save_path=os.path.join(out, "latent_diffusion", "ckpt"))),
        "vae_laion": (vae_laion.run, vae_laion.VAELaionConfig(
            device="cpu", use_mesh=use_mesh, image_size=64, n_records=30, batch_size=4,
            epochs=1, max_steps_per_epoch=2, log_interval=1, n_images_to_log=2,
            **paths("vae_laion"), **laion_cache,
            checkpoint_dir=os.path.join(out, "vae_laion", "ckpt"))),
        "conditional_diffusion_laion": (conditional_diffusion_laion.run,
                                        conditional_diffusion_laion.LaionDiffusionConfig(
            device="cpu", use_mesh=use_mesh, num_epochs=1, max_steps_per_epoch=2, batch_size=4,
            n_records=20, image_size=64, time_dim=32, log_every=1, num_timesteps=4,
            compute_dtype="float32", caption_dropout=0.5, guidance_scale=2.0,
            sample_every_epoch=False, **paths("conditional_diffusion_laion"), **laion_cache,
            model_save_path=os.path.join(out, "conditional_diffusion_laion", "ckpt"))),
    }


def entry_losses(result: dict) -> dict:
    """What a run's result says of its training: its logged losses and its
    per-epoch val or test losses."""
    keys = ("losses", "val_losses", "test_losses")
    return {k: np.asarray(result[k], np.float64) for k in keys if k in result}


def run_entry_points(rank: int, world: int, init_file: str, data_root: str, out: str) -> None:
    """Rank ``rank`` of ``world``: every entry point's ``run`` with
    ``use_mesh``, the outputs under ``out/rank<rank>``, the losses to
    ``out/entry_rank<rank>.npz`` (keys ``<entry>/<name>``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        results = {}
        configs = entry_configs(data_root, os.path.join(out, f"rank{rank}"))
        for name, (run, config) in configs.items():
            results.update({f"{name}/{k}": v for k, v in entry_losses(run(config)).items()})
        # A global batch of 15 on 2 ranks: the gcd rule leaves rank 1 idle.
        run, config = configs["diffusion"]
        odd = run(dataclasses.replace(config, batch_size=15, checkpoint_path="",
                                      out_dir=os.path.join(out, f"rank{rank}", "odd")))
        results["idle/idle"] = np.asarray(odd.get("idle", False))
        results.update({f"idle/{k}": v for k, v in entry_losses(odd).items()})
        np.savez(os.path.join(out, f"entry_rank{rank}.npz"), **results)
    finally:
        dist.destroy_process_group()
