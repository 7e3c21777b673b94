"""The steps that ``tests/test_torch_tensor_parallel.py`` runs in each rank of
a gloo group and, for comparison, in one process.

It imports torch and the port only, so that the ranks start quickly. Each
rank joins a world of four for the ``(2, 2)``, ``(4, 1)`` and ``(1, 4)``
meshes (the last with a UNet28 of base width 2), then
ranks 0 and 1 join a world of two for ``(1, 2)``. On each mesh it takes one
SGD step of the small UNet28 (unconditional, and class-conditional with
label dropout and an EMA) from the test's weights, with the step's own
draws and with JAX's draws through the seams, three resident steps
(``make_resident_multi_step``), and once more with the
gather's backward made to split its gradient instead of reduce-scattering
it, and once with the one-channel head's gather made to sum its whole
gradient over the model axis (the checks with teeth). It records the loss,
its shards' shapes, its copy of each tensor left whole, the whole weights
gathered back (``gather_state_dict``) in the JAX package's npz keys, and
rank 0 writes the gathered checkpoint's npz.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.io.checkpoint import save_weights
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.parallel import mesh as mesh_lib
from tinydiffusion_torch.train import trainer

LR = 1e-2
UNET_SMALL = {"time_dim": 32, "base_width": 8}
NUM_CLASSES, NULL_LABEL, LABEL_DROPOUT, EMA_DECAY = 11, 10, 0.5, 0.9
CASES = ("unet", "unet_jax", "cond", "cond_jax")
RESIDENT_STEPS = 3


def _schedule(inputs: dict) -> DiffusionSchedule:
    return DiffusionSchedule(*(torch.from_numpy(inputs[f"schedule_{name}"])
                               for name in ("betas", "alphas", "alphas_cumprod")))


def _model(conditional: bool) -> UNet28:
    return UNet28(**UNET_SMALL, num_classes=NUM_CLASSES if conditional else None)


def _replicated(model: UNet28, shardings: dict) -> dict:
    """This rank's copy of every tensor the model axis leaves whole."""
    return {f"replicated/{k}": v.detach().numpy().copy() for k, v in model.state_dict().items()
            if shardings[k] is None}


def step(inputs: dict, case: str, mesh: mesh_lib.Mesh | None = None) -> dict:
    """One SGD step of ``case`` on ``mesh`` (None: one process, the whole
    batch): the loss, the shards' shapes and the whole weights after it."""
    conditional = case.startswith("cond")
    jax_draws = case.endswith("_jax")
    model = _model(conditional)
    weights = torch.load(inputs["cond_weights" if conditional else "unet_weights"])
    shardings = None
    if mesh is not None:
        shardings = mesh_lib.infer_state_sharding(model, mesh)
        mesh_lib.apply_sharding(model, shardings, mesh, state_dict=weights)
    else:
        model.load_state_dict(weights)
    state = trainer.create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0,
                                       ema=conditional)
    kw = dict(conditional=True, label_dropout=LABEL_DROPOUT, null_label=NULL_LABEL,
              ema_decay=EMA_DECAY) if conditional else {}
    train_step = trainer.make_train_step(_schedule(inputs), mesh=mesh, **kw)
    prefix = "cond" if conditional else "unet"
    dp = None if mesh is None else mesh.dp
    x0 = mesh_lib.shard(dp, torch.from_numpy(np.array(inputs[f"{prefix}_x0"])))
    args = (mesh_lib.shard(dp, torch.from_numpy(np.array(inputs["cond_y"])).long()),) if (
        conditional) else ()
    seams = {}
    if jax_draws:
        names = ("t", "noise", "keep") if conditional else ("t", "noise")
        seams = {n: torch.from_numpy(np.array(inputs[f"{prefix}_{n}"])) for n in names}
    loss = train_step(state, x0, *args, **seams)
    out = {"loss": np.asarray(loss.item())}
    out.update({f"shape/{k}": np.asarray(v.shape) for k, v in model.state_dict().items()})
    if mesh is not None:
        out.update(_replicated(model, shardings))
        whole = _model(conditional)
        whole.load_state_dict(mesh_lib.gather_state_dict(model.state_dict(), shardings, mesh))
        ema = (mesh_lib.gather_state_dict(state.ema_params, shardings, mesh)
               if state.ema_params is not None else None)
        state = trainer.DiffusionTrainState(whole, state.optimizer, state.generator, ema,
                                            state.step)
    out.update({k: v for k, v in state.jax_weights().items() if k != "step"})
    return out


def resident_steps(inputs: dict, mesh: mesh_lib.Mesh | None = None) -> dict:
    """RESIDENT_STEPS steps of ``make_resident_multi_step`` over a resident
    set (the step's own draws), sharded on ``mesh`` or in one process: the
    losses and the whole weights after them."""
    model = _model(False)
    weights = torch.load(inputs["unet_weights"])
    shardings = None
    if mesh is not None:
        shardings = mesh_lib.infer_state_sharding(model, mesh)
        mesh_lib.apply_sharding(model, shardings, mesh, state_dict=weights)
    else:
        model.load_state_dict(weights)
    state = trainer.create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 5)
    dataset = DeviceDataset(np.array(inputs["resident_images"]), len(inputs["unet_x0"]), seed=4,
                            device="cpu")
    step = trainer.make_resident_multi_step(_schedule(inputs), dataset, mesh=mesh)
    idxs = dataset.epoch_index_batches(0)[:RESIDENT_STEPS]
    losses = step(state, mesh_lib.shard(None if mesh is None else mesh.dp, idxs, dim=1))
    if mesh is not None:
        whole = _model(False)
        whole.load_state_dict(mesh_lib.gather_state_dict(model.state_dict(), shardings, mesh))
        state = trainer.DiffusionTrainState(whole, state.optimizer, state.generator, None,
                                            state.step)
    out = {"loss": losses.numpy()}
    out.update({k: v for k, v in state.jax_weights().items() if k != "step"})
    return out


NARROW = {"time_dim": 32, "base_width": 2}


def narrow_step(inputs: dict, mesh: mesh_lib.Mesh | None = None) -> dict:
    """One SGD step of a UNet28 of base width 2 from a seeded init: on four
    model ranks its stem (2 channels) stays whole and feeds the sharded
    enc1 (4), whose input gradient each rank then holds in part."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        model = UNet28(**NARROW)
    shardings = None
    if mesh is not None:
        shardings = mesh_lib.infer_state_sharding(model, mesh)
        mesh_lib.apply_sharding(model, shardings, mesh)
    state = trainer.create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    step = trainer.make_train_step(_schedule(inputs), mesh=mesh)
    loss = step(state, torch.from_numpy(np.array(inputs["unet_x0"])))
    out = {"loss": np.asarray(loss.item()),
           "sharded": np.asarray(sorted(k for k, d in (shardings or {}).items() if d is not None))}
    if mesh is not None:
        out.update(_replicated(model, shardings))
        whole = UNet28(**NARROW)
        whole.load_state_dict(mesh_lib.gather_state_dict(model.state_dict(), shardings, mesh))
        state = trainer.DiffusionTrainState(whole, state.optimizer, state.generator, None,
                                            state.step)
    out.update({k: v for k, v in state.jax_weights().items() if k != "step"})
    return out


def _split_backward(ctx, grad):
    """The gather's backward with the reduce-scatter taken out: each rank
    keeps its own slice of its partial gradient."""
    mp, widths = ctx.mp, ctx.widths
    grad = grad.movedim(1, -1)
    blocks = grad.split([w * mp.size for w in widths], -1)
    mine = torch.cat([b.split(w, -1)[mp.rank] for b, w in zip(blocks, widths)], -1)
    return (None, None, *[g.movedim(-1, 1) for g in mine.split(widths, -1)])


def _run_mesh(inputs: dict, mesh: mesh_lib.Mesh, tag: str, out_dir: str, rank: int) -> dict:
    results = {f"{tag}/place": np.asarray([mesh.data.rank, mesh.data.size, mesh.model.rank,
                                           mesh.model.size])}
    for case in CASES:
        got = step(inputs, case, mesh)
        results.update({f"{tag}/{case}/{k}": v for k, v in got.items()})
    results.update({f"{tag}/resident/{k}": v for k, v in resident_steps(inputs, mesh).items()})
    if mesh.mp is not None:
        keep = mesh_lib._ToFull.backward
        mesh_lib._ToFull.backward = staticmethod(_split_backward)
        try:
            results.update({f"{tag}/teeth/{k}": v for k, v in step(inputs, "unet", mesh).items()})
        finally:
            mesh_lib._ToFull.backward = keep
        keep = mesh_lib.out_sharded
        mesh_lib.out_sharded = lambda layer: True  # every consumer taken as sharded
        try:
            results.update({f"{tag}/teeth_sum/{k}": v
                            for k, v in step(inputs, "unet", mesh).items()})
        finally:
            mesh_lib.out_sharded = keep
    if rank == 0:
        weights = {k.split("/", 2)[2]: v for k, v in results.items()
                   if k.startswith(f"{tag}/cond/") and k.split("/")[2] not in ("shape", "replicated")
                   and k != f"{tag}/cond/loss"}
        save_weights(os.path.join(out_dir, f"{tag}_cond"), weights)
    return results


def run_rank(rank: int, init_dir: str, inputs_path: str, out_dir: str) -> None:
    """Rank ``rank`` of four: the ``(2, 2)`` and ``(4, 1)`` meshes, then (ranks
    0 and 1) the ``(1, 2)`` one; results to ``out_dir/rank<rank>.npz``."""
    torch.set_num_threads(1)
    inputs = dict(np.load(inputs_path, allow_pickle=True))
    inputs = {k: (v.item() if v.dtype == object or v.dtype.kind == "U" else v)
              for k, v in inputs.items()}
    results = {}
    dist.init_process_group("gloo", init_method=f"file://{init_dir}/world4", rank=rank,
                            world_size=4)
    try:
        results.update(_run_mesh(inputs, mesh_lib.make_mesh(("data", "model"), (2, 2)), "m22",
                                 out_dir, rank))
        dp_mesh = mesh_lib.make_mesh(("data",))
        results["m41/place"] = np.asarray([dp_mesh.data.rank, dp_mesh.data.size,
                                           dp_mesh.model.rank, dp_mesh.model.size])
        results.update({f"m41/unet/{k}": v for k, v in step(inputs, "unet", dp_mesh).items()})
        narrow_mesh = mesh_lib.make_mesh(("data", "model"), (1, 4))
        results["m14/place"] = np.asarray([0, 1, narrow_mesh.model.rank, 4])
        results.update({f"m14/narrow/{k}": v for k, v in narrow_step(inputs, narrow_mesh).items()})
    finally:
        dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group("gloo", init_method=f"file://{init_dir}/world2", rank=rank,
                                world_size=2)
        try:
            results.update(_run_mesh(inputs, mesh_lib.make_mesh(("data", "model"), (1, 2)),
                                     "m12", out_dir, rank))
        finally:
            dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
