"""The port's class-conditional path against the JAX package, on the CPU.

Classifier-free-guidance and v-prediction sampling (``make_sampler``), the
checkpoint loader on the committed conditional checkpoints, the label-dropout
train step through its ``(t, noise, keep)`` seam, the resident conditional
step and validation pass, the data split, and the experiment's ``run()``.
Small models are base width 8, time dim 32, float32; JAX's draws reach the
port through its replay seams.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_diffusion import (
    LOSS_RTOL,
    PARAM_ATOL,
    SMALL,
    STATS_ATOL,
    STATS_RTOL,
    _idx_data_root,
    _same_tables,
    nchw,
    nhwc,
)
from tests.test_torch_sampler import _stream
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.data.device import DeviceDataset as JaxDeviceDataset
from tinydiffusion_tpu.data.mnist import train_val_split as jax_train_val_split
from tinydiffusion_tpu.experiments.common import make_sampler as jax_make_sampler
from tinydiffusion_tpu.experiments.conditional_diffusion import (
    ConditionalDiffusionConfig as JaxConditionalConfig,
)
from tinydiffusion_tpu.io.checkpoint import _flat_items, restore_weights
from tinydiffusion_tpu.models.unet28 import UNet28 as JaxUNet28
from tinydiffusion_tpu.train.trainer import _raw_step_fn
from tinydiffusion_tpu.train.trainer import create_train_state as jax_create_train_state
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data.loader import BatchIterator
from tinydiffusion_torch.data.mnist import MNIST_SCALE, MNIST_SHIFT, train_val_split
from tinydiffusion_torch.experiments import conditional_diffusion
from tinydiffusion_torch.experiments.common import (
    load_pixel_checkpoint,
    load_unet28,
    make_sampler,
)
from tinydiffusion_torch.io.from_jax import unet28_state_dict
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.train.trainer import (
    create_train_state,
    make_eval_step,
    make_resident_eval,
    make_resident_multi_step,
    make_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_CHECKPOINT = os.path.join(REPO, "checkpoints", "conditional_cfg_ema_best")
COND_CHECKPOINT = os.path.join(REPO, "checkpoints", "conditional_diffusion_best")
U8 = (MNIST_SCALE, MNIST_SHIFT)
NULL = 10  # the null class of a CFG model: one row past the 10 digits
# Guided chains of the small UNet, float32: the model's summation order
# carried through the steps, as tests/test_torch_sampler.py bounds it,
# relative to the largest |x| (the random init's samples reach |x| ~ 100).
CHAIN_REL = 2e-5
# The full-width model's eps on the committed weights, float32: summation
# order through 11.2 M params (tests/test_torch_unet28.py's bound).
MODEL_ATOL, MODEL_RTOL = 1e-4, 1e-4
BATCH, LR = 16, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops; the suite runs several workers on a
    few cores, where torch's default of one thread a core oversubscribes
    them. One thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_cond_pair(seed: int = 0, num_classes: int = NULL + 1):
    """A class-conditional JAX UNet28 init at small width, and the port's copy."""
    jmodel = JaxUNet28(**SMALL, num_classes=num_classes, dtype=jnp.float32)
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))()
    flat, _ = _flat_items(variables)
    model = UNet28(**SMALL, num_classes=num_classes)
    model.load_state_dict(unet28_state_dict({k: np.asarray(v) for k, v in flat.items()}))
    return jmodel, variables, model


# --- sampling: guidance and v-prediction ----------------------------------------


@pytest.mark.parametrize("method, T, steps", [("ddpm", 20, 20), ("ddim", 1000, 10),
                                              ("dpmpp", 1000, 10)])
@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_guided_make_sampler_matches_jax(method, T, steps, prediction):
    """Classifier-free guidance at scale 2 (one doubled-batch forward a step,
    [y, null] stacked), against JAX's key-driven sampler fed the same draws."""
    jmodel, variables, model = _small_cond_pair(seed=1)
    jsched = JaxSchedule.linear(T)
    shape, key = (3, 28, 28, 1), jax.random.PRNGKey(9)
    y = np.array([1, 7, 3], np.int32)
    options = dict(conditional=True, method=method, sample_steps=steps, guidance_scale=2.0,
                   null_label=NULL, prediction=prediction)
    want = np.asarray(jax_make_sampler(jmodel, jsched, shape, **options)(
        variables["params"], variables["batch_stats"], key, y=y))
    key, init_key = jax.random.split(key)
    x_init = np.asarray(jax.random.normal(init_key, shape))
    zs = []
    for _ in range(steps if method == "ddpm" else 0):
        key, step_key = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(step_key, shape)))
    model.train()  # the sampler puts the model in eval mode and back
    got = make_sampler(model, _same_tables(jsched), (3, 1, 28, 28), **options)(
        x_init=nchw(x_init), noise_stream=_stream(zs), y=torch.from_numpy(y).long())
    assert model.training
    np.testing.assert_allclose(nhwc(got), want, atol=CHAIN_REL * np.abs(want).max(), rtol=0)


def test_guidance_is_one_doubled_forward_a_step():
    _, _, model = _small_cond_pair()
    batches = []
    model.register_forward_pre_hook(lambda m, args: batches.append(args[0].shape[0]))
    sampler = make_sampler(model, DiffusionSchedule.linear(1000), (3, 1, 28, 28),
                           conditional=True, method="ddim", sample_steps=4,
                           guidance_scale=2.0, null_label=NULL)
    sampler(torch.Generator().manual_seed(0), y=torch.tensor([1, 2, 3]))
    assert batches == [6] * 4
    with pytest.raises(ValueError, match="labels"):
        sampler(torch.Generator())
    with pytest.raises(ValueError, match="shape"):
        sampler(torch.Generator(), y=torch.tensor([1, 2]))


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_the_sampler_forward_follows_compute_dtype(compute_dtype):
    """The model runs in ``compute_dtype`` (bfloat16: autocast), the chain
    in its own ``dtype``: JAX's bf16 UNet28 under a float32 chain."""
    model = UNet28(**SMALL)
    seen = []
    model.initial_conv.register_forward_hook(lambda m, a, out: seen.append(out.dtype))
    samples = make_sampler(model, DiffusionSchedule.linear(3), (2, 1, 28, 28),
                           dtype=torch.float32, compute_dtype=compute_dtype)(
        torch.Generator().manual_seed(0))
    assert seen == [compute_dtype] * 3 and samples.dtype == torch.float32


# --- checkpoints ------------------------------------------------------------------


def _jax_variables(path: str, num_classes: int, ema: bool):
    """The committed weights in a float32 JAX UNet28's tree."""
    jmodel = JaxUNet28(time_dim=256, num_classes=num_classes, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))
    template = {"params": shapes["params"], "batch_stats": shapes["batch_stats"]}
    if ema:
        template["ema_params"] = shapes["params"]
    tree = restore_weights(path, template)
    serving = tree["ema_params"] if ema else tree["params"]
    return jmodel, {"params": serving, "batch_stats": tree["batch_stats"]}


@pytest.mark.parametrize("path, rows, ema", [(CFG_CHECKPOINT, 11, True),
                                             (COND_CHECKPOINT, 10, False)])
def test_load_pixel_checkpoint_matches_jax(path, rows, ema):
    """The committed conditional checkpoints: the CFG one has the null row
    (11) and an EMA shadow, served by default; eps of the full-width model
    at n = 2, float32, against JAX's on the same serving params."""
    loaded = load_pixel_checkpoint(path, device="cpu")
    model = loaded["model"]
    assert not model.training
    assert model.class_embedding.weight.shape == (rows, 256)
    assert loaded["conditional"] and loaded["num_classes"] == 10
    assert loaded["cfg_trained"] == (rows == 11) and loaded["use_ema"] == ema
    assert loaded["step"] == 37500 and loaded["schedule"].num_timesteps == 1000
    assert loaded["cfg"]["label_dropout"] == (0.1 if ema else 0.0)
    jmodel, variables = _jax_variables(path, rows, ema)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 28, 28, 1)).astype(np.float32)
    t = np.array([17, 901], np.int32)
    y = np.array([7, rows - 1], np.int32)  # the CFG model's null row too
    want = jax.jit(lambda v: jmodel.apply(v, x, t, y, train=False))(variables)
    with torch.no_grad():
        got = torch.func.functional_call(model, loaded["params"], (
            nchw(x), torch.from_numpy(t).long(), torch.from_numpy(y).long()))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=MODEL_ATOL, rtol=MODEL_RTOL)


def test_load_unet28_loads_the_cfg_checkpoint():
    """``load_unet28`` once built ``Embedding(num_classes, 256)`` and failed
    on a label-dropout checkpoint's 11 rows; it now serves its EMA shadow."""
    model = load_unet28(CFG_CHECKPOINT, device="cpu")
    loaded = load_pixel_checkpoint(CFG_CHECKPOINT, device="cpu")
    assert model.class_embedding.weight.shape == (11, 256)
    for name, p in model.named_parameters():
        assert torch.equal(p, loaded["params"][name]), name


# --- training -----------------------------------------------------------------------


@pytest.mark.parametrize("label_dropout", [0.1, 0.5])
def test_label_dropout_step_matches_jax(label_dropout):
    """One SGD step of a CFG model (11 rows) at B = 16: the port gets the t,
    noise and kept labels that JAX's step draws from its state's key."""
    jmodel = JaxUNet28(**SMALL, num_classes=NULL + 1, dtype=jnp.float32)
    tx = optax.sgd(LR)
    example = (jnp.zeros((BATCH, 28, 28, 1)), jnp.zeros((BATCH,), jnp.int32),
               jnp.zeros((BATCH,), jnp.int32))
    jstate = jax_create_train_state(jmodel, tx, example, jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1, 1, (BATCH, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    _, t_key, noise_key, _, ldrop_key = jax.random.split(jstate.rng, 5)
    t = np.asarray(jax.random.randint(t_key, (BATCH,), 0, 1000))
    noise = np.asarray(jax.random.normal(noise_key, x0.shape))
    keep = np.asarray(jax.random.bernoulli(ldrop_key, 1.0 - label_dropout, y.shape))
    if label_dropout == 0.5:
        assert keep.any() and not keep.all()  # both branches of the dropout
    flat, _ = _flat_items({"params": jstate.params, "batch_stats": jstate.batch_stats})
    flat = {k: np.asarray(v) for k, v in flat.items()}
    jschedule = JaxSchedule.linear(1000)
    jstep = jax.jit(_raw_step_fn(jmodel, tx, jschedule, conditional=True,
                                 label_dropout=label_dropout, null_label=NULL))
    new_jstate, jloss = jstep(jstate, jnp.asarray(x0), jnp.asarray(y))

    model = UNet28(**SMALL, num_classes=NULL + 1)
    model.load_state_dict(unet28_state_dict(flat))
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    step = make_train_step(_same_tables(jschedule), conditional=True,
                           label_dropout=label_dropout, null_label=NULL)
    loss = step(state, nchw(x0), torch.from_numpy(y).long(), t=torch.from_numpy(t).long(),
                noise=nchw(noise), keep=torch.from_numpy(keep))

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want, _ = _flat_items({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats})
    got = state.jax_weights()
    for key, value in want.items():
        value = np.asarray(value)
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got[key], value, rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=PARAM_ATOL, rtol=0, err_msg=key)
    # The null row trained exactly where labels were dropped.
    moved = (got["params/class_embedding/embedding"] != flat["params/class_embedding/embedding"])
    assert moved[NULL].any() == (not keep.all())


def test_conditional_step_options_are_checked():
    sched = DiffusionSchedule.linear(10)
    with pytest.raises(ValueError, match="label_dropout requires"):
        make_train_step(sched, label_dropout=0.1)
    with pytest.raises(ValueError, match="label_dropout requires"):
        make_train_step(sched, conditional=True, label_dropout=0.1)
    model = UNet28(**SMALL, num_classes=10)
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    with pytest.raises(ValueError, match="labels y"):
        make_train_step(sched, conditional=True)(state, torch.zeros(2, 1, 28, 28))
    ds = DeviceDataset(np.zeros((8, 28, 28, 1), np.uint8), 4, device="cpu")
    with pytest.raises(ValueError, match="labels"):
        make_resident_multi_step(sched, ds, conditional=True)


def test_resident_conditional_steps_match_host_steps():
    """K = 3 resident steps with label dropout (their own draws: t, then the
    q_sample seed, then the kept labels, from the state's generator) against
    host steps on the gathered batches given the same draws, replayed from a
    probe of that generator: the same losses and weights, to the bit."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (24, 28, 28, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, 24).astype(np.int32)
    ds = DeviceDataset(images, 8, seed=2, device="cpu", labels=labels)
    sched = DiffusionSchedule.linear(1000)
    idxs = ds.epoch_index_batches(0)[:3]
    options = dict(conditional=True, label_dropout=0.5, null_label=NULL, ema_decay=0.9)
    runs = []
    for resident in (True, False):
        torch.manual_seed(5)
        model = UNet28(**SMALL, num_classes=NULL + 1)
        state = create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), 6,
                                   ema=True)
        if resident:
            step = make_resident_multi_step(sched, ds, **options)
            before = qsample.qsample_launches
            losses = step(state, idxs).tolist()
            assert qsample.qsample_launches == before and step.counts["eager"] == 3
        else:
            probe = torch.Generator().manual_seed(0)
            probe.set_state(state.generator.get_state())
            step = make_train_step(sched, **options)
            losses = []
            for row in idxs:
                x0, y = ds.gather(torch.from_numpy(row))
                x0 = x0.permute(0, 3, 1, 2)
                t = torch.randint(0, 1000, (8,), generator=probe)
                seed = torch.randint(0, 2**31 - 1, (), generator=probe)
                keep = torch.rand(8, generator=probe) < 0.5
                noise = qsample.q_sample_fused_reference(sched, x0, t, int(seed))[1]
                losses.append(step(state, x0, y, t=t, noise=noise, keep=keep).item())
        runs.append((losses, [p.detach().clone() for p in state.ema_params.values()]))
    assert runs[0][0] == runs[1][0] and len(set(runs[0][0])) == 3
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_resident_eval_equals_host_eval_bit_for_bit():
    """The resident val pass (gathers on the device, one read) against the
    host-streamed one (batches uploaded), with the same (seed + 1, epoch *
    10000 + i) keys: the same losses, to the bit; another epoch draws
    other noise."""
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (40, 28, 28, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, 40).astype(np.int32)
    sched = DiffusionSchedule.linear(1000)
    torch.manual_seed(7)
    model = UNet28(**SMALL, num_classes=10)
    model.train()
    eval_step = make_eval_step(sched, conditional=True)
    ds = DeviceDataset(images, 8, seed=3, device="cpu", labels=labels, shuffle=False)
    call = make_resident_eval(eval_step, ds, base_seed=1)
    resident = call(model, 3, ds.epoch_index_batches(0))
    host_it = BatchIterator([images, labels], 8, shuffle=False, u8_normalize=U8)
    host = []
    for i, batch in enumerate(host_it.epoch()):
        x0, y = host_it.to_device(batch, torch.device("cpu"))
        host.append(eval_step(model, x0.permute(0, 3, 1, 2), (1, 3 * 10000 + i), y.long()))
    assert model.training  # eval mode only inside the step
    assert resident.shape == (5,) and torch.equal(resident, torch.stack(host))
    assert not torch.equal(resident, call(model, 4, ds.epoch_index_batches(0)))
    assert torch.equal(resident, call(model, 3, ds.epoch_index_batches(0)))


# --- data -----------------------------------------------------------------------------


def test_train_val_split_matches_jax():
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (101, 28, 28, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, 101).astype(np.int32)
    ours = train_val_split(images, labels, 0.2, seed=42)
    theirs = jax_train_val_split(images, labels, 0.2, seed=42)
    assert [len(a) for a in ours] == [81, 81, 20, 20]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_labelled_unshuffled_device_dataset_matches_jax():
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (50, 28, 28, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, 50).astype(np.int32)
    for shuffle in (False, True):
        ours = DeviceDataset(images, 8, seed=1, device="cpu", labels=labels, shuffle=shuffle)
        theirs = JaxDeviceDataset([images, labels], 8, shuffle=shuffle, seed=1,
                                  u8_normalize=U8)
        idxs = ours.epoch_index_batches(2)
        np.testing.assert_array_equal(idxs, theirs.epoch_index_batches(2))
        x, y = ours.gather(torch.from_numpy(idxs[1]))
        jx, jy = theirs.gather(jnp.asarray(idxs[1]))
        assert y.dtype == torch.int64
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1.2e-7, rtol=0)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert np.array_equal(DeviceDataset(images, 8, device="cpu", shuffle=False)
                          .epoch_index_batches(5), np.arange(48).reshape(6, 8))
    with pytest.raises(ValueError, match="labels"):
        DeviceDataset(images, 8, device="cpu", labels=labels[:10])


# --- the entry point ----------------------------------------------------------------


def test_config_takes_the_jax_flags():
    ours = {f.name: f.default for f in dataclasses.fields(
        conditional_diffusion.ConditionalDiffusionConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConditionalConfig)}
    assert {k for k in theirs if ours[k] != theirs[k]} == {"model_save_path"}
    assert not ours["model_save_path"].startswith("checkpoints")
    assert set(ours) - set(theirs) == {"base_width", "device"}


def test_run_on_the_cpu_alike_on_both_paths_and_serves_its_checkpoint(tmp_path):
    """The CFG recipe at small width, host-streamed and resident: the same
    batches, draws and val keys, so the same losses and val losses to the
    bit; the best checkpoint loads with its null row and EMA shadow."""
    results = {}
    for placement in ("host", "device"):
        config = conditional_diffusion.ConditionalDiffusionConfig(
            device="cpu", num_epochs=2, max_steps_per_epoch=3, batch_size=4, log_every=2,
            num_timesteps=20, n_samples=4, denoising_stride=10, compute_dtype="float32",
            label_dropout=0.5, guidance_scale=2.0, ema_decay=0.9, data_placement=placement,
            data_root=_idx_data_root(tmp_path / placement), out_dir=str(tmp_path / placement),
            model_save_path=str(tmp_path / placement / "ckpt"),
            sample_every_epoch=placement == "device", visualize_denoising=placement == "device",
            **SMALL)
        results[placement] = conditional_diffusion.run(config)
    host, resident = results["host"], results["device"]
    assert not host["resident"] and resident["resident"]
    assert host["losses"] == resident["losses"] and len(host["losses"]) == 4
    assert host["val_losses"] == resident["val_losses"] and len(host["val_losses"]) == 2
    assert resident["graph"] == {"eager": 6, "captures": 0, "replays": 0}
    assert resident["qsample_launches"] == {"train": 0, "eval": 0}  # the CPU runs no kernel
    out = tmp_path / "device"
    for name in ["generated_mnist_epoch_0.png", "generated_mnist_epoch_1.png",
                 "generated_digit_7.png", "denoising_t20.png", "denoising_t10.png"]:
        assert (out / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    with open(out / "conditional-diffusion-mnist" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["val_loss"] for r in records if "val_loss" in r] == resident["val_losses"]
    sidecar = json.loads((out / "ckpt.json").read_text())
    assert sidecar["metadata"]["metric"] == min(resident["val_losses"])
    loaded = load_pixel_checkpoint(str(out / "ckpt"), device="cpu")
    assert loaded["cfg_trained"] and loaded["use_ema"]
    assert loaded["model"].class_embedding.weight.shape == (11, 32)
