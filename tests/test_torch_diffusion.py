"""The port's UNet28 DDPM main path against the JAX package, on the CPU.

Schedules, the noising process, one train step, the DDPM sampler, the data
pipeline and the checkpoint, each fed the same inputs in both packages
(made with numpy, or drawn by the JAX code and handed to the port through
its replay seams: the step's ``t``/``noise``, the sampler's ``x_init``/
``noise_stream``). Models are small (base width 8, time dim 32) and float32.
The last tests drive the port's ``run()`` end to end on the CPU.
"""

import dataclasses
import gzip
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinydiffusion_tpu.core import process as jax_process
from tinydiffusion_tpu.core.sampler import ddpm_denoising_trajectory as jax_trajectory
from tinydiffusion_tpu.core.sampler import ddpm_sample as jax_ddpm_sample
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.data.loader import BatchIterator as JaxBatchIterator
from tinydiffusion_tpu.data.mnist import load_mnist_u8 as jax_load_mnist_u8
from tinydiffusion_tpu.experiments.common import make_sampler as jax_make_sampler
from tinydiffusion_tpu.experiments.diffusion import DiffusionConfig as JaxDiffusionConfig
from tinydiffusion_tpu.io.checkpoint import _flat_items, _load_weights_arrays
from tinydiffusion_tpu.io.checkpoint import save_weights as jax_save_weights
from tinydiffusion_tpu.models.unet28 import UNet28 as JaxUNet28
from tinydiffusion_tpu.train.trainer import _raw_step_fn
from tinydiffusion_tpu.train.trainer import create_train_state as jax_create_train_state
from tinydiffusion_torch.core import process
from tinydiffusion_torch.core.sampler import ddpm_sample
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.loader import BatchIterator
from tinydiffusion_torch.data.mnist import MNIST_SCALE, MNIST_SHIFT, load_mnist_u8
from tinydiffusion_torch.experiments import diffusion
from tinydiffusion_torch.experiments.common import (
    load_unet28,
    make_sampler,
    make_trajectory_sampler,
)
from tinydiffusion_torch.io.checkpoint import (
    bf16_bits_to_float32,
    float32_to_bf16_bits,
    restore_checkpoint,
    save_checkpoint,
)
from tinydiffusion_torch.io.from_jax import jax_variables, unet28_state_dict
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.train.trainer import create_train_state, make_train_step

SMALL = {"time_dim": 32, "base_width": 8}
TO_NHWC, TO_NCHW = (0, 2, 3, 1), (0, 3, 1, 2)
# Tables. Linear betas within 1 float32 ulp (torch's and JAX's linspace
# round differently); cosine betas, 1 - abar_t/abar_{t-1}, cancel down to a
# few ulp at 1, where the two frameworks' cos differ by one. alphas =
# 1 - betas then within 1 ulp at 1. JAX's cumprod on the CPU is a parallel
# prefix scan; it sits ~2.2e-7 from the float64 product of the same alphas,
# the port's sequential float32 product within 1e-7 of it.
BETA_ATOL = {"linear": 2e-9, "cosine": 4e-7}
ALPHA_ATOL, CUMPROD_ATOL, CUMPROD_VS_JAX_ATOL = 6e-8, 1e-7, 5e-7
# The noising algebra: the same float32 products and sum.
PROCESS_ATOL = 1e-6
# One train step, float32: summation order in convs and reductions. The BN
# statistics of the last decoder stage, 15 layers deep, agree to ~1.4e-5
# relative. Under torch's unbiased running variance the bottleneck's
# (N = 8 * 4 * 4) would be off by 0.1 * var / (N - 1): 2.4e-4 relative
# here, 8 times the bound.
LOSS_RTOL, PARAM_ATOL, STATS_RTOL, STATS_ATOL = 1e-5, 1e-5, 3e-5, 1e-6
# A 20-step chain of a small UNet, float32.
CHAIN_ATOL = 1e-4
LR = 0.1
BATCH = 8


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(TO_NCHW)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy().transpose(TO_NHWC)


def _small_pair(seed: int = 0):
    """A JAX UNet28 init at small width, and the port's copy of it."""
    jmodel = JaxUNet28(**SMALL, dtype=jnp.float32)
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,), jnp.int32)))()
    flat, _ = _flat_items(variables)
    model = UNet28(**SMALL)
    model.load_state_dict(unet28_state_dict({k: np.asarray(v) for k, v in flat.items()}))
    return jmodel, variables, model


# --- schedule and process ---------------------------------------------------


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_schedule_tables_match_jax(name):
    ours, theirs = DiffusionSchedule.make(name, 1000), JaxSchedule.make(name, 1000)
    np.testing.assert_allclose(ours.betas.numpy(), np.asarray(theirs.betas),
                               atol=BETA_ATOL[name], rtol=0)
    np.testing.assert_allclose(ours.alphas.numpy(), 1.0 - ours.betas.numpy(), atol=0, rtol=0)
    if name == "linear":
        np.testing.assert_allclose(ours.alphas.numpy(), np.asarray(theirs.alphas),
                                   atol=ALPHA_ATOL, rtol=0)
    exact = np.cumprod(ours.alphas.double().numpy())
    np.testing.assert_allclose(ours.alphas_cumprod.numpy(), exact, atol=CUMPROD_ATOL, rtol=0)
    np.testing.assert_allclose(ours.alphas_cumprod.numpy(), np.asarray(theirs.alphas_cumprod),
                               atol=CUMPROD_VS_JAX_ATOL, rtol=0)
    # The derived tables are JAX's functions of the port's base tables.
    same = JaxSchedule(*(jnp.asarray(getattr(ours, name).numpy())
                         for name in ("betas", "alphas", "alphas_cumprod")), num_timesteps=1000)
    for table in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                  "reciprocal_sqrt_alphas", "sqrt_betas"):
        np.testing.assert_allclose(getattr(ours, table).numpy(), np.asarray(getattr(same, table)),
                                   atol=0, rtol=2e-7, err_msg=table)
    assert ours.num_timesteps == theirs.num_timesteps == 1000


def _same_tables(jax_schedule) -> DiffusionSchedule:
    """The port's schedule holding JAX's own tables, so that a comparison of
    what uses them does not also compare the two cumulative products."""
    return DiffusionSchedule(*(torch.from_numpy(np.array(getattr(jax_schedule, name)))
                               for name in ("betas", "alphas", "alphas_cumprod")))


def test_unknown_schedule_is_refused():
    with pytest.raises(ValueError, match="linear"):
        DiffusionSchedule.make("quadratic")


def test_process_matches_jax():
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (4, 28, 28, 1)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 10, 500, 999])
    theirs = JaxSchedule.linear(1000)
    ours = _same_tables(theirs)
    tt = torch.from_numpy(t)
    xt = process.q_sample_with_noise(ours, nchw(x0), tt, nchw(noise))
    want = jax_process.q_sample_with_noise(theirs, x0, t, noise)
    np.testing.assert_allclose(nhwc(xt), np.asarray(want), atol=PROCESS_ATOL, rtol=0)
    v = process.v_from_eps(ours, nchw(x0), nchw(noise), tt)
    np.testing.assert_allclose(nhwc(v), np.asarray(jax_process.v_from_eps(theirs, x0, noise, t)),
                               atol=PROCESS_ATOL, rtol=0)
    eps = process.eps_from_v(ours, xt, v, tt)
    np.testing.assert_allclose(
        nhwc(eps), np.asarray(jax_process.eps_from_v(theirs, np.asarray(want), np.asarray(
            jax_process.v_from_eps(theirs, x0, noise, t)), t)), atol=PROCESS_ATOL, rtol=0)
    np.testing.assert_allclose(nhwc(eps), noise, atol=1e-5)  # the inverse of v_from_eps


def test_q_sample_draws_from_the_generator():
    sched = DiffusionSchedule.linear(1000)
    x0, t = torch.zeros(2, 1, 4, 4), torch.tensor([3, 7])
    a = process.q_sample(sched, x0, t, torch.Generator().manual_seed(1))
    b = process.q_sample(sched, x0, t, torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], process.q_sample_with_noise(sched, x0, t, a[1]))


# --- the train step -----------------------------------------------------------


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_train_step_matches_jax(prediction):
    """One SGD step with an EMA at B = 8: the port gets the t and noise that
    the JAX step draws from its state's key, through its (t, noise) seam."""
    jmodel = JaxUNet28(**SMALL, dtype=jnp.float32)
    tx = optax.sgd(LR)
    example = (jnp.zeros((BATCH, 28, 28, 1)), jnp.zeros((BATCH,), jnp.int32))
    jstate = jax_create_train_state(jmodel, tx, example, jax.random.PRNGKey(0), ema=True)
    x0 = np.random.default_rng(1).uniform(-1, 1, (BATCH, 28, 28, 1)).astype(np.float32)
    _, t_key, noise_key, _ = jax.random.split(jstate.rng, 4)
    t = np.asarray(jax.random.randint(t_key, (BATCH,), 0, 1000))
    noise = np.asarray(jax.random.normal(noise_key, x0.shape))
    jschedule = JaxSchedule.linear(1000)
    jstep = jax.jit(_raw_step_fn(jmodel, tx, jschedule, ema_decay=0.9, prediction=prediction))
    new_jstate, jloss = jstep(jstate, jnp.asarray(x0))

    flat, _ = _flat_items({"params": jstate.params, "batch_stats": jstate.batch_stats})
    model = UNet28(**SMALL)
    model.load_state_dict(unet28_state_dict({k: np.asarray(v) for k, v in flat.items()}))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0, ema=True)
    step = make_train_step(_same_tables(jschedule), ema_decay=0.9, prediction=prediction)
    loss = step(state, nchw(x0), t=torch.from_numpy(t).long(), noise=nchw(noise))

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want, _ = _flat_items({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats,
                           "ema_params": new_jstate.ema_params})
    got = state.jax_weights()
    assert got.keys() == want.keys() | {"step"} and int(got["step"]) == 1
    for key, value in want.items():
        value = np.asarray(value)
        if key.endswith("/var"):
            np.testing.assert_allclose(got[key], value, rtol=STATS_RTOL, atol=0, err_msg=key)
        elif key.endswith("/mean"):
            np.testing.assert_allclose(got[key], value, rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=PARAM_ATOL, rtol=0, err_msg=key)
    moved = max((model.state_dict()[k] - v).abs().max().item() for k, v in before.items()
                if v.is_floating_point())
    assert moved > 1e-3  # the step changed the weights (and the test saw it)


def test_train_step_refuses_unknown_options():
    sched = DiffusionSchedule.linear(10)
    with pytest.raises(ValueError, match="prediction"):
        make_train_step(sched, prediction="x0")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make_train_step(sched, compute_dtype=torch.float16)
    model = UNet28(**SMALL)
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    with pytest.raises(ValueError, match="ema_params"):
        make_train_step(sched, ema_decay=0.9)(state, torch.zeros(2, 1, 28, 28))


def test_bfloat16_and_fused_steps_run_and_draw_their_own_noise():
    torch.manual_seed(0)
    model = UNet28(**SMALL)
    state = create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), 0)
    step = make_train_step(DiffusionSchedule.linear(1000), compute_dtype=torch.bfloat16)
    x0 = torch.rand(4, 1, 28, 28) * 2 - 1
    before = qsample.qsample_launches
    losses = [step(state, x0).item() for _ in range(2)]
    assert all(np.isfinite(losses)) and losses[0] != losses[1]
    assert state.step == 2 and qsample.qsample_launches == before  # the CPU runs no kernel


def test_the_step_draws_its_noise_with_the_fused_q_sample():
    """Without a noise argument the step draws t and then the fused
    q_sample's seed (a 0-d int64 tensor) from the state's generator, and
    noises x0 with ``q_sample_fused``: two steps given, through their seam,
    the t and the noise of ``q_sample_fused_reference`` at the seeds that a
    probe of that generator draws take the same losses and weights."""
    sched = DiffusionSchedule.linear(1000)
    x0 = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (4, 1, 28, 28))
                          .astype(np.float32))
    runs = []
    for replay in (False, True):
        torch.manual_seed(2)
        model = UNet28(**SMALL)
        state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 5)
        probe = torch.Generator().manual_seed(0)
        probe.set_state(state.generator.get_state())
        step = make_train_step(sched)
        losses = []
        for _ in range(2):
            if replay:
                t = torch.randint(0, 1000, (4,), generator=probe)
                seed = torch.randint(0, 2**31 - 1, (), generator=probe)
                noise = qsample.q_sample_fused_reference(sched, x0, t, int(seed))[1]
                losses.append(step(state, x0, t=t, noise=noise).item())
            else:
                losses.append(step(state, x0).item())
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0] and runs[0][0][0] != runs[0][0][1]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# --- the sampler --------------------------------------------------------------


def _replayed_draws(key, shape, n_steps):
    """The normals JAX's key-driven DDPM chain draws: split off the init key,
    then one split per step."""
    key, init_key = jax.random.split(key)
    x = jax.random.normal(init_key, shape)
    zs = []
    for _ in range(n_steps):
        key, step_key = jax.random.split(key)
        zs.append(jax.random.normal(step_key, shape))
    return np.asarray(x), np.stack([np.asarray(z) for z in zs])


def test_ddpm_chain_with_replayed_noise_matches_jax():
    jmodel, variables, model = _small_pair()
    rng = np.random.default_rng(2)
    shape = (2, 28, 28, 1)
    x_init = rng.standard_normal(shape).astype(np.float32)
    stream = rng.standard_normal((20,) + shape).astype(np.float32)
    want = jax.jit(lambda v: jax_ddpm_sample(
        lambda x, t: jmodel.apply(v, x, t, train=False), JaxSchedule.linear(20), shape,
        jax.random.PRNGKey(0), x_init=jnp.asarray(x_init), noise_stream=jnp.asarray(stream)))(
        variables)
    model.eval()
    got = ddpm_sample(lambda x, t: model(x, t), _same_tables(JaxSchedule.linear(20)),
                      (2, 1, 28, 28),
                      x_init=nchw(x_init),
                      noise_stream=torch.from_numpy(stream.transpose(0, 1, 4, 2, 3).copy()))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=CHAIN_ATOL, rtol=0)


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_make_sampler_matches_jax(prediction):
    """JAX's key-driven sampler, against the port's fed the same draws."""
    jmodel, variables, model = _small_pair(seed=3)
    shape, key = (2, 28, 28, 1), jax.random.PRNGKey(4)
    want = jax_make_sampler(jmodel, JaxSchedule.linear(20), shape, prediction=prediction)(
        variables["params"], variables["batch_stats"], key)
    x_init, stream = _replayed_draws(key, shape, 20)
    model.train()  # the sampler puts the model in eval mode and back
    got = make_sampler(model, DiffusionSchedule.linear(20), (2, 1, 28, 28),
                       prediction=prediction)(
        x_init=nchw(x_init), noise_stream=torch.from_numpy(stream.transpose(0, 1, 4, 2, 3).copy()))
    assert model.training
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=CHAIN_ATOL, rtol=0)


def test_trajectory_matches_jax():
    jmodel, variables, model = _small_pair(seed=5)
    shape, key = (4, 28, 28, 1), jax.random.PRNGKey(6)
    want = jax.jit(lambda v: jax_trajectory(
        lambda x, t: jmodel.apply(v, x, t, train=False), JaxSchedule.linear(20), shape, key,
        stride=5))(variables)
    x_init, stream = _replayed_draws(key, shape, 4)
    got = make_trajectory_sampler(model, DiffusionSchedule.linear(20), (4, 1, 28, 28), stride=5)(
        x_init=nchw(x_init), noise_stream=torch.from_numpy(stream.transpose(0, 1, 4, 2, 3).copy()))
    assert got.shape == (4, 4, 1, 28, 28)
    np.testing.assert_allclose(got.numpy().transpose(0, 1, 3, 4, 2), np.asarray(want),
                               atol=CHAIN_ATOL, rtol=0)


def test_sampler_draws_from_its_generator_and_checks_labels():
    model = UNet28(**SMALL)
    sampler = make_sampler(model, DiffusionSchedule.linear(5), (2, 1, 28, 28))
    a = sampler(torch.Generator().manual_seed(0))
    b = sampler(torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="generator"):
        sampler()
    cond = make_sampler(UNet28(**SMALL, num_classes=10), DiffusionSchedule.linear(5),
                        (2, 1, 28, 28), conditional=True)
    with pytest.raises(ValueError, match="labels"):
        cond(torch.Generator())
    assert cond(torch.Generator(), y=torch.tensor([1, 2])).shape == (2, 1, 28, 28)


# --- data ---------------------------------------------------------------------


def test_synthetic_mnist_bytes_equal_jax(tmp_path):
    ours = load_mnist_u8(str(tmp_path / "port"), synthetic_n=512)
    theirs = jax_load_mnist_u8(str(tmp_path / "jax"), synthetic_n=512)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape == (512, 28, 28, 1)
    cached = load_mnist_u8(str(tmp_path / "port"), synthetic_n=512)  # from the cache file
    np.testing.assert_array_equal(cached[0], ours[0])
    assert os.listdir(tmp_path / "port") == ["synthetic_mnist_train_512.npz"]


def _write_idx(path, array: np.ndarray) -> None:
    header = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(f">{array.ndim}I", *array.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


def _idx_data_root(root, n: int = 64) -> str:
    images, labels = load_mnist_u8(str(root / "synth"), synthetic_n=n)
    os.makedirs(root / "idx", exist_ok=True)
    _write_idx(root / "idx" / "train-images-idx3-ubyte.gz", images[..., 0])
    _write_idx(root / "idx" / "train-labels-idx1-ubyte.gz", labels)
    return str(root / "idx")


def test_idx_files_win_over_the_synthetic_set(tmp_path):
    root = _idx_data_root(tmp_path)
    ours, theirs = load_mnist_u8(root), jax_load_mnist_u8(root)
    assert ours[0].shape == (64, 28, 28, 1)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_batch_iterator_matches_jax():
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (100, 28, 28, 1)).astype(np.uint8)
    labels = rng.integers(0, 10, 100).astype(np.int32)
    ours = BatchIterator([images, labels], 16, shuffle=True, seed=3,
                         u8_normalize=(MNIST_SCALE, MNIST_SHIFT))
    theirs = JaxBatchIterator([images, labels], 16, shuffle=True, seed=3,
                              u8_normalize=(MNIST_SCALE, MNIST_SHIFT), device_normalize=True)
    assert len(ours) == len(theirs) == 6
    transform = theirs.device_transform
    for epoch in (0, 1):
        pairs = list(zip(ours.epoch(epoch), theirs.epoch(epoch), strict=True))
        for a, b in pairs:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        x_dev, y_dev = ours.to_device(pairs[0][0], torch.device("cpu"))
        jx, jy = transform(pairs[0][1])
        assert x_dev.dtype == torch.float32 and y_dev.dtype == torch.int32
        # One float32 ulp at 1: XLA fuses the multiply and the add.
        np.testing.assert_allclose(x_dev.numpy(), np.asarray(jx), atol=1.2e-7, rtol=0)
        np.testing.assert_array_equal(y_dev.numpy(), np.asarray(jy))
    first = [b[0] for b in ours.epoch(0)]
    assert not np.array_equal(first[0], next(iter(ours.epoch(1)))[0])


# --- checkpoints ----------------------------------------------------------------


def test_bf16_encoding_matches_ml_dtypes():
    import ml_dtypes

    rng = np.random.default_rng(8)
    values = np.concatenate([
        rng.standard_normal(10_000).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 10_000),
        # exact ties between two bfloat16s, with even and odd low bits
        (np.arange(2**16, 2**16 + 64, dtype=np.uint32) << 16 | 0x8000).view(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-40, 3.4028235e38, -3.4e38],
                 np.float32),
    ]).astype(np.float32)
    got = float32_to_bf16_bits(values)
    want = values.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got, want)
    nan = float32_to_bf16_bits(np.array([np.nan, -np.nan], np.float32))
    assert np.isnan(bf16_bits_to_float32(nan)).all()


def _trained_state(steps: int):
    torch.manual_seed(1)
    model = UNet28(**SMALL)
    state = create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), 7, ema=True)
    step = make_train_step(DiffusionSchedule.linear(1000), ema_decay=0.99)
    x0 = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (4, 1, 28, 28)).astype(np.float32))
    return state, step, x0, [step(state, x0).item() for _ in range(steps)]


def test_exported_npz_loads_in_jax_as_jax_save_weights_writes_it(tmp_path):
    state, *_ = _trained_state(2)
    save_checkpoint(str(tmp_path / "port"), state, config={"base_width": 8, "time_dim": 32})
    flat = state.jax_weights()  # float32 values, before the bf16 rounding
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    jax_save_weights(str(tmp_path / "jax"), tree)
    ours = _load_weights_arrays(str(tmp_path / "port"))
    theirs = _load_weights_arrays(str(tmp_path / "jax"))
    assert ours.keys() == theirs.keys()
    assert any(k.startswith("ema_params/") for k in ours) and int(ours["step"]) == 2
    for key, want in theirs.items():
        assert ours[key].dtype == want.dtype, key
        np.testing.assert_array_equal(np.atleast_1d(ours[key]).view(np.uint8),
                                      np.atleast_1d(want).view(np.uint8), err_msg=key)
    with open(tmp_path / "port.json") as f:
        assert json.load(f)["config"]["base_width"] == 8


def test_load_unet28_reads_a_port_checkpoint(tmp_path):
    state, *_ = _trained_state(1)
    save_checkpoint(str(tmp_path / "ckpt"), state, config={"base_width": 8, "time_dim": 32})
    model = load_unet28(str(tmp_path / "ckpt"), device="cpu")
    assert not model.training
    for name, value in model.state_dict().items():
        src = (state.ema_params[name] if name in state.ema_params
               else state.model.state_dict()[name])
        if name in state.ema_params:  # params travel as bfloat16, stats as float32
            src = torch.from_numpy(bf16_bits_to_float32(float32_to_bf16_bits(src.numpy())))
        torch.testing.assert_close(value, src, atol=0, rtol=0, msg=name)


def test_resume_continues_bit_identically(tmp_path):
    state, step, x0, _ = _trained_state(2)
    save_checkpoint(str(tmp_path / "mid"), state)
    straight = [step(state, x0).item() for _ in range(2)]
    resumed, step2, _, _ = _trained_state(0)
    restore_checkpoint(str(tmp_path / "mid"), resumed)
    assert resumed.step == 2
    again = [step2(resumed, x0).item() for _ in range(2)]
    assert again == straight
    for (name, a), b in zip(state.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert all(torch.equal(state.ema_params[n], resumed.ema_params[n]) for n in state.ema_params)


def test_a_state_dict_with_the_old_cpu_seed_generator_loads(tmp_path):
    """A ``.pt`` written when the seed came from a CPU generator holds its
    ``seed_generator`` state: it loads, that key ignored, and the resumed
    state continues as one restored from a current ``.pt``."""
    state, step, x0, _ = _trained_state(1)
    sd = state.state_dict()
    assert "seed_generator" not in sd
    old = dict(sd, seed_generator=torch.Generator().manual_seed(8).get_state())
    a, _, _, _ = _trained_state(0)
    b, _, _, _ = _trained_state(0)
    a.load_state_dict(old)
    b.load_state_dict(sd)
    assert a.restores == b.restores == 1 and a.step == b.step == 1
    assert step(a, x0).item() == step(b, x0).item()


def test_a_restore_keeps_the_optimizers_own_capturable(tmp_path):
    """The resident step on a card needs Adam built with ``capturable=True``;
    a ``.pt`` from the host path (or from before the resident path) says
    False in its param groups, and the other way round. A restore keeps the
    optimizer's own value either way, with the step count restored."""
    host, *_ = _trained_state(1)
    save_checkpoint(str(tmp_path / "host"), host)
    torch.manual_seed(1)
    model = UNet28(**SMALL)
    adam = torch.optim.Adam(model.parameters(), lr=1e-3, capturable=True)
    resident = create_train_state(model, adam, 7, ema=True)
    restore_checkpoint(str(tmp_path / "host"), resident)
    assert [g["capturable"] for g in adam.param_groups] == [True]
    assert adam.state and all(s["step"].item() == 1 for s in adam.state.values())
    save_checkpoint(str(tmp_path / "resident"), resident)
    again, *_ = _trained_state(0)
    restore_checkpoint(str(tmp_path / "resident"), again)
    assert [g["capturable"] for g in again.optimizer.param_groups] == [False]


# --- the entry point --------------------------------------------------------------


def test_config_takes_the_jax_flags():
    ours = {f.name: f.default for f in dataclasses.fields(diffusion.DiffusionConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxDiffusionConfig)}
    differ = {k for k in theirs if ours[k] != theirs[k]}
    assert differ == {"checkpoint_path"}  # the port's npz must not overwrite checkpoints/
    assert not ours["checkpoint_path"].startswith("checkpoints")
    assert set(ours) - set(theirs) == {"base_width", "device"}
    assert ours["device"] == "cuda"


def _small_config(tmp_path, **overrides) -> diffusion.DiffusionConfig:
    fields = dict(
        device="cpu", num_epochs=2, max_steps_per_epoch=3, batch_size=8, log_every=1,
        num_timesteps=100, n_samples=4, denoising_stride=25,
        data_root=_idx_data_root(tmp_path), out_dir=str(tmp_path / "out"),
        checkpoint_path=str(tmp_path / "ckpt" / "final"), **SMALL,
    )
    fields.update(overrides)
    return diffusion.DiffusionConfig(**fields)


def test_run_on_the_cpu_writes_grids_metrics_and_checkpoint(tmp_path):
    config = _small_config(tmp_path)
    before = qsample.qsample_launches
    result = diffusion.run(config)
    assert result["state"].step == 6 and qsample.qsample_launches == before
    assert len(result["losses"]) == 6 and all(np.isfinite(result["losses"]))
    assert [e["sample_seconds"] is not None for e in result["epochs"]] == [True, True]
    out = tmp_path / "out"
    for name in ["generated_mnist_epoch_0.png", "generated_mnist_epoch_1.png",
                 "denoising_t100.png", "denoising_t25.png"]:
        assert (out / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    with open(out / "diffusion" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert {"epoch", "batch", "loss", "step", "t"} <= records[0].keys()
    assert {"epoch", "train_samples_per_sec", "epoch_seconds"} <= records[-1].keys()
    assert json.loads((out / "diffusion" / "config.json").read_text())["base_width"] == 8
    for ext in (".pt", ".npz", ".json"):
        assert (tmp_path / "ckpt" / ("final" + ext)).stat().st_size > 0
    assert sorted(os.listdir(tmp_path)) == ["ckpt", "idx", "out", "synth"]


def test_main_parses_the_flags_and_device_placement_is_refused(tmp_path, capsys, monkeypatch):
    """The CLI takes the JAX flags; ``--data-placement device`` runs on the
    CPU (the resident step, eagerly); an unknown placement and a card that
    is asked for and absent are refused."""
    root = _idx_data_root(tmp_path)
    diffusion.main(["--device", "cpu", "--num-epochs", "1", "--max-steps-per-epoch", "1",
                    "--batch-size", "4", "--base-width", "8", "--time-dim", "32",
                    "--sample-every-epoch", "false", "--visualize-denoising", "false",
                    "--checkpoint-path", "", "--compute-dtype", "float32",
                    "--data-root", root, "--out-dir", str(tmp_path / "cli")])
    assert "device: cpu" in capsys.readouterr().out
    assert (tmp_path / "cli" / "diffusion" / "metrics.jsonl").exists()
    # The resident path runs on the CPU too (eagerly: no graphs there).
    diffusion.main(["--device", "cpu", "--num-epochs", "1", "--max-steps-per-epoch", "2",
                    "--batch-size", "4", "--base-width", "8", "--time-dim", "32",
                    "--sample-every-epoch", "false", "--visualize-denoising", "false",
                    "--checkpoint-path", "", "--compute-dtype", "float32",
                    "--data-placement", "device", "--log-every", "1",
                    "--data-root", root, "--out-dir", str(tmp_path / "resident")])
    with open(tmp_path / "resident" / "diffusion" / "metrics.jsonl") as f:
        batches = [r["batch"] for r in map(json.loads, f) if "loss" in r]
    assert batches == [0, 1]
    with pytest.raises(ValueError, match="data_placement"):
        diffusion.run(_small_config(tmp_path, data_placement="hbm"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        diffusion.run(_small_config(tmp_path, device="cuda"))
