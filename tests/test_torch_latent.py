"""The port's latent diffusion (MLP UNet and DiT) against the JAX package, on the CPU.

``models/mlp_unet.py`` and ``models/dit.py`` on the committed
``checkpoints/latent_diffusion_best`` and ``diffusion_transformer_best``
(float32 and bfloat16 forwards), the DiT's dropout (flax's broadcast
attention mask, masks injected), the bfloat16 ``t / 1000``, the latent train
step through its ``(z_eps, t, noise)`` seam against JAX's
``split(state.rng, 5)`` draws, the latent validation step, the DiT's
per-epoch cosine learning rate against optax, the resident latent step, and
``experiments/latent_diffusion.py::run`` on both paths.
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

from tests.test_torch_diffusion import _idx_data_root, _same_tables, _write_idx
from tinydiffusion_tpu.core import process as jax_process
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.experiments import latent_diffusion as jax_latent
from tinydiffusion_tpu.io.checkpoint import _flat_items, restore_weights
from tinydiffusion_tpu.models.dit import DiT as JaxDiT
from tinydiffusion_tpu.models.mlp_unet import MLPUNetLatent as JaxMLPUNet
from tinydiffusion_tpu.models.vae_mnist import VAEMnist as JaxVAEMnist
from tinydiffusion_tpu.nn.layers import TimeEmbedMLP as JaxTimeEmbedMLP
from tinydiffusion_tpu.train.trainer import DiffusionTrainState as JaxTrainState
from tinydiffusion_tpu.train.trainer import _raw_latent_step_fn
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.data.mnist import load_mnist_u8
from tinydiffusion_torch.experiments import diffusion_transformer, latent_diffusion, vae
from tinydiffusion_torch.experiments.common import load_latent_checkpoint
from tinydiffusion_torch.io.checkpoint import (
    load_sidecar,
    load_weights_arrays,
    restore_checkpoint,
    save_checkpoint,
)
from tinydiffusion_torch.io.from_jax import dit_state_dict, jax_variables, state_dict_by_name
from tinydiffusion_torch.models.dit import DiT
from tinydiffusion_torch.models.mlp_unet import MLPUNetLatent
from tinydiffusion_torch.nn.layers import TimeEmbedMLP, computing_in
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.train.trainer import (
    create_train_state,
    make_latent_eval_step,
    make_latent_train_step,
    make_resident_latent_multi_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {
    "mlp_unet": os.path.join(REPO, "checkpoints", "latent_diffusion_best"),
    "dit": os.path.join(REPO, "checkpoints", "diffusion_transformer_best"),
}
VAE_CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_mnist_best")
# float32 eps of the full-width denoisers on the committed weights:
# summation order over up to 1024 terms a layer, outputs of order 1.
F32_ATOL, F32_RTOL = 1e-5, 1e-5
# bfloat16, relative to the largest |eps| (~4): the port rounds where flax's
# code rounds (``nn.layers``), so against JAX run eagerly it differs in
# under 1 % of 32 inputs' outputs, by a mean of 3-5e-6 and at most 0.08-0.1 %
# (seen on the CPU; under autocast 0.07-0.08 % and 0.41-0.68 %). JAX's
# jitted forward rounds some ops elsewhere (XLA's fusions) and lies
# 0.08 % / 0.56-0.68 % from its own eager one; against it the old bounds.
BF16_MEAN_REL, BF16_MAX_REL = 2e-5, 3e-3
BF16_JIT_MEAN_REL, BF16_JIT_MAX_REL = 0.003, 0.02
# One SGD step (lr 0.1) at B = 16, float32: loss 1e-5 relative, params
# 1e-5; the MLP UNet's BN running statistics 1e-4 relative (flax's batch
# variance is E[x^2] - E[x]^2, the port's two-pass).
STEP_LOSS_RTOL, STEP_PARAM_ATOL, STATS_RTOL, STATS_ATOL = 1e-5, 1e-5, 1e-4, 1e-6
BATCH, LR = 16, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops; the suite runs several workers on a few cores. One torch
    thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(backbone: str, dtype=jnp.float32, **options):
    cls = JaxDiT if backbone == "dit" else JaxMLPUNet
    return cls(time_dim=256, num_classes=10, latent_dim=20, dtype=dtype, **options)


def _jax_variables(backbone: str, jmodel) -> dict:
    """The committed weights in ``jmodel``'s tree (``params`` and, for the
    MLP UNet, ``batch_stats``)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 20)), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2,), jnp.int32)))
    return restore_weights(CHECKPOINTS[backbone], dict(shapes))


def _port_model(backbone: str, **options):
    model = (DiT(**options) if backbone == "dit" else MLPUNetLatent(**options))
    model.load_state_dict(state_dict_by_name(load_weights_arrays(CHECKPOINTS[backbone])))
    return model


def _inputs(seed: int, n: int = 8):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 20)).astype(np.float32)
    t = rng.integers(0, 1000, n).astype(np.int32)
    t[:2] = (0, 999)
    y = rng.integers(0, 10, n).astype(np.int32)
    return z, t, y


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)).long() if a.dtype.kind == "i"
            else torch.from_numpy(np.array(a)) for a in arrays]


# --- the denoisers ----------------------------------------------------------------


@pytest.mark.parametrize("backbone, n_keys", [("mlp_unet", 93), ("dit", 76)])
def test_bridge_fills_every_slot_and_inverts(backbone, n_keys):
    flat = load_weights_arrays(CHECKPOINTS[backbone])
    assert len(flat) == n_keys + 1 and "step" in flat
    sd = state_dict_by_name(flat)
    model = DiT() if backbone == "dit" else MLPUNetLatent()
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == {
        k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd)  # strict
    back = jax_variables(model)
    assert back.keys() == {k for k in flat if k != "step"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    if backbone == "dit":  # flax's (in, heads, head_dim) layout, flattened
        kernel = flat["params/block0/attention/query/kernel"]
        assert kernel.shape == (256, 4, 64)
        np.testing.assert_array_equal(model.block0.attention.query.weight.detach().numpy(),
                                      kernel.reshape(256, 256).T)


@pytest.mark.parametrize("backbone", ["mlp_unet", "dit"])
def test_eval_forward_matches_jax_in_float32(backbone):
    jmodel = _jax_model(backbone)
    variables = _jax_variables(backbone, jmodel)
    z, t, y = _inputs(0)
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, z, t, y, train=False))(variables))
    model = _port_model(backbone).eval()
    with torch.no_grad():
        got = model(*_torch(z, t, y))
    assert got.dtype == torch.float32 and got.shape == (8, 20)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("backbone", ["mlp_unet", "dit"])
def test_eval_forward_matches_jax_in_bfloat16(backbone):
    """JAX's model dtype bfloat16 against the port's (``computing_in``), run
    eagerly and jitted."""
    jmodel = _jax_model(backbone, dtype=jnp.bfloat16)
    variables = _jax_variables(backbone, jmodel)
    z, t, y = _inputs(1, n=32)
    model = _port_model(backbone).eval()
    with torch.no_grad(), computing_in(model, torch.bfloat16):
        got = model(*_torch(z, t, y)).numpy()
    jitted = np.asarray(jax.jit(lambda v: jmodel.apply(v, z, t, y, train=False))(variables))
    eager = np.asarray(jmodel.apply(variables, z, t, y, train=False))
    scale = np.abs(jitted).max()
    for name, want, mean_rel, max_rel in (("eager", eager, BF16_MEAN_REL, BF16_MAX_REL),
                                          ("jit", jitted, BF16_JIT_MEAN_REL, BF16_JIT_MAX_REL)):
        diff = np.abs(got - want)
        print(f"{backbone} bf16 eval vs JAX {name}: mean {diff.mean() / scale:.3e}, "
              f"max {diff.max() / scale:.3e} of max|eps|")
        assert diff.mean() <= mean_rel * scale, (name, diff.mean(), scale)
        assert diff.max() <= max_rel * scale, (name, diff.max(), scale)


def test_bf16_time_embedding_rounds_t_before_dividing():
    """JAX casts t to the model dtype and then divides: in bfloat16, t = 999
    rounds to 1000 and enters as exactly 1.0. The port in bfloat16 does
    the same at every timestep; dividing in float32 and rounding afterwards
    would differ at 190 of the 1000 (t = 257, 261, ...)."""
    jmlp = JaxTimeEmbedMLP(16, normalize=1000.0, dtype=jnp.bfloat16)
    t = np.arange(1000, dtype=np.int32)
    variables = jmlp.init(jax.random.PRNGKey(0), t)
    mlp = TimeEmbedMLP(16, normalize=1000.0)
    flat, _ = _flat_items(variables)
    mlp.load_state_dict(state_dict_by_name({k: np.asarray(v) for k, v in flat.items()}))
    seen = []
    mlp.fc1.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    with torch.no_grad(), computing_in(mlp, torch.bfloat16):
        got = mlp(torch.from_numpy(t).long())
    assert seen[0].dtype == torch.bfloat16 and seen[0][999, 0].item() == 1.0
    want_in = np.asarray(jnp.asarray(t).astype(jnp.bfloat16) / 1000.0, np.float32)
    np.testing.assert_array_equal(seen[0][:, 0].float().numpy(), want_in)
    want = np.asarray(jmlp.apply(variables, t), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.02 * np.abs(want).max())


# --- the DiT's dropout ------------------------------------------------------------


def _record_jax_masks(monkeypatch, jmodel, variables, z, t, y, key):
    """JAX's train-mode output and, in call order, the keep masks its
    dropouts drew: per block, the attention weights', the attention
    output's and the feed-forward's."""
    drawn = []
    bernoulli = jax.random.bernoulli

    def record(*args, **kwargs):
        keep = bernoulli(*args, **kwargs)
        drawn.append(np.asarray(keep))
        return keep

    monkeypatch.setattr(jax.random, "bernoulli", record)
    out = jmodel.apply(variables, z, t, y, train=True, rngs={"dropout": key})  # eager
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return np.asarray(out), [tuple(torch.from_numpy(m) for m in drawn[i:i + 3])
                             for i in range(0, len(drawn), 3)]


def test_dit_dropout_matches_jax_with_its_masks(monkeypatch):
    """The committed DiT at dropout 0.5 in train mode: flax draws ONE (1, 1,
    1, 1) attention mask per layer for the whole batch (broadcast_dropout),
    and (B, 1, 256) masks for the two residual dropouts; handed those
    masks, the port gives JAX's output."""
    jmodel = _jax_model("dit", dropout=0.5)
    variables = _jax_variables("dit", jmodel)
    z, t, y = _inputs(2)
    want, masks = _record_jax_masks(monkeypatch, jmodel, variables, z, t, y,
                                    jax.random.PRNGKey(4))
    assert len(masks) == 4
    assert [tuple(m.shape) for m in masks[0]] == [(1, 1, 1, 1), (8, 1, 256), (8, 1, 256)]
    dropped_attention = [not bool(m[0].all()) for m in masks]
    assert any(dropped_attention) and not all(dropped_attention)  # both branches
    model = _port_model("dit", dropout=0.5).train()
    with torch.no_grad():
        got = model(*_torch(z, t, y), dropout_masks=masks)
        kept_all = model(*_torch(z, t, y), dropout_masks=[
            tuple(torch.ones_like(m) for m in block) for block in masks])
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=F32_RTOL)
    assert np.abs(kept_all.numpy() - want).max() > 0.1  # the masks matter


def test_dit_dropout_over_tokens_matches_jax(monkeypatch):
    """A small random DiT of 4 tokens (S = 4): the attention mask is (1, 1,
    4, 4), one for the batch, and masks single weights."""
    options = dict(time_dim=32, num_classes=10, latent_dim=20, num_heads=4, num_layers=2,
                   dropout=0.3, num_tokens=4)
    jmodel = JaxDiT(dtype=jnp.float32, **options)
    z, t, y = _inputs(3)
    variables = jmodel.init(jax.random.PRNGKey(5), z, t, y)
    want, masks = _record_jax_masks(monkeypatch, jmodel, variables, z, t, y,
                                    jax.random.PRNGKey(6))
    assert [tuple(m.shape) for m in masks[0]] == [(1, 1, 4, 4), (8, 4, 32), (8, 4, 32)]
    model = DiT(**options).train()
    flat, _ = _flat_items(variables)
    model.load_state_dict(dit_state_dict({k: np.asarray(v) for k, v in flat.items()}))
    with torch.no_grad():
        got = model(*_torch(z, t, y), dropout_masks=masks)
        model.eval()
        eval_out = model(*_torch(z, t, y))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=F32_RTOL)
    jeval = np.asarray(jmodel.apply(variables, z, t, y, train=False))
    np.testing.assert_allclose(eval_out.numpy(), jeval, atol=F32_ATOL, rtol=F32_RTOL)


def test_dit_draws_its_masks_from_the_given_generator():
    model = DiT(time_dim=32, num_layers=3, dropout=0.25, num_tokens=2)
    masks = model.draw_dropout_masks(64, torch.Generator().manual_seed(0))
    again = model.draw_dropout_masks(64, torch.Generator().manual_seed(0))
    assert len(masks) == 3
    assert [tuple(m.shape) for m in masks[0]] == [(1, 1, 2, 2), (64, 2, 32), (64, 2, 32)]
    assert all(torch.equal(a, b) for x, y in zip(masks, again) for a, b in zip(x, y))
    kept = torch.cat([m.flatten().float() for block in masks for m in block[1:]]).mean()
    assert abs(kept.item() - 0.75) < 0.02
    assert DiT(dropout=0.0).draw_dropout_masks(4, torch.Generator()) is None
    z, t, y = _torch(*_inputs(4))
    with pytest.raises(ValueError, match="dropout_masks"):
        model.train()(z, t, y)


# --- the train step ---------------------------------------------------------------


def _vae_pair():
    jvae = JaxVAEMnist()
    template = jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), jax.random.PRNGKey(0)))["params"]
    jparams = restore_weights(VAE_CHECKPOINT, {"params": template})["params"]
    vae, _ = latent_diffusion.load_vae(
        latent_diffusion.LatentDiffusionConfig(vae_checkpoint=VAE_CHECKPOINT), device="cpu")
    return jvae, jparams, vae


def _images(seed: int, n: int = BATCH):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 256, (n, 28, 28, 1)) * (2.0 / 255.0) - 1.0).astype(np.float32)
    return x, rng.integers(0, 10, n).astype(np.int32)


@pytest.mark.parametrize("backbone", ["mlp_unet", "dit"])
def test_latent_step_matches_jax(backbone):
    """One SGD step from the committed weights (the DiT at dropout 0): the
    port gets the reparameterising noise, t and the noise that JAX's step
    draws from ``split(state.rng, 5)``; the loss, the params and the MLP
    UNet's train-mode BatchNorm statistics after the step."""
    jvae, jvae_params, vae = _vae_pair()
    options = {"dropout": 0.0} if backbone == "dit" else {}
    jmodel = _jax_model(backbone, **options)
    variables = _jax_variables(backbone, jmodel)
    tx = optax.sgd(LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables.get("batch_stats", {}),
                           opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(7))
    x0, y = _images(8)
    jschedule = JaxSchedule.linear(1000)
    _, z_key, t_key, noise_key, _ = jax.random.split(jstate.rng, 5)
    z_eps = np.array(jax.random.normal(z_key, (BATCH, 20)))
    t = np.array(jax.random.randint(t_key, (BATCH,), 0, 1000))
    noise = np.array(jax.random.normal(noise_key, (BATCH, 20)))
    jstep = jax.jit(_raw_latent_step_fn(jvae, jmodel, tx, jschedule))
    new_jstate, jloss = jstep(jstate, jvae_params, jnp.asarray(x0), jnp.asarray(y))

    model = _port_model(backbone, **options)
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    step = make_latent_train_step(vae, _same_tables(jschedule))
    x0_t, y_t, z_eps_t, t_t, noise_t = _torch(x0, y, z_eps, t, noise)
    loss = step(state, x0_t.permute(0, 3, 1, 2), y_t, z_eps=z_eps_t, t=t_t, noise=noise_t)
    assert state.step == 1 and model.training
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=STEP_LOSS_RTOL)
    want, _ = _flat_items({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats})
    got = state.jax_weights()
    assert {k for k in got if k != "step"} == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got[key], value, rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=STEP_PARAM_ATOL, rtol=0,
                                       err_msg=key)
    if backbone == "mlp_unet":
        before = load_weights_arrays(CHECKPOINTS[backbone])["batch_stats/enc1/block1/bn/mean"]
        assert np.abs(got["batch_stats/enc1/block1/bn/mean"] - before).max() > 1e-3


def test_latent_eval_step_matches_jax_on_its_draws():
    """The validation step: the reparameterising noise, t and the q_sample
    seed come, in JAX's split order, from the batch's key; JAX's eval math on
    those draws gives the same loss."""
    jvae, jvae_params, vae = _vae_pair()
    jmodel = _jax_model("mlp_unet")
    variables = _jax_variables("mlp_unet", jmodel)
    x0, y = _images(9)
    key = (11, 3 * 10000 + 2)
    rng = np.random.default_rng(list(key))
    z_eps = rng.standard_normal((BATCH, 20), np.float32)
    t = rng.integers(0, 1000, BATCH)
    seed = int(rng.integers(0, 2**63))
    schedule = DiffusionSchedule.linear(1000)
    noise = qsample.q_sample_fused_reference(schedule, torch.zeros(BATCH, 20),
                                             torch.from_numpy(t), seed)[1].numpy()
    jschedule = JaxSchedule.linear(1000)
    mu, logvar = jvae.apply({"params": jvae_params}, x0, method=JaxVAEMnist.encode)
    z0 = mu + z_eps * jnp.exp(0.5 * logvar)
    z_t = jax_process.q_sample_with_noise(jschedule, z0, jnp.asarray(t), noise)
    out = jmodel.apply(variables, z_t, jnp.asarray(t), y, train=False)
    want = float(jnp.mean((out - noise) ** 2))
    model = _port_model("mlp_unet").train()
    eval_step = make_latent_eval_step(vae, _same_tables(jschedule))
    got = eval_step(model, torch.from_numpy(x0).permute(0, 3, 1, 2), key,
                    torch.from_numpy(y).long())
    assert model.training  # eval mode only inside the step
    np.testing.assert_allclose(got.item(), want, rtol=STEP_LOSS_RTOL)


def test_resident_latent_steps_match_host_steps():
    """K = 3 resident DiT steps (dropout 0.05) with their own draws against
    host steps on the gathered batches given the same draws, replayed from a
    probe of the state's generator in the step's order: the reparameterising
    noise, t, the q_sample seed, the dropout masks. The same losses and
    weights, to the bit."""
    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, (24, 28, 28, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, 24).astype(np.int32)
    ds = DeviceDataset(images, 8, seed=2, device="cpu", labels=labels)
    _, _, vae = _vae_pair()
    schedule = DiffusionSchedule.linear(1000)
    idxs = ds.epoch_index_batches(0)[:3]
    runs = []
    for resident in (True, False):
        torch.manual_seed(5)
        model = DiT(time_dim=32, num_layers=2)
        state = create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), 6,
                                   ema=True)
        if resident:
            step = make_resident_latent_multi_step(vae, schedule, ds, ema_decay=0.9)
            before = qsample.qsample_launches
            losses = step(state, idxs).tolist()
            assert qsample.qsample_launches == before and step.counts["eager"] == 3
        else:
            probe = torch.Generator().manual_seed(0)
            probe.set_state(state.generator.get_state())
            step = make_latent_train_step(vae, schedule, ema_decay=0.9)
            losses = []
            for row in idxs:
                x0, y = ds.gather(torch.from_numpy(row))
                z_eps = torch.randn(8, 20, generator=probe)
                t = torch.randint(0, 1000, (8,), generator=probe)
                seed = torch.randint(0, 2**31 - 1, (), generator=probe)
                masks = model.draw_dropout_masks(8, probe)
                mu, logvar = vae.encode(x0)
                z0 = vae.reparameterize(mu, logvar, z_eps)
                noise = qsample.q_sample_fused_reference(schedule, z0, t, int(seed))[1]
                losses.append(step(state, x0, y, z_eps=z_eps, t=t, noise=noise,
                                   masks=masks).item())
        runs.append((losses, [p.detach().clone() for p in state.ema_params.values()]))
    assert runs[0][0] == runs[1][0] and len(set(runs[0][0])) == 3
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    with pytest.raises(ValueError, match="labels"):
        make_resident_latent_multi_step(vae, schedule, DeviceDataset(images, 8, device="cpu"))


def test_a_latent_state_resumes_exactly(tmp_path):
    """A DiT state (dropout on, Adam) saved after 2 latent steps and restored
    into a fresh one continues as the uninterrupted state does: the same
    draws from the restored generator, the same losses and weights."""
    _, _, vae = _vae_pair()
    step = make_latent_train_step(vae, DiffusionSchedule.linear(1000))
    x0, y = _torch(*_images(13, n=8))
    x0 = x0.permute(0, 3, 1, 2)

    def fresh():
        torch.manual_seed(3)
        model = DiT(time_dim=32, num_layers=2)
        return create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), 4)

    first = fresh()
    for _ in range(2):
        step(first, x0, y)
    save_checkpoint(str(tmp_path / "dit"), first, config={"backbone": "dit"})
    second = fresh()
    restore_checkpoint(str(tmp_path / "dit"), second)
    assert second.step == 2
    losses = [[step(s, x0, y).item() for _ in range(2)] for s in (first, second)]
    assert losses[0] == losses[1] and len(set(losses[0])) == 2
    for a, b in zip(first.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)


# --- the DiT recipe's learning rate ---------------------------------------------------


def test_dit_cosine_lr_per_epoch_matches_optax():
    """JAX's DiT recipe: adam(schedule(step // steps_per_epoch)) with
    cosine_decay_schedule(3e-4, num_epochs). The port sets each epoch's
    rate at its first step; Adam over 3 epochs of 4 steps on the same
    gradients lands where optax's does."""
    epochs = 3
    spe = latent_diffusion.steps_per_epoch_from_split(48000, 128, 4)
    assert spe == jax_latent.steps_per_epoch_from_split(48000, 128, 4) == 4
    assert latent_diffusion.steps_per_epoch_from_split(48000, 128) == 375
    schedule = optax.cosine_decay_schedule(3e-4, epochs)
    ours = latent_diffusion.cosine_decay(latent_diffusion.DIT_LR, epochs)
    for step in range(epochs * spe + 3):
        np.testing.assert_allclose(ours(step // spe), float(schedule(step // spe)), rtol=1e-6)
    assert ours(1) == pytest.approx(3e-4 * 0.5 * (1 + np.cos(np.pi / 3)))

    grads = np.random.default_rng(12).standard_normal((epochs * spe, 5)).astype(np.float32)
    tx = optax.adam(lambda step: schedule(step // spe))
    w = jnp.ones(5)
    opt_state = tx.init(w)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, w)
        w = optax.apply_updates(w, updates)
    p = torch.nn.Parameter(torch.ones(5))
    adam = torch.optim.Adam([p], lr=1.0)
    for i, g in enumerate(grads):
        if i % spe == 0:
            latent_diffusion.set_lr(adam, ours(i // spe))
        p.grad = torch.from_numpy(g)
        adam.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-7, rtol=0)


# --- the entry point ----------------------------------------------------------------


def test_config_takes_the_jax_flags():
    """JAX's fields and defaults, plus ``device``; the port's paths under
    ``runs/``: the denoiser's, and the VAE its own stage A writes there."""
    ours = {f.name: f.default for f in dataclasses.fields(latent_diffusion.LatentDiffusionConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jax_latent.LatentDiffusionConfig)}
    assert {k for k in theirs if ours[k] != theirs[k]} == {"model_save_path", "vae_checkpoint"}
    assert not ours["model_save_path"].startswith("checkpoints")
    assert ours["vae_checkpoint"] == f"{vae.VAEExperimentConfig().checkpoint_dir}/vae_mnist_best"
    assert set(ours) - set(theirs) == {"device"}


def _idx_train_and_test(root) -> str:
    """Small IDX train and test splits (48 and 16 synthetic digits) under ``root / "idx"``."""
    for train, n, name in ((True, 48, "train"), (False, 16, "t10k")):
        images, labels = load_mnist_u8(str(root / "synth"), train=train, synthetic_n=n)
        os.makedirs(root / "idx", exist_ok=True)
        _write_idx(root / "idx" / f"{name}-images-idx3-ubyte.gz", images[..., 0])
        _write_idx(root / "idx" / f"{name}-labels-idx1-ubyte.gz", labels)
    return str(root / "idx")


LATENT_CLI_FLAGS = ["--num-epochs", "1", "--max-steps-per-epoch", "2", "--batch-size", "4",
                    "--log-every", "1", "--num-timesteps", "20", "--n-samples", "4",
                    "--sample-every-epoch", "false", "--visualize-denoising", "false",
                    "--device", "cpu"]


def test_stage_b_trains_on_the_vae_that_stage_a_wrote(tmp_path, monkeypatch, capsys):
    """The two CLIs in a row with their default paths, from a fresh working
    directory: the VAE that ``latent_diffusion`` loads is the one that
    ``vae`` saved, value for value."""
    root = _idx_train_and_test(tmp_path)
    monkeypatch.chdir(tmp_path)
    vae.main(["--epochs", "1", "--max-steps-per-epoch", "2", "--batch-size", "4",
              "--log-every", "1", "--data-root", root, "--device", "cpu"])
    saved = "runs/vae/checkpoints/vae_mnist_best"
    assert os.path.exists(saved + ".npz")
    loaded = []
    load_vae = latent_diffusion.load_vae
    monkeypatch.setattr(latent_diffusion, "load_vae",
                        lambda *a, **k: loaded.append(load_vae(*a, **k)) or loaded[-1])
    latent_diffusion.main(LATENT_CLI_FLAGS + ["--data-root", root])
    assert f"Loaded VAE from checkpoint: {saved}" in capsys.readouterr().out
    (model, _), = loaded
    want = state_dict_by_name(load_weights_arrays(saved))
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_dit_entry_writes_under_its_own_paths(tmp_path, monkeypatch):
    """``python -m tinydiffusion_torch.experiments.diffusion_transformer``
    trains the DiT into ``runs/diffusion_transformer/`` and leaves the MLP
    UNet's checkpoint of a run before it as it was."""
    root = _idx_train_and_test(tmp_path)
    monkeypatch.chdir(tmp_path)
    flags = LATENT_CLI_FLAGS + ["--data-root", root, "--vae-checkpoint", VAE_CHECKPOINT]
    latent_diffusion.main(flags)
    mlp = "runs/latent_diffusion/latent_diffusion_best"
    before = {ext: open(mlp + ext, "rb").read() for ext in (".npz", ".json", ".pt")}
    diffusion_transformer.main(flags)
    dit = "runs/diffusion_transformer/diffusion_transformer_best"
    assert load_sidecar(dit)["config"]["backbone"] == "dit"
    assert os.path.exists(dit + ".npz") and os.path.exists(dit + ".pt")
    assert os.path.isdir("runs/diffusion_transformer/dit-latent-diffusion-mnist")
    for ext, data in before.items():
        assert open(mlp + ext, "rb").read() == data, ext


@pytest.mark.parametrize("backbone", ["mlp_unet", "dit"])
def test_run_alike_on_both_paths_and_serves_its_checkpoint(tmp_path, backbone):
    """The recipe at batch 4 from the committed VAE, host-streamed and
    resident: the same batches, draws and val keys, so the same losses and
    val losses to the bit; the DiT's rate follows the cosine per epoch; the
    best checkpoint loads in ``load_latent_checkpoint`` and in JAX's
    ``restore_weights``."""
    results = {}
    for placement in ("host", "device"):
        out = tmp_path / placement
        config = latent_diffusion.LatentDiffusionConfig(
            backbone=backbone, device="cpu", num_epochs=3, max_steps_per_epoch=3,
            batch_size=4, log_every=2, num_timesteps=20, n_samples=4, denoising_stride=10,
            compute_dtype="float32", ema_decay=0.9, data_placement=placement,
            vae_checkpoint=VAE_CHECKPOINT, data_root=_idx_data_root(out),
            out_dir=str(out), model_save_path=str(out / "ckpt"),
            sample_every_epoch=placement == "device",
            visualize_denoising=placement == "device")
        results[placement] = latent_diffusion.run(config)
    host, resident = results["host"], results["device"]
    assert not host["resident"] and resident["resident"]
    assert host["losses"] == resident["losses"] and len(host["losses"]) == 6
    assert host["val_losses"] == resident["val_losses"] and len(host["val_losses"]) == 3
    assert resident["graph"] == {"eager": 9, "captures": 0, "replays": 0}
    assert resident["qsample_launches"] == {"train": 0, "eval": 0}  # the CPU runs no kernel
    lrs = [e["lr"] for e in resident["epochs"]]
    if backbone == "dit":
        want = [float(optax.cosine_decay_schedule(3e-4, 3)(e)) for e in range(3)]
        np.testing.assert_allclose(lrs, want, rtol=1e-6)
    else:
        assert lrs == [1e-3] * 3
    out = tmp_path / "device"
    for name in ["generated_mnist_epoch_0.png", "generated_digit_7.png", "denoising_t20.png",
                 "denoising_t10.png"]:
        assert (out / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    project = "dit-latent-diffusion-mnist" if backbone == "dit" else \
        "conditional-latent-diffusion-mnist"
    with open(out / project / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["val_loss"] for r in records if "val_loss" in r] == resident["val_losses"]
    ckpt = str(out / "ckpt")
    loaded = load_latent_checkpoint(ckpt, device="cpu")
    assert loaded["cfg"]["backbone"] == backbone and loaded["use_ema"]
    assert loaded["compute_dtype"] == torch.float32 and not loaded["model"].training
    jmodel = _jax_model(backbone)
    shapes = dict(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 20)), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2,), jnp.int32))))
    shapes["ema_params"] = shapes["params"]
    restored = restore_weights(ckpt, shapes)  # every npz key has its slot in JAX's tree
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(shapes)
