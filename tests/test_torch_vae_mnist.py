"""The port's MNIST MLP VAE and its experiment against the JAX package, on the CPU.

``models/vae_mnist.py`` (forward and loss on the committed
``checkpoints/vae_mnist_best``), one Adam step through the step's ``eps``
seam, the weight bridge both ways, and ``experiments/vae.py::run`` on the
host and the resident path. JAX's reparameterising noise reaches the port as
``eps``; everything runs in float32.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_diffusion import _write_idx
from tinydiffusion_tpu.experiments.vae import VAEExperimentConfig as JaxVAEConfig
from tinydiffusion_tpu.experiments.vae import VAETrainState, _vae_raw_step
from tinydiffusion_tpu.io.checkpoint import _flat_items, restore_weights
from tinydiffusion_tpu.models.vae_mnist import VAEMnist as JaxVAEMnist
from tinydiffusion_tpu.models.vae_mnist import vae_loss as jax_vae_loss
from tinydiffusion_torch.data.mnist import load_mnist_u8
from tinydiffusion_torch.experiments import vae
from tinydiffusion_torch.experiments.latent_diffusion import LatentDiffusionConfig, load_vae
from tinydiffusion_torch.io.checkpoint import load_weights_arrays
from tinydiffusion_torch.io.from_jax import jax_variables, vae_mnist_state_dict
from tinydiffusion_torch.models.vae_mnist import VAEMnist, vae_loss
from tinydiffusion_torch.train.trainer import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_CHECKPOINT = os.path.join(REPO, "checkpoints", "vae_mnist_best")
# float32 forward of the 784-400-20 MLP on the same weights: summation order
# over 784 and 400 terms, relative to the outputs' scale.
FORWARD_RTOL, FORWARD_ATOL = 1e-5, 1e-6
# The summed loss of a batch (~1.6e4 at B = 16): 1e-5 relative.
LOSS_RTOL = 1e-5
# One Adam step (lr 1e-3): the first update is lr * g / (|g| + eps), so a
# gradient that differs in its last bits moves a weight by ~lr * 1e-6.
PARAM_ATOL = 1e-7
BATCH = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops; the suite runs several workers on a few cores. One torch
    thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params():
    template = jax.eval_shape(lambda: JaxVAEMnist().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), jax.random.PRNGKey(0)))["params"]
    return restore_weights(VAE_CHECKPOINT, {"params": template})["params"]


def _port_vae() -> VAEMnist:
    model = VAEMnist()
    model.load_state_dict(vae_mnist_state_dict(load_weights_arrays(VAE_CHECKPOINT)))
    return model


def _images(seed: int, n: int = BATCH) -> np.ndarray:
    """Random uint8 images mapped to [-1, 1] as MNIST is."""
    u8 = np.random.default_rng(seed).integers(0, 256, (n, 28, 28, 1)).astype(np.float32)
    return u8 * (2.0 / 255.0) - 1.0


def test_bridge_fills_every_slot_and_inverts():
    flat = load_weights_arrays(VAE_CHECKPOINT)
    assert len(flat) == 11 and flat["params/fc1/kernel"].shape == (784, 400)
    sd = vae_mnist_state_dict(flat)
    model = VAEMnist()
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)  # strict
    back = jax_variables(model)
    assert back.keys() == {k for k in flat if k != "step"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_forward_and_loss_match_jax_on_the_committed_weights():
    params = _jax_params()
    jmodel = JaxVAEMnist()
    x = _images(0)
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(key, (BATCH, 20)))  # reparameterize's own draw
    recon, mu, logvar = jax.jit(lambda p: jmodel.apply({"params": p}, x, key))(params)
    want_loss = float(jax_vae_loss(recon, x, mu, logvar))
    model = _port_vae()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW: one channel, the same order
    with torch.no_grad():
        got = model(xt, torch.from_numpy(eps))
        loss = vae_loss(got[0], xt, got[1], got[2]).item()
    for a, b in zip(got, (recon, mu, logvar)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_RTOL,
                                   atol=FORWARD_ATOL)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)


def test_loss_clamps_the_logs_like_jax():
    """A saturated sigmoid gives exact 0 and 1: both logs clamp at -100."""
    recon = np.array([[0.0, 1.0, 0.5, 1e-30]], np.float32)
    x = np.array([[1.0, -1.0, 0.2, 1.0]], np.float32)
    mu = np.array([[0.3, -2.0]], np.float32)
    logvar = np.array([[0.1, -1.5]], np.float32)
    want = float(jax_vae_loss(*(jnp.asarray(a) for a in (recon, x, mu, logvar))))
    got = vae_loss(*(torch.from_numpy(a) for a in (recon, x, mu, logvar))).item()
    assert np.isfinite(got) and got > 200  # two clamped terms of 100
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adam_step_matches_jax():
    """One step of the recipe's Adam (1e-3) from the committed weights; the
    port gets the eps that JAX's step draws from its state's key."""
    params = _jax_params()
    jmodel, tx = JaxVAEMnist(), optax.adam(1e-3)
    jstate = VAETrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(3))
    x = _images(1)
    _, z_key = jax.random.split(jstate.rng)
    eps = np.array(jax.random.normal(z_key, (BATCH, 20)))
    new_jstate, jloss = jax.jit(_vae_raw_step(jmodel, tx))(jstate, jnp.asarray(x))

    model = _port_vae()
    state = create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), 0)
    loss = vae.make_vae_train_step()(state, torch.from_numpy(x).permute(0, 3, 1, 2),
                                     eps=torch.from_numpy(eps))
    assert state.step == 1
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want, _ = _flat_items({"params": new_jstate.params})
    got = state.jax_weights()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], np.asarray(value), atol=PARAM_ATOL, rtol=0,
                                   err_msg=key)
    moved = np.abs(got["params/fc1/kernel"] - np.asarray(params["fc1"]["kernel"]))
    assert moved.max() > 5e-4  # the step moved the weights by ~lr


def test_config_takes_the_jax_flags():
    ours = {f.name: f.default for f in dataclasses.fields(vae.VAEExperimentConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxVAEConfig)}
    assert {k for k in theirs if ours[k] != theirs[k]} == {"checkpoint_dir"}
    assert not ours["checkpoint_dir"].startswith("checkpoints")
    assert set(ours) - set(theirs) == {"device"}


def mnist_idx_root(root, n_train: int = 64, n_test: int = 40) -> str:
    """A data root with small train and test IDX files (synthetic digits)."""
    out = root / "idx"
    os.makedirs(out, exist_ok=True)
    for split, n, name in ((True, n_train, "train"), (False, n_test, "t10k")):
        images, labels = load_mnist_u8(str(root / "synth"), train=split, synthetic_n=n)
        _write_idx(out / f"{name}-images-idx3-ubyte.gz", images[..., 0])
        _write_idx(out / f"{name}-labels-idx1-ubyte.gz", labels)
    return str(out)


def test_run_alike_on_both_paths_and_its_checkpoint_serves_latent_diffusion(tmp_path):
    """The recipe at batch 8, host-streamed and resident: the same batches
    and draws, so the same losses and test losses to the bit; the best
    checkpoint is the JAX layout, and ``load_vae`` and JAX's loader read it."""
    data_root = mnist_idx_root(tmp_path)
    results = {}
    for placement in ("host", "device"):
        out = tmp_path / placement
        config = vae.VAEExperimentConfig(
            device="cpu", epochs=2, max_steps_per_epoch=3, batch_size=8, log_every=2,
            data_placement=placement, data_root=data_root, out_dir=str(out),
            checkpoint_dir=str(out / "ckpt"))
        results[placement] = vae.run(config)
    host, resident = results["host"], results["device"]
    assert not host["resident"] and resident["resident"]
    assert host["losses"] == resident["losses"] and len(host["losses"]) == 4
    assert host["test_losses"] == resident["test_losses"]
    assert [e["test_batches"] for e in resident["epochs"]] == [3, 3]
    assert resident["graph"] == {"eager": 6, "captures": 0, "replays": 0}
    assert resident["state"].step == 6
    out = tmp_path / "device"
    for name in ["generated_samples.png", "original_vs_reconstructed_epoch_1.png",
                 "original_vs_reconstructed_epoch_2.png"]:
        assert (out / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    with open(out / "vae_mnist" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["test_loss"] for r in records if "test_loss" in r] == resident["test_losses"]
    ckpt = str(out / "ckpt" / "vae_mnist_best")
    sidecar = json.loads(open(ckpt + ".json").read())
    assert sidecar["metadata"]["metric"] == min(resident["test_losses"])
    loaded, latent_dim = load_vae(LatentDiffusionConfig(vae_checkpoint=ckpt), device="cpu")
    assert latent_dim == 20 and not loaded.training
    assert not any(p.requires_grad for p in loaded.parameters())
    model = resident["state"].model
    for name, p in loaded.named_parameters():
        np.testing.assert_allclose(p.numpy(), model.state_dict()[name].numpy(), atol=4e-3,
                                   rtol=4e-3)  # the npz holds bfloat16 params
    template = jax.eval_shape(lambda: JaxVAEMnist().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), jax.random.PRNGKey(0)))["params"]
    restored = restore_weights(ckpt, {"params": template})["params"]
    np.testing.assert_array_equal(np.asarray(restored["fc4"]["bias"]),
                                  load_weights_arrays(ckpt)["params/fc4/bias"])
