"""The port's UNet28 and its blocks against the JAX package, on the CPU.

Same weights in both packages (the committed ``checkpoints/diffusion_final``
npz, or a JAX init carried across with ``unet28_state_dict``), same inputs
made with numpy. The port runs NCHW, JAX NHWC: the tests transpose at the
boundary. The JAX models run in float32.
"""

import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tinydiffusion_tpu.io.checkpoint import _flat_items, restore_weights
from tinydiffusion_tpu.models.unet28 import UNet28 as JaxUNet28
from tinydiffusion_tpu.nn.layers import TimeEmbedMLP as JaxTimeEmbedMLP
from tinydiffusion_tpu.nn.resize import max_pool_ceil, resize_bilinear_align_corners
from tinydiffusion_torch.experiments.common import load_unet28
from tinydiffusion_torch.io.checkpoint import load_weights_arrays
from tinydiffusion_torch.io.from_jax import jax_variables, unet28_state_dict
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.nn.layers import BatchNorm2d, TimeEmbedMLP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "checkpoints", "diffusion_final")

# A whole UNet28, float32 on both sides: ~20 conv layers of summation-order
# differences between XLA's and torch's convolutions.
MODEL_ATOL, MODEL_RTOL = 1e-4, 1e-4
# One layer, float32 on both sides.
LAYER_ATOL, LAYER_RTOL = 1e-5, 1e-5


def nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _jax_variables_of(model, example_x, example_t, y=None):
    args = (example_x, example_t) if y is None else (example_x, example_t, y)
    return jax.jit(lambda: model.init(jax.random.PRNGKey(0), *args, train=False))()


# --- weights ------------------------------------------------------------------


def test_bridge_fills_every_unet28_slot():
    flat = load_weights_arrays(CHECKPOINT)
    assert len(flat) == 93 and "step" in flat
    sd = unet28_state_dict(flat)
    model = UNet28()
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    model.load_state_dict(sd)  # strict
    n_params = sum(v.size for k, v in flat.items() if k.startswith("params/"))
    assert sum(p.numel() for p in model.parameters()) == n_params == 11_182_273


def test_bridge_refuses_an_unknown_key():
    flat = load_weights_arrays(CHECKPOINT)
    flat["opt_state/mu"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="opt_state/mu"):
        unet28_state_dict(flat)


def test_jax_variables_invert_the_bridge():
    flat = load_weights_arrays(CHECKPOINT)
    model = UNet28()
    model.load_state_dict(unet28_state_dict(flat))
    back = jax_variables(model)
    assert back.keys() == {k for k in flat if k != "step"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_checkpoint_eps_matches_jax():
    """diffusion_final in both packages, eval mode, full width, batch 2."""
    jmodel = JaxUNet28(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,), jnp.int32)))
    variables = restore_weights(CHECKPOINT, {"params": shapes["params"],
                                             "batch_stats": shapes["batch_stats"]})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 28, 28, 1)).astype(np.float32)
    t = np.array([17, 901], np.int32)
    want = jax.jit(lambda v, x, t: jmodel.apply(v, x, t, train=False))(variables, x, t)
    model = load_unet28(CHECKPOINT, device="cpu")
    with torch.no_grad():
        got = model(nchw(x), torch.from_numpy(t).long())
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want),
                               atol=MODEL_ATOL, rtol=MODEL_RTOL)


def test_load_unet28_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_unet28(CHECKPOINT)


@pytest.mark.parametrize("num_classes", [None, 10])
def test_small_unet28_matches_jax_in_eval_and_train_mode(num_classes):
    """A JAX init at base width 8, carried across; eval with its stats, and
    train mode (batch statistics) on the same inputs."""
    jmodel = JaxUNet28(time_dim=32, base_width=8, num_classes=num_classes, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 28, 28, 1)).astype(np.float32)
    t = np.array([0, 250, 999], np.int32)
    y = np.array([1, 7, 3], np.int32) if num_classes else None
    variables = _jax_variables_of(jmodel, x, t, y)
    flat, _ = _flat_items(variables)
    model = UNet28(time_dim=32, base_width=8, num_classes=num_classes)
    model.load_state_dict(unet28_state_dict({k: np.asarray(v) for k, v in flat.items()}))
    ty = torch.from_numpy(y).long() if num_classes else None
    args = (x, t) if y is None else (x, t, y)
    for train in (False, True):
        want = jax.jit(lambda v, *a: jmodel.apply(
            v, *a, train=train, mutable=["batch_stats"] if train else False))(variables, *args)
        want = want[0] if train else want
        model.train(train)
        with torch.no_grad():
            got = model(nchw(x), torch.from_numpy(t).long(), ty)
        np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want),
                                   atol=MODEL_ATOL, rtol=MODEL_RTOL, err_msg=f"train={train}")


# --- blocks -------------------------------------------------------------------


def test_batchnorm_running_stats_follow_flax():
    """Train mode at N = B*H*W = 8, where torch's own unbiased running
    variance would be N/(N-1) = 14 % off flax's biased one."""
    rng = np.random.default_rng(2)
    x = (3.0 * rng.standard_normal((2, 2, 2, 5)) + 1.0).astype(np.float32)
    jbn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), x)
    want, mutated = jbn.apply(variables, x, mutable=["batch_stats"])
    bn = BatchNorm2d(5).train()
    got = bn(nchw(x))
    np.testing.assert_allclose(nhwc(got.detach().numpy()), np.asarray(want),
                               atol=LAYER_ATOL, rtol=LAYER_RTOL)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    torch_bn = torch.nn.BatchNorm2d(5, momentum=0.1).train()
    torch_bn(nchw(x))
    assert not np.allclose(torch_bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-2)


def test_time_embedding_takes_the_raw_timestep():
    t = np.array([0, 1, 500, 999], np.int32)
    jmlp = JaxTimeEmbedMLP(16)
    variables = jmlp.init(jax.random.PRNGKey(3), t)
    mlp = TimeEmbedMLP(16)
    p = variables["params"]
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(mlp, name).weight.copy_(torch.from_numpy(np.array(p[name]["kernel"]).T))
            getattr(mlp, name).bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
        got = mlp(torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(jmlp.apply(variables, t)),
                               atol=LAYER_ATOL, rtol=LAYER_RTOL)


@pytest.mark.parametrize("size_in, size_out", [(4, 8), (7, 8), (14, 16), (28, 32), (32, 28)])
def test_align_corners_resize_matches_jax(size_in, size_out):
    x = np.random.default_rng(size_in).standard_normal((2, size_in, size_in, 3)).astype(np.float32)
    want = resize_bilinear_align_corners(jnp.asarray(x), (size_out, size_out))
    got = F.interpolate(nchw(x), size=(size_out, size_out), mode="bilinear", align_corners=True)
    # JAX interpolates with a float32 matrix of float64 weights, torch with
    # weights computed in float32: a few ulp apart.
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want),
                               atol=LAYER_ATOL, rtol=LAYER_RTOL)


@pytest.mark.parametrize("size", [28, 14, 7])
def test_ceil_max_pool_and_its_tie_gradient_match_jax(size):
    """The JAX custom VJP routes a tied window's gradient to its first max,
    as torch's native backward does (tests/test_maxpool_vjp.py)."""
    rng = np.random.default_rng(size)
    x = rng.integers(0, 3, (2, size, size, 4)).astype(np.float32)  # many ties
    gy = rng.standard_normal((2, -(-size // 2), -(-size // 2), 4)).astype(np.float32)
    want, vjp = jax.vjp(max_pool_ceil, jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(gy))
    xt = nchw(x).requires_grad_(True)
    got = F.max_pool2d(xt, 2, 2, ceil_mode=True)
    got.backward(nchw(gy))
    np.testing.assert_array_equal(nhwc(got.detach().numpy()), np.asarray(want))
    np.testing.assert_array_equal(nhwc(xt.grad.numpy()), np.asarray(want_grad))
