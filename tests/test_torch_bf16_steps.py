"""Whole bf16 train steps of the latent models against JAX's, on the CPU.

One SGD step in bfloat16 from the committed weights, on JAX's draws
through the port's seams, for the MLP UNet and the DiT (latent diffusion on
the MNIST VAE) and the LAION ``LatentUNet`` (patch codec, clip 10). Four
steps per model: the port's; JAX's run eagerly (op by op: the rounding
flax's code writes down); JAX's jitted (XLA's fusions round some of it
elsewhere); and, as a diagnostic only, JAX's eager step with its
broadcasts' transposes summed in float32 (``float32_broadcast_sums``). The
gaps between pairs are printed (``pytest -s``): the loss's, relative; the
largest parameter gap; the largest gap of a BatchNorm running statistic,
relative to it.

The port is held to JAX's steps as they are, eager and jitted: the largest
parameter gap to each within a bound a model (``PARAM_BOUNDS``, about twice
the gap read on the CPU), the loss within JAX's own eager-to-jit gap of the
eager step and within twice it of the jitted one.

The transpose of a broadcast (the gradient of a bias, of the time
projection added to a skip, of the DiT's positions) is a sum over the
broadcast axes. In bf16 XLA's CPU backend adds it in bf16, each add
rounded, in order over up to B*H*W terms: so JAX's bias gradients there
lose most of their bits. The port sums in float32 and rounds once, and
does not copy a backend's order of additions. That sum holds the largest
parameter gap of the UNet28 and the LatentUNet (their one-layer heads'
biases); the patched run shows how far the rest lies. The pixel UNet28's
whole step is held in ``tests/test_torch_tensor_parallel.py``, in one
process and at (1, 2).
"""

import contextlib

import jax
import jax._src.lax.lax as jax_lax_impl
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_diffusion import _same_tables
from tests.test_torch_laion_diffusion import BATCH as LAION_BATCH
from tests.test_torch_laion_diffusion import PROMPTS, _codec_pair, _nchw
from tests.test_torch_laion_diffusion import _images as _laion_images
from tests.test_torch_laion_diffusion import _jax_variables as _laion_jax_variables
from tests.test_torch_laion_diffusion import _port_model as _laion_port_model
from tests.test_torch_latent import BATCH, _images, _jax_model, _jax_variables, _port_model
from tests.test_torch_latent import _torch, _vae_pair
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.experiments import conditional_diffusion_laion as jax_exp
from tinydiffusion_tpu.io.checkpoint import _flat_items
from tinydiffusion_tpu.models.unet_latent import LatentUNet as JaxLatentUNet
from tinydiffusion_tpu.train.trainer import DiffusionTrainState as JaxTrainState
from tinydiffusion_tpu.train.trainer import _raw_latent_step_fn
from tinydiffusion_torch.compat import text_encoder
from tinydiffusion_torch.train.trainer import (
    create_train_state,
    make_laion_train_step,
    make_latent_train_step,
)

LATENT_LR, LAION_LR, LAION_CLIP = 0.1, 1e-2, 10.0
# The port's loss against JAX's jitted step, against JAX's eager step's gap
# to it: at most this many times, plus the floor of a float32
# summation-order gap.
JIT_RATIO, LOSS_FLOOR = 2.0, 1e-6
# The largest parameter gap after one step to JAX's (eager, jitted) step,
# about twice the gap read on the CPU (eager / jitted): MLP UNet 9.8e-5 /
# 1.0e-3; DiT 4.9e-4 / 2.4e-4 (one and two bf16 ulps of its bf16
# ``pos_encoding``; 4.9e-5 with float32 broadcast sums); LatentUNet 4.8e-4 /
# 4.8e-4 (the head's bias; 2.0e-5 with float32 broadcast sums).
PARAM_BOUNDS = {"mlp_unet": (2e-4, 2e-3), "dit": (1e-3, 5e-4), "latent_unet": (1e-3, 1e-3)}


@contextlib.contextmanager
def float32_broadcast_sums():
    """JAX's transposes of a broadcast (``lax.add``'s unbroadcast, the
    transpose of ``broadcast_in_dim``) sum a bf16 cotangent in float32 and
    round once, as the port does, inside the block."""
    keep = jax_lax_impl.reduce_sum

    def reduce_sum(x, axes, **kwargs):
        if jnp.result_type(x) != jnp.bfloat16:
            return keep(x, axes, **kwargs)
        return keep(jax.lax.convert_element_type(x, jnp.float32), axes,
                    **kwargs).astype(jnp.bfloat16)

    jax_lax_impl.reduce_sum = reduce_sum
    try:
        yield
    finally:
        jax_lax_impl.reduce_sum = keep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(state) -> dict:
    flat, _ = _flat_items({"params": state.params, "batch_stats": state.batch_stats})
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32)) for k, v in flat.items()}


def gaps(a: tuple, b: tuple) -> dict:
    """The loss's relative gap, the largest parameter gap and the largest
    BatchNorm statistic's relative gap between two ``(loss, weights)``."""
    (loss_a, wa), (loss_b, wb) = a, b
    params = [np.abs(wa[k] - v).max() for k, v in wb.items() if k.startswith("params/")]
    stats = [(np.abs(wa[k] - v) / np.maximum(np.abs(v), 1e-3)).max()
             for k, v in wb.items() if k.startswith("batch_stats/")]
    return {"loss_rel": abs(loss_a - loss_b) / abs(loss_b), "params": float(max(params)),
            "stats_rel": float(max(stats)) if stats else 0.0}


def _port_weights(state, jax_dtypes: dict) -> dict:
    """The port's weights in JAX's keys, each rounded to the dtype JAX keeps
    it in (the DiT's ``pos_encoding`` is a bf16 parameter in flax)."""
    out = {}
    for k, v in state.jax_weights().items():
        if k == "step":
            continue
        if jax_dtypes.get(k) == jnp.bfloat16:
            v = torch.from_numpy(np.asarray(v)).to(torch.bfloat16).float().numpy()
        out[k] = np.asarray(v)
    return out


def _latent_steps(backbone: str):
    jvae, jvae_params, vae = _vae_pair()
    options = {"dropout": 0.0} if backbone == "dit" else {}
    jmodel = _jax_model(backbone, dtype=jnp.bfloat16, **options)
    variables = _jax_variables(backbone, jmodel)
    tx = optax.sgd(LATENT_LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables.get("batch_stats", {}),
                           opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(7))
    x0, y = _images(8)
    jschedule = JaxSchedule.linear(1000)
    _, z_key, t_key, noise_key, _ = jax.random.split(jstate.rng, 5)
    z_eps = np.array(jax.random.normal(z_key, (BATCH, 20)))
    t = np.array(jax.random.randint(t_key, (BATCH,), 0, 1000))
    noise = np.array(jax.random.normal(noise_key, (BATCH, 20)))
    raw = _raw_latent_step_fn(jvae, jmodel, tx, jschedule)
    args = (jstate, jvae_params, jnp.asarray(x0), jnp.asarray(y))
    eager_state, eager_loss = raw(*args)
    with float32_broadcast_sums():
        sums_state, sums_loss = raw(*args)
    jit_state, jit_loss = jax.jit(raw)(*args)
    dtypes = {k: jnp.asarray(v).dtype for k, v in
              _flat_items({"params": jit_state.params, "batch_stats": jit_state.batch_stats})[0]
              .items()}

    model = _port_model(backbone, **options)
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LATENT_LR), 0)
    step = make_latent_train_step(vae, _same_tables(jschedule), compute_dtype=torch.bfloat16)
    x0_t, y_t, z_eps_t, t_t, noise_t = _torch(x0, y, z_eps, t, noise)
    loss = step(state, x0_t.permute(0, 3, 1, 2), y_t, z_eps=z_eps_t, t=t_t, noise=noise_t)
    return ((loss.item(), _port_weights(state, dtypes)), (float(eager_loss), _flat(eager_state)),
            (float(jit_loss), _flat(jit_state)), (float(sums_loss), _flat(sums_state)))


def _laion_steps():
    jcodec, codec = _codec_pair()
    jmodel = JaxLatentUNet(dtype=jnp.bfloat16)
    variables = _laion_jax_variables(jmodel)
    tx = optax.chain(optax.clip_by_global_norm(LAION_CLIP), optax.sgd(LAION_LR))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(8))
    images = _laion_images(8)
    ctx = text_encoder.HashTextEncoder().encode(PROMPTS[1:3])
    keys = jax.random.split(jstate.rng, 4)
    t = np.array(jax.random.randint(keys[1], (LAION_BATCH,), 0, 1000))
    noise = np.array(jax.random.normal(keys[2], (LAION_BATCH, 32, 32, 4)))
    raw = jax_exp._laion_raw_step(jmodel, tx, JaxSchedule.linear(1000), jcodec)
    args = (jstate, jnp.asarray(images), jnp.asarray(ctx))
    eager_state, eager_loss = raw(*args)
    with float32_broadcast_sums():
        sums_state, sums_loss = raw(*args)
    jit_state, jit_loss = jax.jit(raw)(*args)

    model = _laion_port_model()
    optimizer = torch.optim.SGD(model.parameters(), lr=torch.tensor(LAION_LR))
    state = create_train_state(model, optimizer, 0)
    step = make_laion_train_step(codec, _same_tables(JaxSchedule.linear(1000)),
                                 lambda count: torch.full_like(count, LAION_LR),
                                 clip_norm=LAION_CLIP, compute_dtype=torch.bfloat16)
    loss = step(state, _nchw(images), torch.from_numpy(ctx), t=torch.from_numpy(t).long(),
                noise=_nchw(noise))
    return ((loss.item(), _port_weights(state, {})), (float(eager_loss), _flat(eager_state)),
            (float(jit_loss), _flat(jit_state)), (float(sums_loss), _flat(sums_state)))


def check_bf16_step(name: str, port: tuple, eager: tuple, jitted: tuple, sums: tuple,
                    param_bounds: tuple[float, float]) -> None:
    """Print the gaps and hold the port to JAX's eager and jitted steps (see
    the module's docstring); ``param_bounds``: (eager, jitted)."""
    eager_to_jit = gaps(eager, jitted)
    to_eager = gaps(port, eager)
    to_jit = gaps(port, jitted)
    print(f"{name} bf16 step: port vs JAX eager {to_eager}; port vs JAX jit {to_jit}; "
          f"port vs JAX eager, float32 broadcast sums {gaps(port, sums)}; "
          f"JAX eager vs JAX jit {eager_to_jit}")
    assert to_eager["params"] <= param_bounds[0], (name, to_eager)
    assert to_jit["params"] <= param_bounds[1], (name, to_jit)
    assert to_eager["loss_rel"] <= eager_to_jit["loss_rel"] + LOSS_FLOOR, name
    assert to_jit["loss_rel"] <= JIT_RATIO * eager_to_jit["loss_rel"] + LOSS_FLOOR, name


@pytest.mark.parametrize("model", ["mlp_unet", "dit", "latent_unet"])
def test_bf16_step_rounds_as_jax(model):
    check_bf16_step(model, *(_laion_steps() if model == "latent_unet" else _latent_steps(model)),
                    PARAM_BOUNDS[model])
