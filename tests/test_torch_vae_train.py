"""The port's conv-VAE training pieces against the JAX package, on the CPU.

The perceptual net, the loss, the VGG16 loader, the optimizer (optax's
``chain(clip_by_global_norm, adam)``) and one whole train step, each fed
the same inputs in both packages: weights carried across with the bridges
of ``io.from_jax``, images and noise made with numpy, or drawn by the JAX
code and handed to the port through the step's ``eps`` seam. JAX's flash
attention runs its Pallas kernels in interpret mode; the port's runs its
plain versions (the CUDA kernels are held against those on the card by
``chip_smoke.py``).
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinydiffusion_tpu.compat.vgg import load_vgg16_perceptual as jax_load_vgg16
from tinydiffusion_tpu.experiments.vae_laion import _conv_vae_raw_step
from tinydiffusion_tpu.io.checkpoint import _flat_items, _norm_key
from tinydiffusion_tpu.models.vae_conv import ConvVAE as JaxConvVAE
from tinydiffusion_tpu.models.vae_conv import PerceptualNet as JaxPerceptualNet
from tinydiffusion_tpu.models.vae_conv import conv_vae_loss as jax_conv_vae_loss
from tinydiffusion_torch.compat.vgg import convert_vgg16_features, load_vgg16_perceptual
from tinydiffusion_torch.experiments.vae_laion import (
    ConvVAETrainState,
    clip_by_global_norm_,
    create_train_state,
    make_conv_vae_train_step,
)
from tinydiffusion_torch.io.from_jax import conv_vae_state_dict, perceptual_state_dict
from tinydiffusion_torch.models.vae_conv import ConvVAE, PerceptualNet, conv_vae_loss
from tinydiffusion_torch.ops import attention

SIZE, BATCH, LATENT = 128, 2, 128
# One conv layer stack, float32 on both sides: XLA's and torch's
# convolutions sum in different orders (~1e-6 relative), seven layers deep.
FEATURE_ATOL, FEATURE_RTOL = 1e-4, 1e-4
# Sums over up to 2 x 3 x 128^2 elements in float32, in different orders.
LOSS_RTOL = 1e-5
# Adam and the clip on the same gradients: the same float32 formulas,
# rounded in another order; the params (|p| < 4) then differ by at most one
# float32 ulp of the param, 2.4e-7 (an update is ~1e-4).
OPT_ATOL = 2.4e-7
# One train step, float32: ~30 layers of summation-order differences, the
# JAX flash kernel's bf16x3 logits at N = 4096 (~1e-4 relative on attention
# outputs) and the BCE's sums of 10^5 terms. These reach the gradients
# through train-mode BatchNorms at batch 2 and the attention's cancelling
# sums: the port's own float32 gradients lie up to 0.4 % (dense attention)
# and 1.6 % (flash) from its float64 ones, as the largest error over the
# largest element of a tensor (measured on the CPU). So each gradient tensor
# is held by its relative Frobenius error (JAX vs port: at most 0.9 %
# measured), and the params, BN statistics and the spectral norms' u and
# sigma after the step directly.
GRAD_REL_ERR = 1.5e-2
# The extremes of mu and logvar: one element each, out of the encoder's ~15
# layers and the flash site, not a sum that averages the differences out.
LATENT_RTOL = 1e-4
PARAM_ATOL = 1e-5
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
LR = 1e-3


def _jax_perceptual_params(size: int = 32):
    return jax.jit(lambda: JaxPerceptualNet().init(
        jax.random.PRNGKey(123), jnp.zeros((1, size, size, 3))))()["params"]


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


# --- perceptual net, loss, VGG loader ------------------------------------------


def test_perceptual_net_matches_jax_with_bridged_weights():
    params = _jax_perceptual_params()
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxPerceptualNet().apply)({"params": params}, jnp.asarray(x)))
    net = PerceptualNet()
    net.load_state_dict(perceptual_state_dict(params))
    with torch.no_grad():
        got = net(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8, 8, 256)
    np.testing.assert_allclose(got, want, atol=FEATURE_ATOL, rtol=FEATURE_RTOL)


def test_perceptual_net_is_frozen_but_passes_gradients():
    net = PerceptualNet()
    assert not any(p.requires_grad for p in net.parameters())
    x = torch.rand(1, 3, 16, 16, requires_grad=True)
    net(x).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert all(p.grad is None for p in net.parameters())


def test_perceptual_seeded_init_draws_flax_he_normal():
    """flax ``he_normal``: a normal truncated at +-2 of its scale, with the
    variance 2 / fan_in; zero biases. torch draws other values (a stated
    deviation), so the test holds the distribution: the largest layers'
    standard deviation within 2 %, nothing past the truncation."""
    net, again = PerceptualNet(seed=123), PerceptualNet(seed=123)
    for (name, w), w2 in zip(net.named_parameters(), again.parameters()):
        assert torch.equal(w, w2), name  # seeded
        if name.endswith("bias"):
            assert not w.any(), name
            continue
        fan_in = w[0].numel()
        scale = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
        assert w.abs().max() <= 2 * scale, name
        if w.numel() > 100_000:
            assert abs(w.std().item() / (2.0 / fan_in) ** 0.5 - 1) < 0.02, name
    assert not torch.equal(net.conv0_0.weight, PerceptualNet(seed=124).conv0_0.weight)


def test_conv_vae_loss_components_match_jax():
    """Including a saturated sigmoid: exact 0s and 1s hit the -100 clamps."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    recon = rng.uniform(0, 1, x.shape).astype(np.float32)
    recon[0, :4] = 0.0
    recon[1, :4] = 1.0
    mu = rng.standard_normal((2, 8)).astype(np.float32)
    logvar = rng.standard_normal((2, 8)).astype(np.float32)
    rf, tf = (rng.standard_normal((2, 4, 4, 16)).astype(np.float32) for _ in range(2))
    want_total, want = jax_conv_vae_loss(*map(jnp.asarray, (recon, x, mu, logvar, rf, tf)), 0.5)
    got_total, got = conv_vae_loss(nchw(recon), nchw(x), *map(torch.from_numpy, (mu, logvar)),
                                   nchw(rf), nchw(tf), 0.5)
    assert got.keys() == want.keys() == {"bce", "perceptual", "kld", "logvar_max", "mu_absmax"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(got_total.item(), float(want_total), rtol=LOSS_RTOL)
    # The clamped terms count 100 each: without the clamp the sum is infinite.
    assert np.isfinite(got["bce"].item()) and got["bce"].item() > 100 * 4 * 16 * 3 * 0.1


def _torch_vgg16_state_dict(seed: int) -> dict[str, torch.Tensor]:
    """A synthetic torchvision ``vgg16`` state dict: features[:16]'s convs
    with random values, a later conv and a classifier weight the loader
    must ignore."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for idx, c_in, c_out in ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
                             (10, 128, 256), (12, 256, 256), (14, 256, 256), (17, 256, 512)):
        sd[f"features.{idx}.weight"] = torch.randn(c_out, c_in, 3, 3, generator=gen) * 0.05
        sd[f"features.{idx}.bias"] = torch.randn(c_out, generator=gen) * 0.1
    sd["classifier.0.weight"] = torch.randn(8, 8, generator=gen)
    return sd


@pytest.mark.parametrize("prefix", ["features.", ""])
def test_vgg16_loader_matches_jax(prefix, tmp_path):
    sd = {k[len("features."):] if not prefix and k.startswith("features.") else k: v
          for k, v in _torch_vgg16_state_dict(3).items()}
    path = str(tmp_path / "vgg16.pth")
    torch.save(sd, path)
    ours = load_vgg16_perceptual(path)
    theirs = perceptual_state_dict(jax_load_vgg16(path))
    assert ours.keys() == theirs.keys() == PerceptualNet().state_dict().keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    net = PerceptualNet()
    net.load_state_dict(ours)
    x = np.random.default_rng(2).uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    want = np.asarray(JaxPerceptualNet().apply({"params": jax_load_vgg16(path)}, jnp.asarray(x)))
    with torch.no_grad():
        got = net(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=FEATURE_ATOL, rtol=FEATURE_RTOL)


def test_vgg16_loader_refuses_a_short_or_misshaped_dict():
    sd = _torch_vgg16_state_dict(4)
    del sd["features.14.bias"]
    with pytest.raises(KeyError, match="features\\[14\\]"):
        convert_vgg16_features(sd)
    sd = _torch_vgg16_state_dict(4)
    sd["features.2.weight"] = sd["features.2.weight"][:32]
    with pytest.raises(ValueError, match="features\\[2\\]"):
        convert_vgg16_features(sd)


# --- the optimizer ---------------------------------------------------------------


@pytest.mark.parametrize("grad_scale,clips", [(100.0, True), (0.01, False)])
def test_clip_then_adam_matches_optax(grad_scale, clips):
    """Three steps of ``chain(clip_by_global_norm(10), adam(1e-4))`` on the
    same given gradients; the clip acts in one case and idles in the other."""
    rng = np.random.default_rng(5)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(grad_scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-4))
    params = [jnp.asarray(p) for p in init]
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, params)
        params = optax.apply_updates(params, updates)

    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = torch.optim.Adam(ours, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    norms = []
    for g in grads:
        for p, x in zip(ours, g):
            p.grad = torch.from_numpy(x.copy())
        norms.append(clip_by_global_norm_(ours, 10.0).item())
        opt.step()
    assert all((n >= 10.0) == clips for n in norms)
    for got, want in zip(ours, params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=OPT_ATOL, rtol=0)


def test_clip_follows_optax_not_clip_grad_norm():
    """optax scales by max_norm / norm exactly; torch's clip_grad_norm_
    divides by norm + 1e-6. At a norm of 20 the two differ in the last bits."""
    g = torch.full((4,), 10.0)  # norm 20
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = g.clone()
    clip_by_global_norm_([p], 10.0)
    want = np.asarray(optax.clip_by_global_norm(10.0).update(
        [jnp.asarray(g.numpy())], optax.EmptyState())[0][0])
    np.testing.assert_array_equal(p.grad.numpy(), want)


# --- one train step ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_vae_variables():
    """A JAX ConvVAE at 128x128, randomly initialised, with gamma and the BN
    statistics made non-trivial (as the serving tests' ``small_vae``).

    Unlike ``small_vae`` it keeps the init's query and key kernels. Scaled
    by 4 (logits of several units), the JAX flash kernel's bf16x3 logits
    put ~1e-3 of difference on the second stage's activations, and the
    train-mode BatchNorms at batch 2 turn that into gradients 2-8 % apart
    (measured on the CPU), with no fault on either side: with the init's
    kernels the same comparison agrees to ~3e-5."""
    jmodel = JaxConvVAE(latent_dim=LATENT, image_size=SIZE)
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), jax.random.PRNGKey(1),
        train=False))()
    flat, _ = _flat_items(variables)
    rng = np.random.default_rng(3)
    flat = {k: np.asarray(v) for k, v in flat.items()}
    for k, v in flat.items():
        if k.endswith("/gamma"):
            flat[k] = np.full_like(v, 0.8)  # init 0 would hide the attention
        elif k.endswith("/mean") or (k.endswith("/bias") and "/bn" in k):
            flat[k] = 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat[_norm_key(p)]), variables)
    return jmodel, variables, flat


def _port_model(flat) -> ConvVAE:
    model = ConvVAE(latent_dim=LATENT, image_size=SIZE)
    model.load_state_dict(conv_vae_state_dict(flat))
    return model


def test_train_step_matches_jax(jax_vae_variables, monkeypatch):
    """One clip(10) + SGD step at 128x128, B = 2, float32: the port gets the
    z noise JAX's step draws (its state's rng split, vae_laion.py:111)."""
    jmodel, variables, flat = jax_vae_variables
    perc = JaxPerceptualNet()
    perc_params = _jax_perceptual_params()
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.sgd(LR))
    x = np.random.default_rng(6).uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    _, z_key = jax.random.split(rng)
    eps = np.asarray(jax.random.normal(z_key, (BATCH, LATENT)))

    from tinydiffusion_tpu.experiments.vae_laion import ConvVAETrainState as JaxState

    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), rng=rng)
    new_jstate, jloss, jcomps = jax.jit(_conv_vae_raw_step(jmodel, perc, perc_params, tx, 1.0))(
        jstate, jnp.asarray(x))

    # JAX's gradients, clipped as its optimizer sees them: the same loss_fn.
    def loss_fn(params, xj):
        (recon, mu, logvar), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xj, z_key,
            train=True, mutable=["batch_stats"])
        rf = perc.apply({"params": perc_params}, recon)
        tf = perc.apply({"params": perc_params}, xj)
        return jax_conv_vae_loss(recon, xj, mu, logvar, rf, tf, 1.0)[0]

    jgrads, _ = _flat_items({"params": jax.jit(jax.grad(loss_fn))(variables["params"],
                                                                  jnp.asarray(x))})

    model = _port_model(flat)
    net = PerceptualNet()
    net.load_state_dict(perceptual_state_dict(perc_params))
    # The port's gradients before the clip: the step's loss on a copy.
    shadow = copy.deepcopy(model).train()
    recon, mu, logvar = shadow(nchw(x), torch.from_numpy(eps.copy()))
    conv_vae_loss(recon, nchw(x), mu, logvar, net(recon), net(nchw(x)), 1.0)[0].backward()
    got_grads = _jax_keyed(model, {n: p.grad for n, p in shadow.named_parameters()})

    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    bwd_shapes = []
    flash_bwd = attention.flash_bwd
    monkeypatch.setattr(attention, "flash_bwd",
                        lambda *a: bwd_shapes.append(tuple(a[0].shape)) or flash_bwd(*a))
    loss, comps = make_conv_vae_train_step(net, 1.0, clip_norm=10.0)(
        state, nchw(x), eps=torch.from_numpy(eps.copy()))
    assert bwd_shapes == [(BATCH, 4, 4096)]  # enc_attn0 took the flash Function

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for k, v in jcomps.items():
        rtol = LATENT_RTOL if k in ("logvar_max", "mu_absmax") else LOSS_RTOL
        np.testing.assert_allclose(comps[k].item(), float(v), rtol=rtol, err_msg=k)

    assert got_grads.keys() == jgrads.keys()
    for key, want in jgrads.items():
        if key.endswith("key/bias"):
            # Softmax ignores a shift of every key, so this gradient is 0:
            # both frameworks return the rounding noise of a sum that
            # cancels. The params after the step still hold it (below).
            continue
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got_grads[key] - want) / np.linalg.norm(want)
        assert err <= GRAD_REL_ERR, (key, err)

    want, _ = _flat_items({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats})
    got = state.jax_weights()
    assert got.keys() == want.keys() | {"step"} and int(got["step"]) == 1
    for key, value in want.items():
        value = np.asarray(value)
        if key.startswith("batch_stats"):
            np.testing.assert_allclose(got[key], value, rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=PARAM_ATOL, rtol=0, err_msg=key)
    moved = max(np.abs(got[k] - flat[k]).max() for k in want if k.startswith("params/"))
    assert moved > 1e-4  # the step changed the weights (and the test saw it)


def _jax_keyed(model: ConvVAE, tensors: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Port parameter-shaped tensors (gradients) under the JAX param keys."""
    from tinydiffusion_torch.io.from_jax import conv_vae_jax_variables

    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in shadow.named_parameters():
            p.copy_(tensors[name])
    return {k: v for k, v in conv_vae_jax_variables(shadow).items() if k.startswith("params/")}


def test_step_draws_its_noise_from_the_state_generator():
    """Without ``eps`` the step draws z from ``state.generator``: the same
    draw given through the seam takes the same step."""
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (BATCH, 3, 32, 32))
                         .astype(np.float32))
    runs = []
    for replay in (False, True):
        torch.manual_seed(0)
        model = ConvVAE(latent_dim=16, image_size=32)
        state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 11)
        eps = None
        if replay:
            eps = torch.randn(BATCH, 16, generator=torch.Generator().manual_seed(11))
        loss, _ = make_conv_vae_train_step(PerceptualNet(), 1.0)(state, x, eps=eps)
        runs.append((loss.item(), [p.detach().clone() for p in model.parameters()]))
        assert isinstance(state, ConvVAETrainState) and state.step == 1
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# --- one bfloat16 train step -----------------------------------------------------

# The bf16 step against JAX's bf16 step (64², B = 4, clip(10) + SGD), the same
# weights, images and z noise. Both run the convs, projections and attention
# in bf16 with float32 statistics and loss sums, but round in other orders;
# through train-mode BatchNorms at the 4x4 bottleneck that noise reaches the
# gradients: on the CPU the loss agreed to 5.9e-5 relative, the components to
# 2e-3, the updates' cosine read 0.947 (JAX's bf16 step against its own
# float32 one is as far). Bounds: 1e-3, 1e-2 and 0.9.
BF16_LOSS_RTOL, BF16_COMPONENT_RTOL, BF16_MIN_UPDATE_COS = 1e-3, 1e-2, 0.9


def test_bf16_train_step_matches_jax():
    size, batch = 64, 4
    jmodel = JaxConvVAE(latent_dim=LATENT, image_size=size, dtype=jnp.bfloat16)
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jax.random.PRNGKey(1),
        train=False))()
    flat, _ = _flat_items(variables)
    flat = {k: (np.full_like(v, 0.8) if k.endswith("/gamma") else np.asarray(v))
            for k, v in flat.items()}
    variables = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat[_norm_key(p)]), variables)
    perc_params = _jax_perceptual_params()
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.sgd(LR))
    x = np.random.default_rng(16).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(17)
    _, z_key = jax.random.split(rng)
    eps = np.asarray(jax.random.normal(z_key, (batch, LATENT)))

    from tinydiffusion_tpu.experiments.vae_laion import ConvVAETrainState as JaxState

    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), rng=rng)
    new_jstate, jloss, jcomps = jax.jit(_conv_vae_raw_step(
        jmodel, JaxPerceptualNet(dtype=jnp.bfloat16), perc_params, tx, 1.0))(
        jstate, jnp.asarray(x))

    model = ConvVAE(latent_dim=LATENT, image_size=size, dtype=torch.bfloat16)
    model.load_state_dict(conv_vae_state_dict(flat))
    net = PerceptualNet(dtype=torch.bfloat16)
    net.load_state_dict(perceptual_state_dict(perc_params))
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=LR), 0)
    loss, comps = make_conv_vae_train_step(net, 1.0, clip_norm=10.0)(
        state, nchw(x), eps=torch.from_numpy(eps.copy()))
    assert loss.dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_LOSS_RTOL)
    for k, v in jcomps.items():
        np.testing.assert_allclose(comps[k].item(), float(v), rtol=BF16_COMPONENT_RTOL,
                                   err_msg=k)
    want, _ = _flat_items({"params": new_jstate.params})
    got = state.jax_weights()
    keys = sorted(want)
    jax_update = np.concatenate([(np.asarray(want[k]) - flat[k]).ravel() for k in keys])
    update = np.concatenate([(got[k] - flat[k]).ravel() for k in keys])
    cos = update @ jax_update / (np.linalg.norm(update) * np.linalg.norm(jax_update))
    assert cos >= BF16_MIN_UPDATE_COS, cos
