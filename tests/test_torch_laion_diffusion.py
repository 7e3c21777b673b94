"""The port's LAION text-conditional latent diffusion against the JAX package, on the CPU.

``core/embeddings.py`` (the sinusoid), ``models/unet_latent.py`` on the
committed ``checkpoints/laion_diffusion_1000ep`` (float32 and bfloat16
forwards, the by-name bridge), ``compat/text_encoder.py`` and
``compat/latent_codec.py`` (hash embeddings; the patch codec's init,
calibration, encode, decode and state), ``data/laion.py`` (the offline
records and the valid subset), the LAION train step through its ``(t,
noise, keep)`` seam against JAX's ``_laion_raw_step`` with and without
caption dropout, the eval step, the cosine learning rate over 2500 Adam
steps against optax's chain, the resident steps against host steps, and
``experiments/conditional_diffusion_laion.py::run`` on both placements and
on resume. JAX runs on the CPU as its own tests run it; the port's image
records are the JPEG decodes that JAX's ``run`` stacks from a warm
``image_cache_dir`` (``data/laion.py``).
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import write_synthetic_clip
from tests.test_torch_diffusion import _same_tables
from tinydiffusion_tpu.compat import sdvae as jax_sdvae
from tinydiffusion_tpu.compat.latent_codec import LinearPatchCodec as JaxCodec
from tinydiffusion_tpu.compat.sdvae import SDVAEFlaxCodec as JaxSDVAECodec
from tinydiffusion_tpu.compat.text_encoder import HashTextEncoder as JaxHashTextEncoder
from tinydiffusion_tpu.core import process as jax_process
from tinydiffusion_tpu.core.embeddings import sinusoidal_time_embedding as jax_sinusoid
from tinydiffusion_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from tinydiffusion_tpu.data import laion as jax_laion
from tinydiffusion_tpu.experiments import conditional_diffusion_laion as jax_exp
from tinydiffusion_tpu.io.checkpoint import _flat_items, restore_weights
from tinydiffusion_tpu.models.unet_latent import LatentUNet as JaxLatentUNet
from tinydiffusion_tpu.train.trainer import DiffusionTrainState as JaxTrainState
from tinydiffusion_torch.compat import latent_codec, sdvae, text_encoder
from tinydiffusion_torch.core.embeddings import sinusoidal_time_embedding
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data import laion
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.experiments import conditional_diffusion_laion as exp
from tinydiffusion_torch.io.checkpoint import load_sidecar, load_weights_arrays
from tinydiffusion_torch.io.from_jax import jax_variables, state_dict_by_name
from tinydiffusion_torch.models.unet_latent import LatentUNet
from tinydiffusion_torch.nn.layers import computing_in
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.train.trainer import (
    _scheduled_lr_,
    clip_by_global_norm_,
    create_train_state,
    make_laion_eval_step,
    make_laion_train_step,
    make_resident_laion_multi_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "checkpoints", "laion_diffusion_1000ep")
PROMPTS = exp.SAMPLE_PROMPTS
# float32 eps of the full-width UNet on the committed weights: summation
# order over up to 2304 terms a layer (3x3 convs of 256 channels), outputs of
# order 1.
F32_ATOL = 1e-4
# bfloat16 against JAX's model dtype run eagerly: the port rounds where
# flax's code rounds (``nn.layers``); the convolutions' float32 summation
# orders still part in ~0.01 % of a layer's outputs, and each flip spreads
# through the next 3x3 convs, so 28 % of the eps differ, by a mean |diff| of
# 1.8e-3 (seen on the CPU; 7.5e-3 under autocast). eps is of order 1.
BF16_MEAN_ABS = 4e-3
# One Adam step (clip 10, the cosine rate) from the committed weights at
# B = 2, float32: the loss 1e-5 relative; the update's direction by its
# cosine; the BN running statistics 1e-4 relative (flax's batch variance is
# E[x^2] - E[x]^2, the port's two-pass). Adam starts from a state with
# second moments ADAM_NU: from zero moments its update is about lr *
# sign(g), and every element whose gradient is of the order of float32
# rounding would take either sign (read 0.99987 here, against 1 - 1e-8).
STEP_LOSS_RTOL, STEP_MIN_UPDATE_COS, STATS_RTOL, STATS_ATOL = 1e-5, 0.9999, 1e-4, 1e-6
ADAM_NU = 1e-6
BATCH = 2
# The cosine rate against optax's: 1e-6 relative, and where 1 + cos(.)
# cancels (next to T_max, the rate near lr_min) one float32 ulp of the
# cosine times the amplitude (lr - lr_min) / 2: XLA's and torch's float32
# cosines may differ in their last bit, which the cancellation lifts to
# 2.6e-6 of the rate at count 1022.
LR, LR_MIN = 1e-4, 1e-6
LR_RTOL, LR_ATOL = 1e-6, 0.5 * (LR - LR_MIN) * 2.0**-23


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on a few cores. One torch thread,
    restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_variables(jmodel) -> dict:
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 4)), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, 768))))
    return restore_weights(CHECKPOINT, dict(shapes))


def _port_model() -> LatentUNet:
    model = LatentUNet()
    model.load_state_dict(state_dict_by_name(load_weights_arrays(CHECKPOINT)))
    return model


def _codec_pair():
    state = load_sidecar(CHECKPOINT)["metadata"]["codec_state"]
    jcodec, codec = JaxCodec(), latent_codec.LinearPatchCodec()
    jcodec.load_state_dict(state)
    codec.load_state_dict(state)
    return jcodec, codec


def _latents(seed: int, n: int):
    """(n, 32, 32, 4) NHWC latents, t with 0 and 999, and n prompt embeddings."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 32, 32, 4)).astype(np.float32)
    t = rng.integers(0, 1000, n).astype(np.int32)
    t[:2] = (0, 999)
    ctx = text_encoder.HashTextEncoder().encode([PROMPTS[i % 4] for i in range(n)])
    return z, t, ctx


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


# --- the model ----------------------------------------------------------------------


@pytest.mark.parametrize("dim", [768, 33])
def test_sinusoid_matches_jax(dim):
    """Host float64 frequencies cast to float32, divisor half - 1, sin
    before cos, a zero pad for odd dims: within 2e-6 (float32 sin/cos of
    arguments up to 999)."""
    t = np.array([0, 1, 17, 500, 999], np.int32)
    want = np.asarray(jax_sinusoid(jnp.asarray(t), dim))
    got = sinusoidal_time_embedding(torch.from_numpy(t).long(), dim).numpy()
    assert got.shape == want.shape == (5, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    if dim % 2:
        assert (got[:, -1] == 0).all()


def test_bridge_fills_every_slot_and_inverts():
    """The committed npz (94 entries: 92 params and BN statistics, the step
    and the format's ``__meta__``) fills every slot of the port's UNet by
    name, and ``jax_variables`` gives back the same keys and values."""
    with np.load(CHECKPOINT + ".npz") as z:
        assert len(z.files) == 94
    flat = load_weights_arrays(CHECKPOINT)
    model = LatentUNet()
    model.load_state_dict(state_dict_by_name(flat), strict=True)
    back = jax_variables(model)
    assert set(back) == set(flat) - {"step"}
    for key, value in back.items():
        np.testing.assert_array_equal(value, flat[key], err_msg=key)


def test_eval_forward_matches_jax_in_float32():
    jmodel = JaxLatentUNet()
    variables = _jax_variables(jmodel)
    z, t, ctx = _latents(0, 4)
    want = np.asarray(jmodel.apply(variables, z, t, ctx, train=False)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = _port_model().eval()(_nchw(z), torch.from_numpy(t).long(), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_eval_forward_matches_jax_in_bfloat16():
    """JAX's ``LatentUNet(dtype=bfloat16)`` against the port's
    (``computing_in``), which casts the sinusoid and the context to bfloat16
    as flax does (adding a float32 context would give a float32 sum)."""
    jmodel = JaxLatentUNet(dtype=jnp.bfloat16)
    variables = _jax_variables(jmodel)
    z, t, ctx = _latents(1, 4)
    want = np.asarray(jmodel.apply(variables, z, t, ctx, train=False)).transpose(0, 3, 1, 2)
    model = _port_model().eval()
    with torch.no_grad(), computing_in(model, torch.bfloat16):
        got = model(_nchw(z), torch.from_numpy(t).long(), torch.from_numpy(ctx)).numpy()
    mean_abs = np.abs(got - want).mean()
    print(f"LatentUNet bf16 eval vs JAX: mean |diff| {mean_abs:.3e}, "
          f"max {np.abs(got - want).max():.3e}")
    assert mean_abs <= BF16_MEAN_ABS, mean_abs
    assert mean_abs > 0  # bfloat16 did run


# --- the offline seams and records ----------------------------------------------------


def test_hash_embeddings_are_jax_bits(monkeypatch):
    """The hash embeddings to the bit; ``"hash"`` and ``"auto"`` without a
    CLIP directory give the hash encoder. The pretrained seams reach their
    loaders: ``"clip"`` without a directory and ``"sd"`` go to
    ``from_pretrained`` (``ImportError`` without transformers and diffusers,
    refused here so that nothing reaches for the network), and a CLIP
    directory that holds no files fails its load."""
    texts = PROMPTS + ["", "A Photo  of a CAT", "zebra ünïcode"]
    np.testing.assert_array_equal(text_encoder.HashTextEncoder().encode(texts),
                                  JaxHashTextEncoder().encode(texts))
    assert isinstance(text_encoder.get_text_encoder("hash"), text_encoder.HashTextEncoder)
    assert isinstance(text_encoder.get_text_encoder("auto"), text_encoder.HashTextEncoder)
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "diffusers", None)
    with pytest.raises(ImportError, match="transformers"):
        text_encoder.get_text_encoder("clip", device="cpu")
    with pytest.raises(FileNotFoundError, match="clip_text.pth"):
        text_encoder.get_text_encoder("auto", clip_local_dir="/some/clip_dir", device="cpu")
    with pytest.raises(ImportError, match="diffusers"):
        latent_codec.get_latent_codec("sd")


def _cache_dirs(root) -> dict:
    """A run's own JPEG cache and failed-URL list under ``root``: a cold
    cache, shared with no other test."""
    return {"image_cache_dir": str(root / "laion_cache"),
            "failed_urls_cache": str(root / "failed_urls.json")}


def test_offline_records_and_valid_subset_are_jax_bits(tmp_path, monkeypatch):
    """The synthetic records, the valid subset (an empty caption is dropped)
    and each image bit-equal: ``synthesize_image`` as JAX's dataset first
    reads it, from a cold cache, and the port's dataset as a second JAX
    read, which decodes the JPEG that the first one cached: what JAX's
    ``run`` stacks (after ``precache_dataset``'s read)."""
    n, size = 10, 64
    records = laion.load_laion_dataset(n)
    assert records == jax_laion.load_laion_dataset(n, offline=True)
    records[3] = dict(records[3], TEXT="")

    def jax_dataset(cache: str):
        return jax_laion.LAIONImageTextDataset(
            records, cache_dir=str(tmp_path / cache), failed_urls_cache=str(tmp_path / "f.json"),
            image_size=size, normalize=True, on_error="raise", as_uint8=True)

    valid = jax_laion.precache_dataset(jax_dataset("precache"))
    assert valid == [i for i in range(n) if i != 3]
    ds = jax_dataset("cold")
    cold = [ds[i] for i in valid]
    port = laion.LAIONImageTextDataset(
        records, cache_dir=str(tmp_path / "port"), failed_urls_cache=str(tmp_path / "p.json"),
        image_size=size, normalize=True, on_error="raise", as_uint8=True)
    assert laion.precache_dataset(port) == valid
    items = [port[i] for i in valid]
    images, texts = np.stack([x for x, _ in items]), [t for _, t in items]
    assert texts == [text for _, text in cold]
    np.testing.assert_array_equal(np.stack([laion.synthesize_image(i, size)[0] for i in valid]),
                                  np.stack([x for x, _ in cold]))
    warm = np.stack([ds[i][0] for i in valid])
    np.testing.assert_array_equal(images, warm)
    assert not np.array_equal(warm, np.stack([x for x, _ in cold]))
    monkeypatch.setitem(sys.modules, "datasets", None)  # so nothing is fetched
    with pytest.raises(RuntimeError, match="'datasets' package"):
        laion.load_laion_dataset(n, offline=False)


def test_codec_matches_jax():
    """The seed-7 QR init and a calibration bit-equal (numpy float64 eigh on
    both sides); encode and decode in the committed basis within 1e-6 of the
    largest value (192-term float32 dot products in another order); the
    state round trip as the same JSON."""
    jcodec, codec = JaxCodec(), latent_codec.LinearPatchCodec()
    np.testing.assert_array_equal(codec.w.numpy(), np.asarray(jcodec.w))
    rng = np.random.default_rng(3)
    images = rng.uniform(-1, 1, (3, 256, 256, 3)).astype(np.float32)
    assert codec.calibrate(_nchw(images)) == jcodec.calibrate(jnp.asarray(images))
    assert json.dumps(codec.state_dict()) == json.dumps(jcodec.state_dict())
    jcodec, codec = _codec_pair()
    want = np.asarray(jcodec.encode(jnp.asarray(images)))
    got = codec.encode(_nchw(images))
    assert got.shape == (3, 4, 32, 32) and got.is_contiguous()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    want_x = np.asarray(jcodec.decode(jnp.asarray(want)))
    got_x = codec.decode(_nchw(want)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-6 * np.abs(want_x).max())
    assert json.dumps(codec.state_dict()) == json.dumps(jcodec.state_dict())
    small = latent_codec.LinearPatchCodec(image_size=64)
    with pytest.raises(ValueError, match="geometry"):
        small.load_state_dict(codec.state_dict())


# --- the train and eval steps -----------------------------------------------------------


def _images(seed: int, n: int = BATCH) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 256, 256, 3)) * (2.0 / 255.0) - 1.0).astype(np.float32)


@pytest.mark.parametrize("caption_dropout", [0.0, 0.5])
def test_laion_step_matches_jax(caption_dropout):
    """One clip(10) + Adam step at the cosine rate from the committed weights
    (its count 13 past T_max 10, where the rate has turned back up): the port gets
    the t, the noise and the caption-dropout mask that JAX's step draws from
    ``split(state.rng, 4 or 5)``; the loss, the update's direction and the
    train-mode BatchNorm statistics after the step."""
    jcodec, codec = _codec_pair()
    jmodel = JaxLatentUNet()
    variables = _jax_variables(jmodel)
    t_max, count = 10, 13
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adam(jax_exp.cosine_annealing_lr(LR, LR_MIN, t_max)))
    clip_state, (adam_state, sched_state) = tx.init(variables["params"])
    c = jnp.asarray(count, jnp.int32)
    nu = jax.tree_util.tree_map(lambda p: jnp.full_like(p, ADAM_NU), variables["params"])
    opt_state = (clip_state, (adam_state._replace(count=c, nu=nu), sched_state._replace(count=c)))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=opt_state,
                           rng=jax.random.PRNGKey(8))
    images = _images(8)
    ctx = text_encoder.HashTextEncoder().encode(PROMPTS[1:3])
    null = text_encoder.HashTextEncoder().encode([""])[0]
    keys = jax.random.split(jstate.rng, 5 if caption_dropout else 4)
    t = np.array(jax.random.randint(keys[1], (BATCH,), 0, 1000))
    noise = np.array(jax.random.normal(keys[2], (BATCH, 32, 32, 4)))
    keep = (np.array(jax.random.bernoulli(keys[4], 1.0 - caption_dropout, (BATCH,)))
            if caption_dropout else None)
    jstep = jax.jit(jax_exp._laion_raw_step(
        jmodel, tx, JaxSchedule.linear(1000), jcodec, caption_dropout=caption_dropout,
        null_embed=jnp.asarray(null) if caption_dropout else None))
    new_jstate, jloss = jstep(jstate, jnp.asarray(images), jnp.asarray(ctx))

    model = _port_model()
    optimizer = torch.optim.Adam(model.parameters(), lr=torch.tensor(LR))
    state = create_train_state(model, optimizer, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # Adam's state as JAX's above: count 13, first moments 0, second ADAM_NU.
    for p in model.parameters():
        optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": torch.zeros_like(p),
                              "exp_avg_sq": torch.full_like(p, ADAM_NU)}
    step = make_laion_train_step(codec, _same_tables(JaxSchedule.linear(1000)),
                                 exp.cosine_annealing_lr(LR, LR_MIN, t_max),
                                 caption_dropout=caption_dropout,
                                 null_embed=torch.from_numpy(null) if caption_dropout else None)
    loss = step(state, _nchw(images), torch.from_numpy(ctx), t=torch.from_numpy(t).long(),
                noise=_nchw(noise), keep=None if keep is None else torch.from_numpy(keep))
    assert state.step == 1 and model.training
    if caption_dropout:
        assert 0 < keep.sum() < BATCH  # one row of each: the mask matters here
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=STEP_LOSS_RTOL)
    lr = optimizer.param_groups[0]["lr"].item()
    np.testing.assert_allclose(lr, float(jax_exp.cosine_annealing_lr(LR, LR_MIN, t_max)(count)),
                               rtol=LR_RTOL, atol=LR_ATOL)
    want, _ = _flat_items({"params": new_jstate.params,
                           "batch_stats": new_jstate.batch_stats})
    got = state.jax_weights()
    start = jax_variables(_port_model())
    assert {k for k in got if k != "step"} == set(want)
    ups, jups = [], []
    for key, value in want.items():
        value = np.asarray(value)
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got[key], value, rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=key)
        else:
            ups.append((got[key] - start[key]).ravel())
            jups.append((value - start[key]).ravel())
    ups, jups = np.concatenate(ups).astype(np.float64), np.concatenate(jups).astype(np.float64)
    cos = ups @ jups / (np.linalg.norm(ups) * np.linalg.norm(jups))
    assert cos >= STEP_MIN_UPDATE_COS, cos
    np.testing.assert_allclose(np.linalg.norm(ups), np.linalg.norm(jups), rtol=1e-3)
    assert not torch.equal(before["enc1.block1.bn.running_mean"],
                           model.state_dict()["enc1.block1.bn.running_mean"])


def test_laion_eval_step_matches_jax_on_its_draws():
    """The validation step: t and the q_sample seed come from the batch's
    key; JAX's eval math on those draws gives the same loss."""
    jcodec, codec = _codec_pair()
    jmodel = JaxLatentUNet()
    variables = _jax_variables(jmodel)
    images = _images(9)
    ctx = text_encoder.HashTextEncoder().encode(PROMPTS[:BATCH])
    key = (3, 2 * 10000 + 1)
    rng = np.random.default_rng(list(key))
    t = rng.integers(0, 1000, BATCH)
    seed = int(rng.integers(0, 2**63))
    schedule = DiffusionSchedule.linear(1000)
    noise = qsample.q_sample_fused_reference(schedule, torch.zeros(BATCH, 4, 32, 32),
                                             torch.from_numpy(t), seed)[1].numpy()
    latents = jcodec.encode(jnp.asarray(images))
    noise_nhwc = noise.transpose(0, 2, 3, 1)
    x_t = jax_process.q_sample_with_noise(JaxSchedule.linear(1000), latents, jnp.asarray(t),
                                          noise_nhwc)
    out = jmodel.apply(variables, x_t, jnp.asarray(t), ctx, train=False)
    want = float(jnp.mean((out - noise_nhwc) ** 2))
    model = _port_model().train()
    eval_step = make_laion_eval_step(codec, _same_tables(JaxSchedule.linear(1000)))
    got = eval_step(model, _nchw(images), key, torch.from_numpy(ctx))
    assert model.training  # eval mode only inside the step
    np.testing.assert_allclose(got.item(), want, rtol=STEP_LOSS_RTOL)


def test_cosine_rate_over_2500_steps_matches_optax():
    """``cosine_annealing_lr`` (T_max 1000, not clamped: down to lr_min at
    1000, back up to lr at 2000) at every count of 2500, and the rate the
    step writes before each Adam update (from Adam's own count) against
    optax's ``chain(clip_by_global_norm(10), adam(schedule))``: the rates,
    and the params after 2500 updates on the same gradients (some clipped),
    within 1e-6."""
    t_max, n = 1000, 2500
    jschedule = jax_exp.cosine_annealing_lr(LR, LR_MIN, t_max)
    schedule = exp.cosine_annealing_lr(LR, LR_MIN, t_max)
    counts = np.arange(n)
    want = np.asarray(jschedule(jnp.asarray(counts, jnp.int32)))
    got = schedule(torch.from_numpy(counts.astype(np.float32))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=LR_ATOL)
    np.testing.assert_allclose(want[[0, 1000, 2000]], [LR, LR_MIN, LR], rtol=1e-6)

    grads = np.random.default_rng(5).standard_normal((n, 6)).astype(np.float32)
    grads[::7] *= 20.0  # norms past 10: clipped
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(jschedule))
    w0 = jnp.ones(6)

    def body(carry, g):
        w, opt_state = carry
        updates, opt_state = tx.update(g, opt_state, w)
        return (optax.apply_updates(w, updates), opt_state), None

    (w, _), _ = jax.lax.scan(body, (w0, tx.init(w0)), jnp.asarray(grads))
    p = torch.nn.Parameter(torch.ones(6))
    adam = torch.optim.Adam([p], lr=torch.tensor(0.0))
    rates = []
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        clip_by_global_norm_([p], 10.0)
        _scheduled_lr_(adam, schedule)
        rates.append(adam.param_groups[0]["lr"].item())
        adam.step()
    np.testing.assert_allclose(rates, want, rtol=LR_RTOL, atol=LR_ATOL)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_resident_laion_steps_match_host_steps():
    """K = 3 resident steps (caption dropout 0.5, EMA) with their own draws
    against host steps on the gathered batches from the same start: the same
    generator draws in the same order, so the same losses, params and
    statistics to the bit."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    embeds = text_encoder.HashTextEncoder(32).encode([PROMPTS[i % 4] for i in range(8)])
    null = torch.from_numpy(text_encoder.HashTextEncoder(32).encode([""])[0])
    codec = latent_codec.LinearPatchCodec(image_size=64)
    schedule = DiffusionSchedule.linear(1000)
    options = dict(lr_schedule=exp.cosine_annealing_lr(LR, LR_MIN, 2), ema_decay=0.9,
                   caption_dropout=0.5, null_embed=null)

    def fresh():
        torch.manual_seed(0)
        model = LatentUNet(time_dim=32, base_width=8)
        return create_train_state(model, torch.optim.Adam(model.parameters(),
                                                          lr=torch.tensor(LR)), 3, ema=True)

    data = DeviceDataset(images, 2, seed=1, device="cpu", embeds=embeds,
                         u8_normalize=exp.LAION_U8_NORMALIZE)
    idxs = data.epoch_index_batches(0)[:3]
    resident_state = fresh()
    losses = make_resident_laion_multi_step(codec, schedule, data, **options)(
        resident_state, idxs)
    host_state = fresh()
    step = make_laion_train_step(codec, schedule, **options)
    host = []
    for row in idxs:
        x, e = data.gather(torch.from_numpy(row))
        np.testing.assert_array_equal(
            x.numpy(), images[row].astype(np.float32) * (2.0 / 255.0) - 1.0)
        host.append(step(host_state, x.permute(0, 3, 1, 2), e).item())
    assert losses.tolist() == host and resident_state.step == host_state.step == 3
    for a, b in zip(resident_state.model.state_dict().values(),
                    host_state.model.state_dict().values()):
        assert torch.equal(a, b)
    for name, e in resident_state.ema_params.items():
        assert torch.equal(e, host_state.ema_params[name])


# --- the SD-VAE codec in the step --------------------------------------------------------

# The JAX tests' tiny AutoencoderKL: 16² images to 4 x 8 x 8 latents.
TINY_VAE_CFG = {"block_out_channels": (16, 32), "layers_per_block": 1, "latent_channels": 4,
                "norm_num_groups": 4}
SD_IMAGE, SD_LATENT, SD_TIME_DIM, SD_WIDTH = 16, 8, 32, 4


def _sd_codec_pair(seed: int = 0):
    """The port's SD codec and JAX's from one random diffusers-named state dict."""
    torch.manual_seed(seed)
    state = sdvae.AutoencoderKL(**TINY_VAE_CFG).state_dict()
    return (JaxSDVAECodec.from_torch_state_dict(state, TINY_VAE_CFG),
            sdvae.SDVAECodec.from_torch_state_dict(state, TINY_VAE_CFG))


def _tiny_unet_pair():
    """A JAX ``LatentUNet`` at the tiny widths (seed 0) and the port's with its weights."""
    jmodel = JaxLatentUNet(time_dim=SD_TIME_DIM, in_channels=4, base_width=SD_WIDTH)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, SD_LATENT, SD_LATENT, 4)),
                            jnp.zeros((2,), jnp.int32), jnp.zeros((2, SD_TIME_DIM)))
    model = LatentUNet(time_dim=SD_TIME_DIM, base_width=SD_WIDTH, latent_size=SD_LATENT)
    flat, _ = _flat_items(variables)
    model.load_state_dict(state_dict_by_name({k: np.asarray(v) for k, v in flat.items()}))
    return jmodel, variables, model


def _sd_images(seed: int, n: int = BATCH) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SD_IMAGE, SD_IMAGE, 3)) * (2.0 / 255.0) - 1.0).astype(
        np.float32)


@pytest.mark.parametrize("caption_dropout", [0.0, 0.5])
def test_laion_step_with_the_sd_codec_matches_jax(caption_dropout):
    """One clip(10) + Adam step with the SD codec's stochastic encode, as in
    ``test_laion_step_matches_jax``: the port gets JAX's t, noise, caption
    mask and the encoder's Gaussian (``normal(enc_key)`` of
    ``split(state.rng, 4 or 5)``, NCHW) through ``(t, noise, keep,
    enc_noise)``; the loss, the update's direction and size, and the
    BatchNorm statistics after the step."""
    jcodec, codec = _sd_codec_pair()
    jmodel, variables, model = _tiny_unet_pair()
    t_max, count = 10, 13
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adam(jax_exp.cosine_annealing_lr(LR, LR_MIN, t_max)))
    clip_state, (adam_state, sched_state) = tx.init(variables["params"])
    c = jnp.asarray(count, jnp.int32)
    nu = jax.tree_util.tree_map(lambda p: jnp.full_like(p, ADAM_NU), variables["params"])
    opt_state = (clip_state, (adam_state._replace(count=c, nu=nu), sched_state._replace(count=c)))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=opt_state,
                           rng=jax.random.PRNGKey(11))
    images = _sd_images(12)
    hasher = text_encoder.HashTextEncoder(SD_TIME_DIM)
    ctx, null = hasher.encode(PROMPTS[1:3]), hasher.encode([""])[0]
    keys = jax.random.split(jstate.rng, 5 if caption_dropout else 4)
    t = np.array(jax.random.randint(keys[1], (BATCH,), 0, 1000))
    noise = np.array(jax.random.normal(keys[2], (BATCH, SD_LATENT, SD_LATENT, 4)))
    enc_noise = np.array(jax.random.normal(keys[3], (BATCH, SD_LATENT, SD_LATENT, 4)))
    keep = (np.array(jax.random.bernoulli(keys[4], 1.0 - caption_dropout, (BATCH,)))
            if caption_dropout else None)
    jstep = jax.jit(jax_exp._laion_raw_step(
        jmodel, tx, JaxSchedule.linear(1000), jcodec, caption_dropout=caption_dropout,
        null_embed=jnp.asarray(null) if caption_dropout else None))
    new_jstate, jloss = jstep(jstate, jnp.asarray(images), jnp.asarray(ctx))

    start = jax_variables(model)
    optimizer = torch.optim.Adam(model.parameters(), lr=torch.tensor(LR))
    state = create_train_state(model, optimizer, 0)
    for p in model.parameters():
        optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": torch.zeros_like(p),
                              "exp_avg_sq": torch.full_like(p, ADAM_NU)}
    step = make_laion_train_step(codec, _same_tables(JaxSchedule.linear(1000)),
                                 exp.cosine_annealing_lr(LR, LR_MIN, t_max),
                                 caption_dropout=caption_dropout,
                                 null_embed=torch.from_numpy(null) if caption_dropout else None)
    loss = step(state, _nchw(images), torch.from_numpy(ctx), t=torch.from_numpy(t).long(),
                noise=_nchw(noise), keep=None if keep is None else torch.from_numpy(keep),
                enc_noise=_nchw(enc_noise))
    if caption_dropout:
        assert 0 < keep.sum() < BATCH
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=STEP_LOSS_RTOL)
    want, _ = _flat_items({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats})
    got = state.jax_weights()
    assert {k for k in got if k != "step"} == set(want)
    ups, jups = [], []
    for key, value in want.items():
        value = np.asarray(value)
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got[key], value, rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=key)
        else:
            ups.append((got[key] - start[key]).ravel())
            jups.append((value - start[key]).ravel())
    ups, jups = np.concatenate(ups).astype(np.float64), np.concatenate(jups).astype(np.float64)
    cos = ups @ jups / (np.linalg.norm(ups) * np.linalg.norm(jups))
    assert cos >= STEP_MIN_UPDATE_COS, cos
    np.testing.assert_allclose(np.linalg.norm(ups), np.linalg.norm(jups), rtol=1e-3)
    # Without the seam the encoder's Gaussian comes from the state's
    # generator: another draw, so another loss.
    state.generator.manual_seed(0)
    drawn = step(state, _nchw(images), torch.from_numpy(ctx), t=torch.from_numpy(t).long(),
                 noise=_nchw(noise), keep=None if keep is None else torch.from_numpy(keep))
    assert np.isfinite(drawn.item()) and drawn.item() != loss.item()


def test_laion_eval_step_with_the_sd_codec_matches_jax_on_its_draws():
    """The validation step: t, the q_sample seed and the seed of the
    encoder's generator come from the batch's key in that order; JAX's
    codec and eval math on those draws give the same loss."""
    jcodec, codec = _sd_codec_pair(1)
    jmodel, variables, model = _tiny_unet_pair()
    images = _sd_images(13)
    ctx = text_encoder.HashTextEncoder(SD_TIME_DIM).encode(PROMPTS[:BATCH])
    key = (3, 10000 + 2)
    rng = np.random.default_rng(list(key))
    t = rng.integers(0, 1000, BATCH)
    seed, enc_seed = int(rng.integers(0, 2**63)), int(rng.integers(0, 2**63))
    schedule = DiffusionSchedule.linear(1000)
    shape = (BATCH, 4, SD_LATENT, SD_LATENT)
    noise = qsample.q_sample_fused_reference(schedule, torch.zeros(shape), torch.from_numpy(t),
                                             seed)[1].numpy().transpose(0, 2, 3, 1)
    enc_noise = torch.randn(shape, generator=torch.Generator().manual_seed(enc_seed)).numpy()
    moments = jax_sdvae.vae_encode_moments(jcodec.params, jnp.asarray(images), TINY_VAE_CFG)
    mean, logvar = jnp.split(moments, 2, axis=-1)
    latents = (mean + jnp.exp(0.5 * jnp.clip(logvar, -30.0, 20.0))
               * enc_noise.transpose(0, 2, 3, 1)) * jcodec.scaling_factor
    x_t = jax_process.q_sample_with_noise(JaxSchedule.linear(1000), latents, jnp.asarray(t), noise)
    out = jmodel.apply(variables, x_t, jnp.asarray(t), ctx, train=False)
    want = float(jnp.mean((out - noise) ** 2))
    eval_step = make_laion_eval_step(codec, _same_tables(JaxSchedule.linear(1000)))
    got = eval_step(model.train(), _nchw(images), key, torch.from_numpy(ctx))
    np.testing.assert_allclose(got.item(), want, rtol=STEP_LOSS_RTOL)
    assert eval_step(model, _nchw(images), key, torch.from_numpy(ctx)).item() == got.item()


def test_resident_sd_steps_match_host_steps():
    """K = 3 resident steps with the SD codec (caption dropout, EMA) against
    host steps on the gathered batches: the encoder's Gaussian, t, the seed
    and the mask come from the generator in the same order, so the same
    losses and weights to the bit."""
    _, codec = _sd_codec_pair(2)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (8, SD_IMAGE, SD_IMAGE, 3), dtype=np.uint8)
    hasher = text_encoder.HashTextEncoder(SD_TIME_DIM)
    embeds = hasher.encode([PROMPTS[i % 4] for i in range(8)])
    options = dict(lr_schedule=exp.cosine_annealing_lr(LR, LR_MIN, 2), ema_decay=0.9,
                   caption_dropout=0.5, null_embed=torch.from_numpy(hasher.encode([""])[0]))
    schedule = DiffusionSchedule.linear(1000)

    def fresh():
        torch.manual_seed(0)
        model = LatentUNet(time_dim=SD_TIME_DIM, base_width=SD_WIDTH, latent_size=SD_LATENT)
        return create_train_state(model, torch.optim.Adam(model.parameters(),
                                                          lr=torch.tensor(LR)), 3, ema=True)

    data = DeviceDataset(images, 2, seed=1, device="cpu", embeds=embeds,
                         u8_normalize=exp.LAION_U8_NORMALIZE)
    idxs = data.epoch_index_batches(0)[:3]
    resident_state = fresh()
    losses = make_resident_laion_multi_step(codec, schedule, data, **options)(resident_state, idxs)
    host_state = fresh()
    step = make_laion_train_step(codec, schedule, **options)
    host = [step(host_state, x.permute(0, 3, 1, 2), e).item()
            for x, e in (data.gather(torch.from_numpy(row)) for row in idxs)]
    assert losses.tolist() == host and resident_state.step == host_state.step == 3
    for a, b in zip(resident_state.model.state_dict().values(),
                    host_state.model.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(resident_state.generator.get_state(), host_state.generator.get_state())


# --- the entry point --------------------------------------------------------------------


def test_config_takes_the_jax_flags():
    ours = {f.name: f.default for f in dataclasses.fields(exp.LaionDiffusionConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jax_exp.LaionDiffusionConfig)}
    assert set(ours) - set(theirs) == {"device"} and ours["device"] == "cuda"
    assert {k for k in theirs if ours[k] != theirs[k]} == {"model_save_path"}
    assert ours["model_save_path"].startswith("runs/")
    assert exp.SAMPLE_PROMPTS == jax_exp.SAMPLE_PROMPTS
    for lo, hi, every in ((0, 9, 10), (1, 10, 10), (11, 19, 10), (0, 0, 5), (5, 5, 5)):
        for positive in (False, True):
            assert (exp._window_contains_multiple(lo, hi, every, positive)
                    == jax_exp._window_contains_multiple(lo, hi, every, positive))


@pytest.mark.parametrize("field, value, error, match", [
    pytest.param("offline", False, RuntimeError, "'datasets' package",
                 id="offline-False-offline=True"),
    pytest.param("latent_codec", "sd", ImportError, "SD-VAE", id="latent_codec-sd-SD-VAE"),
    pytest.param("text_encoder", "clip", ImportError, "CLIP", id="text_encoder-clip-CLIP")])
def test_online_seams_raise(tmp_path, monkeypatch, field, value, error, match):
    """What needs the network fails ``run`` where JAX's fails: the online
    loader (``offline=False``) needs the ``datasets`` package, and the SD-VAE
    and CLIP without a local directory go to ``from_pretrained``, which
    needs diffusers or transformers (all three refused here, so nothing is
    fetched)."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "diffusers", None)
    monkeypatch.setitem(sys.modules, "datasets", None)
    config = exp.LaionDiffusionConfig(device="cpu", n_records=4, out_dir=str(tmp_path),
                                      model_save_path=str(tmp_path / "ckpt"),
                                      **_cache_dirs(tmp_path), **{field: value})
    with pytest.raises(error, match=match):
        exp.run(config)


def test_run_alike_on_both_placements_and_resumes_in_its_codec_basis(tmp_path):
    """The recipe at 64² images, B = 2 and 2 x 3 steps (caption dropout,
    EMA), host-streamed and resident: the same batches, draws and val keys,
    so the same losses and val losses to the bit, and the rate of each
    epoch's last update by the cosine. A second run on the resident run's
    checkpoint, over other records, resumes its state and the codec basis
    from its sidecar instead of calibrating anew."""
    results = {}
    for placement in ("host", "device"):
        out = tmp_path / placement
        config = exp.LaionDiffusionConfig(
            device="cpu", num_epochs=2, max_steps_per_epoch=3, batch_size=2, n_records=20,
            image_size=64, time_dim=32, log_every=1, num_timesteps=4, compute_dtype="float32",
            sample_every_batches=2, caption_dropout=0.5, guidance_scale=2.0, ema_decay=0.9,
            data_placement=placement, out_dir=str(out), model_save_path=str(out / "ckpt"),
            sample_every_epoch=placement == "device", **_cache_dirs(out))
        results[placement] = exp.run(config)
    host, resident = results["host"], results["device"]
    assert not host["resident"] and resident["resident"]
    assert host["losses"] == resident["losses"] and len(host["losses"]) == 6
    assert host["val_losses"] == resident["val_losses"] and len(host["val_losses"]) == 2
    assert resident["graph"] == {"eager": 6, "captures": 0, "replays": 0}
    assert resident["qsample_launches"] == {"train": 0, "eval": 0}  # the CPU runs no kernel
    lrs = [e["lr"] for e in resident["epochs"]]
    want = [float(jax_exp.cosine_annealing_lr(LR, LR_MIN, 2)(c)) for c in (2, 5)]
    np.testing.assert_allclose(lrs, want, rtol=LR_RTOL, atol=LR_ATOL)
    out = tmp_path / "device"
    names = {os.path.basename(p) for p in resident["grids"]}
    assert names == {"sampled_epoch0_batch2.png", "sampled_epoch1_batch2.png",
                     "samples_epoch_0.png", "samples_epoch_1.png", "final_samples.png"}
    for name in names:
        assert (out / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    with open(out / "laion-diffusion-model" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["val_loss"] for r in records if "val_loss" in r] == resident["val_losses"]
    sidecar = load_sidecar(str(out / "ckpt"))
    assert sidecar["metadata"]["codec_state"] == resident["codec"].state_dict()

    saved_step = torch.load(str(out / "ckpt.pt"), weights_only=True)["step"]
    config = dataclasses.replace(config, n_records=12, num_epochs=1, split_seed=7)
    again = exp.run(config)
    assert saved_step in (3, 6) and again["state"].step == saved_step + 3
    for a, b in zip((again["codec"].w, again["codec"].mean, again["codec"].scale),
                    (resident["codec"].w, resident["codec"].mean, resident["codec"].scale)):
        assert torch.equal(a, b)


def test_run_trains_on_clip_embeddings(tmp_path):
    """``run`` with ``text_encoder="clip"`` and a synthetic CLIP-L directory
    (``chip_smoke.write_synthetic_clip``) on the CPU: the seams resolve to
    the patch codec and CLIP, the steps run, and the sidecar keeps the
    directory and the codec's basis for serving (``test_torch_generate_laion``
    serves such a checkpoint)."""
    clip_dir = tmp_path / "clip"
    clip_dir.mkdir()
    write_synthetic_clip(str(clip_dir), seed=4)
    out = tmp_path / "run"
    config = exp.LaionDiffusionConfig(
        device="cpu", num_epochs=1, max_steps_per_epoch=2, batch_size=2, n_records=12,
        image_size=64, log_every=1, num_timesteps=4, compute_dtype="float32",
        sample_every_batches=0, sample_every_epoch=False, text_encoder="clip",
        clip_local_dir=str(clip_dir), out_dir=str(out), model_save_path=str(out / "ckpt"),
        **_cache_dirs(out))
    assert exp.resolve_seams(config) == ("patch", "clip")
    assert exp.resolve_seams(dataclasses.replace(config, text_encoder="auto")) == ("patch", "clip")
    result = exp.run(config)
    assert result["state"].step == 2 and result["resident"] and len(result["losses"]) == 2
    assert np.all(np.isfinite(result["losses"] + result["val_losses"]))
    sidecar = load_sidecar(str(out / "ckpt"))
    assert sidecar["config"]["text_encoder"] == "clip"
    assert sidecar["config"]["clip_local_dir"] == str(clip_dir)
    assert sidecar["metadata"]["codec_state"] == result["codec"].state_dict()
    assert (out / "final_samples.png").read_bytes()[:4] == b"\x89PNG"
