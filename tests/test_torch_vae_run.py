"""The port's conv-VAE training run against the JAX package, on the CPU.

Data (the offline image set, its val split and batch order), checkpoints (the
npz a port run writes, read by the JAX package) and ``run`` end to end: its
outputs, an exact ``--resume``, and the options it refuses.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinydiffusion_tpu.data.loader import BatchIterator as JaxBatchIterator
from tinydiffusion_tpu.experiments import common as jax_common
from tinydiffusion_tpu.experiments import vae_laion as jax_vae_laion
from tinydiffusion_tpu.experiments.vae_laion import ConvVAETrainState as JaxState
from tinydiffusion_tpu.experiments.vae_laion import VAELaionConfig as JaxConfig
from tinydiffusion_tpu.experiments.vae_laion import load_images as jax_load_images
from tinydiffusion_tpu.io.checkpoint import restore_weights
from tinydiffusion_tpu.io.checkpoint import save_weights as jax_save_weights
from tinydiffusion_tpu.models.vae_conv import ConvVAE as JaxConvVAE
from tinydiffusion_torch.data.loader import BatchIterator
from tinydiffusion_torch.experiments import vae_laion
from tinydiffusion_torch.experiments.vae_laion import (
    VAELaionConfig,
    create_train_state,
    load_images,
    make_optimizer,
    split_train_val,
)
from tinydiffusion_torch.io.checkpoint import save_checkpoint
from tinydiffusion_torch.models.vae_conv import ConvVAE
from tinydiffusion_torch.ops import attention

# The decoder in both packages from the same npz, float32: summation order
# through ~15 layers; the images are sigmoids in [0, 1].
IMAGE_ATOL = 1e-4
# The same in bfloat16: both round each layer's output to bf16, in other
# orders (test_torch_vae_conv.py's bound for a bf16 model's images).
BF16_IMAGE_ATOL = 2e-3


def test_config_has_every_jax_flag():
    ours = {f.name for f in dataclasses.fields(VAELaionConfig)}
    theirs = {f.name for f in dataclasses.fields(JaxConfig)}
    assert ours == theirs | {"device"}
    defaults = dataclasses.asdict(VAELaionConfig())
    for name, value in dataclasses.asdict(JaxConfig()).items():
        if name != "checkpoint_dir":  # the port's default keeps off the committed weights
            assert defaults[name] == value, name


def test_load_images_equals_jax_on_a_fresh_cache(tmp_path):
    config = JaxConfig(image_size=64, n_records=12, image_cache_dir=str(tmp_path / "cache"),
                       failed_urls_cache=str(tmp_path / "failed.json"))
    theirs = jax_load_images(config)
    ours = load_images(VAELaionConfig(image_size=64, n_records=12,
                                      image_cache_dir=str(tmp_path / "port_cache"),
                                      failed_urls_cache=str(tmp_path / "port_failed.json")))
    assert ours.dtype == theirs.dtype == np.uint8 and ours.shape == (12, 64, 64, 3)
    np.testing.assert_array_equal(ours, theirs)


def test_val_split_and_batch_order_equal_jax():
    images = np.random.default_rng(0).integers(0, 256, (45, 8, 8, 3)).astype(np.uint8)
    train, val = split_train_val(images)
    # JAX's run: n_val = max(len // 10, 1); val first (vae_laion.py:260-261).
    np.testing.assert_array_equal(val, images[:4])
    np.testing.assert_array_equal(train, images[4:])
    u8 = (1.0 / 255.0, 0.0)
    ours = BatchIterator([train], 4, shuffle=True, seed=42, u8_normalize=u8)
    theirs = JaxBatchIterator([train], 4, shuffle=True, seed=42, u8_normalize=u8,
                              device_normalize=True)
    for epoch in (1, 2):
        for (a,), (b,) in zip(ours.epoch(epoch), theirs.epoch(epoch), strict=True):
            np.testing.assert_array_equal(a, b)
    assert len(split_train_val(images[:5])[1]) == 1  # at least one val image


def test_port_npz_has_the_keys_of_a_jax_npz_and_decodes_in_jax(tmp_path):
    """A port-written checkpoint at 64x64: the key set, shapes and bfloat16
    list of a JAX-written one for the same config (``sigma`` included), and
    JAX's ConvVAE decodes from it what the port decodes."""
    jmodel = JaxConvVAE(latent_dim=128, image_size=64)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(1),
        train=False))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    jax_path = str(tmp_path / "jax" / "vae")
    jax_save_weights(jax_path, JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                        batch_stats=variables["batch_stats"], opt_state=None,
                                        rng=None))
    torch.manual_seed(0)
    model = ConvVAE(latent_dim=128, image_size=64).train()
    with torch.no_grad():  # a train forward moves u, sigma and the BN statistics
        model(torch.rand(2, 3, 64, 64), torch.randn(2, 128))
    state = create_train_state(model, make_optimizer(model, 1e-4), 0)
    port_path = str(tmp_path / "port" / "vae")
    config = {"latent_dim": 128, "input_channels": 3, "image_size": 64}
    save_checkpoint(port_path, state, config=config, metadata={"epoch": 3})

    with np.load(jax_path + ".npz") as a, np.load(port_path + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.endswith("/sigma") for k in b.files)
        for k in a.files:
            if k != "__meta__":
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        meta = [json.loads(bytes(z["__meta__"]).decode()) for z in (a, b)]
    assert sorted(meta[0]["bfloat16"]) == sorted(meta[1]["bfloat16"])
    with open(port_path + ".json") as f:
        assert json.load(f)["metadata"] == {"epoch": 3}

    restored = restore_weights(port_path, variables)
    z = np.random.default_rng(1).standard_normal((2, 128)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(
        v, a, train=False, method=JaxConvVAE.decode))(restored, jnp.asarray(z)))
    served = vae_laion.load_conv_vae(port_path, device="cpu")  # the bf16-rounded npz
    with torch.no_grad():
        got = served.decode(torch.from_numpy(z)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=IMAGE_ATOL)


def _run_config(tmp_path, **overrides) -> VAELaionConfig:
    """A small run's config; each call its own cold record cache, so every
    run trains on the synthesized bytes."""
    os.makedirs(tmp_path, exist_ok=True)
    cache = tempfile.mkdtemp(prefix="laion_cache", dir=tmp_path)
    fields = dict(image_size=128, n_records=40, batch_size=4, epochs=2, max_steps_per_epoch=3,
                  log_interval=1, n_images_to_log=4, out_dir=str(tmp_path / "out"),
                  checkpoint_dir=str(tmp_path / "ckpt"), device="cpu", image_cache_dir=cache,
                  failed_urls_cache=os.path.join(cache, "failed_urls.json"))
    fields.update(overrides)
    return VAELaionConfig(**fields)


def test_run_trains_on_the_cpu_and_writes_its_outputs(tmp_path, monkeypatch):
    """128x128, 40 records, 2 epochs of 3 steps: enc_attn0 (N = 4096) takes
    the flash path, its backward once a step."""
    calls = []
    flash_bwd = attention.flash_bwd
    monkeypatch.setattr(attention, "flash_bwd", lambda *a: calls.append(1) or flash_bwd(*a))
    config = _run_config(tmp_path)
    result = vae_laion.run(config)
    assert result["state"].step == 6 and len(calls) == 6
    assert len(result["test_losses"]) == 2 and np.isfinite(result["test_losses"]).all()
    out = config.out_dir
    for name in ("original_vs_reconstructed_epoch_1.png", "original_vs_reconstructed_epoch_2.png",
                 "generated_samples.png"):
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    with open(os.path.join(out, "vae_laion", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "bce" in r]
    assert len(steps) == 6 and all(np.isfinite(r["batch_train_loss"]) for r in steps)
    epochs = [r for r in records if "test_loss" in r]
    assert [r["epoch"] for r in epochs] == [1, 2]
    assert {"bce_epoch_max", "kld_epoch_max", "eval_nonfinite_batches"} <= epochs[0].keys()
    ckpt = os.path.join(config.checkpoint_dir, "vae_laion_best")
    for ext in (".pt", ".npz", ".json"):
        assert os.path.getsize(ckpt + ext) > 0
    with open(ckpt + ".json") as f:
        meta = json.load(f)["metadata"]
    best = int(np.argmin(result["test_losses"]))
    assert meta == {"metric": result["test_losses"][best], "epoch": best + 1}


def test_resume_continues_bit_identically(tmp_path):
    """Two epochs straight, against one epoch, a checkpoint and ``resume``
    for the second (32x32: every attention site dense, a fast step)."""
    small = dict(image_size=32, n_records=20, batch_size=2, max_steps_per_epoch=2,
                 latent_dim=16)
    straight = vae_laion.run(_run_config(tmp_path / "a", epochs=2, **small))
    first = vae_laion.run(_run_config(tmp_path / "b", epochs=1, **small))
    resumed = vae_laion.run(_run_config(tmp_path / "b", epochs=2, resume=True, **small))
    assert first["state"].step == 2 and resumed["state"].step == straight["state"].step == 4
    assert resumed["test_losses"] == straight["test_losses"][1:]
    a, b = straight["state"].model.state_dict(), resumed["state"].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_run_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA device"):
        vae_laion.run(_run_config(tmp_path, device="cuda"))


@pytest.mark.parametrize("field,value,match", [
    ("perceptual", "vgg19", "seeded"),
    ("compute_dtype", "float16", "bfloat16"),
])
def test_run_refuses_what_is_not_ported(field, value, match, tmp_path):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        vae_laion.run(_run_config(tmp_path, **{field: value}))


def test_vgg16_perceptual_needs_a_weights_file(tmp_path):
    with pytest.raises(ValueError, match="perceptual-weights"):
        vae_laion.run(_run_config(tmp_path, perceptual="vgg16"))


# --- the resident path and bfloat16 ------------------------------------------------


class _Resolved(Exception):
    """Stops a run where it has resolved its data placement."""


@pytest.mark.parametrize("placement", ["auto", "host", "device"])
def test_both_runs_take_the_same_path_for_the_same_flags(tmp_path, monkeypatch, placement):
    """JAX's ``run`` and the port's resolve the placement from the train
    split's bytes; both are stopped there and their decisions compared.
    ``"auto"`` is resident: the set fits."""
    seen = {}

    def recorder(side, resolve):
        def record(placement, dataset_bytes, *args, **kwargs):
            seen[side] = (resolve(placement, dataset_bytes, *args, **kwargs), dataset_bytes)
            raise _Resolved
        return record

    monkeypatch.setattr(jax_common, "resolve_data_placement",
                        recorder("jax", jax_common.resolve_data_placement))
    monkeypatch.setattr(vae_laion, "resolve_data_placement",
                        recorder("port", vae_laion.resolve_data_placement))
    small = dict(image_size=32, n_records=20, batch_size=2, latent_dim=16,
                 data_placement=placement)
    with pytest.raises(_Resolved):
        jax_vae_laion.run(JaxConfig(use_mesh=False, out_dir=str(tmp_path / "jax"),
                                    image_cache_dir=str(tmp_path / "cache"),
                                    failed_urls_cache=str(tmp_path / "failed.json"), **small))
    with pytest.raises(_Resolved):
        vae_laion.run(_run_config(tmp_path, **small))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == (placement != "host")


def _metrics(config: VAELaionConfig) -> tuple[list, list]:
    with open(os.path.join(config.out_dir, "vae_laion", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return ([r["batch_train_loss"] for r in records if "bce" in r],
            [r["test_loss"] for r in records if "test_loss" in r])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_resident_run_equals_the_host_run(tmp_path, compute_dtype):
    """On the CPU the resident path runs the same step eagerly on batches
    gathered from the pinned set: every step's loss, the val losses (the
    resident pass against the streamed one) and the final weights equal the
    host path's. 32x32: every attention site dense, a fast step."""
    small = dict(image_size=32, n_records=20, batch_size=2, latent_dim=16, log_interval=1,
                 compute_dtype=compute_dtype)
    runs = {}
    for placement in ("host", "device"):
        config = _run_config(tmp_path / placement, data_placement=placement, **small)
        result = vae_laion.run(config)
        runs[placement] = (result, *_metrics(config))
    (host, host_steps, host_val), (dev, dev_steps, dev_val) = runs["host"], runs["device"]
    assert not host["resident"] and dev["resident"]
    assert dev["graph"] == {"eager": 6, "captures": 0, "replays": 0}
    assert len(dev_steps) == 6 and dev_steps == host_steps
    assert dev_val == host_val and dev["test_losses"] == host["test_losses"]
    a, b = host["state"].model.state_dict(), dev["state"].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def _with_zero_image(monkeypatch, *where: int) -> None:
    """``load_images`` with the images ``where`` all zeros (failed downloads)."""
    load = vae_laion.load_images

    def load_with_zero(config):
        images = load(config).copy()
        images[list(where)] = 0
        return images

    monkeypatch.setattr(vae_laion, "load_images", load_with_zero)


def test_resident_set_excludes_an_all_zero_image_once(tmp_path, monkeypatch, capsys):
    """JAX's rule: the resident set leaves all-zero images out once, when it
    is pinned (the host path skips a batch that holds one, each epoch)."""
    _with_zero_image(monkeypatch, 5)  # in the train split (the first 2 are val)
    small = dict(image_size=32, n_records=20, batch_size=2, latent_dim=16, epochs=1,
                 max_steps_per_epoch=0, data_placement="device")
    result = vae_laion.run(_run_config(tmp_path, **small))
    out = capsys.readouterr().out
    assert out.count("Excluding 1 all-zero images from the device-resident set.") == 1
    assert result["state"].step == (18 - 1) // 2  # 17 images pinned, 8 full batches


def test_val_split_with_an_all_zero_image_stays_streamed(tmp_path, monkeypatch, capsys):
    """A val split holding an all-zero image keeps the host-streamed val pass
    and its all-zero-batch skip, on the resident path as on the host's: the
    same val losses."""
    _with_zero_image(monkeypatch, 0, 1)  # the first val batch
    small = dict(image_size=32, n_records=40, batch_size=2, latent_dim=16, epochs=1)
    losses = {}
    for placement in ("host", "device"):
        result = vae_laion.run(_run_config(tmp_path / placement, data_placement=placement,
                                           **small))
        losses[placement] = result["test_losses"]
    out = capsys.readouterr().out
    assert out.count("val split contains all-zero images; keeping the host-streamed") == 1
    assert "Batch 0 contains all-zero images, skipping." in out
    assert losses["device"] == losses["host"]


def test_bf16_run_writes_a_checkpoint_jax_reads(tmp_path):
    """A bfloat16 resident run at 64x64: its npz restores into JAX's
    ConvVAE(dtype=bfloat16), whose decode of the restored weights agrees with
    the port's bf16 model (the bf16 noise of test_torch_vae_conv's bound)."""
    config = _run_config(tmp_path, image_size=64, n_records=20, batch_size=2, epochs=1,
                         max_steps_per_epoch=2, compute_dtype="bfloat16",
                         data_placement="device")
    result = vae_laion.run(config)
    model = result["state"].model
    assert model.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    jmodel = JaxConvVAE(latent_dim=128, image_size=64, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(1), train=False))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    variables = restore_weights(os.path.join(config.checkpoint_dir, "vae_laion_best"), template)
    z = np.random.default_rng(2).standard_normal((2, 128)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(
        v, a, train=False, method=JaxConvVAE.decode))(variables, jnp.asarray(z)))
    assert want.dtype == np.float32 and np.isfinite(want).all()
    served = ConvVAE(latent_dim=128, image_size=64, dtype=torch.bfloat16)
    served.load_state_dict(vae_laion.load_conv_vae(
        os.path.join(config.checkpoint_dir, "vae_laion_best"), device="cpu").state_dict())
    with torch.no_grad():
        got = served.eval().decode(torch.from_numpy(z)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=BF16_IMAGE_ATOL)
