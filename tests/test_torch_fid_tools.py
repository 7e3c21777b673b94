"""The port's FID tools (``tinydiffusion_torch/tools/fid_eval.py`` and
``fid_eval_laion.py``) against the JAX tools run in-process, on the CPU.

``parse_variant`` against JAX's on a table of tokens, errors included; the
MNIST tool's calibration rows (``--variants ''``) equal to JAX's; the LAION
tool at 64² with a seeded 3-block classifier (written by JAX's
``save_checkpoint`` and ``save_weights``) and a random 64² conv-VAE: the floor, the ceiling and
a ``samples_dir`` row equal to JAX's, and ``vae_recon`` from JAX's own noise
draws through the port's ``reconstruct``; the PNG reading of
``samples_dir`` against PIL byte for byte; and the MNIST tool end to end on
``diffusion_final`` (DDIM-2, n = 16).
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_diffusion import _write_idx
from tests.test_torch_imports import _random_weights_npz
from tinydiffusion_tpu.eval.fid import FeatureNet as JaxFeatureNet
from tinydiffusion_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from tinydiffusion_tpu.io.checkpoint import save_weights as jax_save_weights
from tinydiffusion_torch.data.mnist import load_mnist_u8
from tinydiffusion_torch.eval import fid
from tinydiffusion_torch.experiments.vae_laion import load_conv_vae, reconstruct
from tinydiffusion_torch.tools import fid_eval, fid_eval_laion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "checkpoints", "diffusion_final")
LATENT_CHECKPOINT = os.path.join(REPO, "checkpoints", "latent_diffusion_best")
# The rows of both tools come from float32 features that differ in summation
# order (~1e-6 relative) and are rounded to 3 or 4 decimals.
ROW_RTOL, ROW_ATOL = 1e-4, 2e-3


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """An MNIST data root of IDX files (which both loaders take over the
    synthetic set): 2048 synthetic train and 1024 test images, made once."""
    root = tmp_path_factory.mktemp("mnist")
    for train, n, prefix in ((True, 2048, "train"), (False, 1024, "t10k")):
        images, labels = load_mnist_u8(str(root / "synth"), train=train, synthetic_n=n)
        _write_idx(root / f"{prefix}-images-idx3-ubyte.gz", images[..., 0])
        _write_idx(root / f"{prefix}-labels-idx1-ubyte.gz", labels)
    return str(root)


TOKENS = ["ddpm", "ddim50", "ddpm-bf16", "ddim10-bf16", "dpmpp10", "dpmpp", "ddim",
          "dpmpp15-bf16", "plms", "ddim0", "dpmpp-3", "ddpm10", "ddimx", "-bf16", ""]


@pytest.mark.parametrize("token", TOKENS)
def test_parse_variant_matches_jax(token):
    jax_parse = _jax_tool("fid_eval").parse_variant
    try:
        want = jax_parse(token)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            fid_eval.parse_variant(token)
        return
    assert fid_eval.parse_variant(token) == want


def test_mnist_calibration_rows_equal_jax(data_root, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)  # the latent sidecar names its VAE from the repo root
    argv = ["--checkpoint", LATENT_CHECKPOINT, "--variants", "", "--n", "256",
            "--data-root", data_root, "--classifier", os.path.join(REPO, "checkpoints",
                                                                   "fid_classifier")]
    _jax_tool("fid_eval").main(argv + ["--json-out", str(tmp_path / "jax.jsonl")])
    with open(tmp_path / "jax.jsonl") as f:
        want = [json.loads(line) for line in f]
    got = fid_eval.main(argv + ["--device", "cpu", "--json-out", str(tmp_path / "port.jsonl")])
    with open(tmp_path / "port.jsonl") as f:
        assert [json.loads(line) for line in f] == got["rows"]
    assert [r["variant"] for r in got["rows"]] == ["real-train", "noise"]
    for g, w in zip(got["rows"], want):
        assert {k: v for k, v in g.items() if k != "fid"} == {
            k: v for k, v in w.items() if k != "fid"}
        assert g["fid"] == pytest.approx(w["fid"], rel=ROW_RTOL, abs=ROW_ATOL)


def _pil_rgb(paths, size):
    return np.stack([np.asarray(Image.open(p).convert("RGB").resize((size, size)))
                     for p in paths]).astype(np.float32) / 127.5 - 1.0


@pytest.fixture(scope="module")
def laion64(tmp_path_factory):
    """A seeded 3-block RGB classifier at 64² (bfloat16 values, so its npz
    and JAX's Orbax copy hold the same numbers), a random 64² conv-VAE, and
    a directory of PNGs in several modes and sizes."""
    tmp = tmp_path_factory.mktemp("laion64")
    model = JaxFeatureNet(num_classes=4, channels=fid_eval_laion.rgb_channels(64))
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)
    jax_save_checkpoint(str(tmp / "clf"), params,
                        config={"feature_dim": 128, "num_classes": 4, "channels": [32, 64, 128],
                                "image_size": 64})
    jax_save_weights(str(tmp / "clf"), params)  # the npz the port reads
    _random_weights_npz(str(tmp / "vae"), image_size=64)
    rng = np.random.default_rng(0)
    os.makedirs(tmp / "samples")
    for i, (mode, side) in enumerate([("RGB", 64), ("L", 50), ("RGBA", 90), ("RGB", 256)] * 2):
        channels = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
        pixels = rng.integers(0, 256, (side, side, channels), dtype=np.uint8)
        Image.fromarray(pixels[..., 0] if mode == "L" else pixels, mode).save(
            tmp / "samples" / f"s{i}.png")
    return tmp


def test_samples_dir_reading_equals_pil(laion64):
    paths = sorted(str(p) for p in (laion64 / "samples").iterdir())
    for size in (64, 28):
        np.testing.assert_array_equal(fid_eval_laion.read_samples(paths, size),
                                      _pil_rgb(paths, size))


def test_laion_rows_equal_jax(laion64, tmp_path):
    argv = ["--image-size", "64", "--n", "32", "--batch", "16", "--seed", "1",
            "--classifier", str(laion64 / "clf"), "--vae-checkpoint", str(laion64 / "vae"),
            "--samples-dir", str(laion64 / "samples")]
    want = _jax_tool("fid_eval_laion").main(argv + ["--json-out", str(tmp_path / "j.jsonl")])
    with open(tmp_path / "j.jsonl") as f:
        want = json.loads(f.readline())
    got = fid_eval_laion.main(argv + ["--device", "cpu"])
    assert set(got) == set(want)
    for key in ("calibration_floor_real_vs_real", "calibration_ceiling_real_vs_noise",
                "samples_dir[8]"):
        assert got[key] == pytest.approx(want[key], rel=ROW_RTOL, abs=ROW_ATOL), key
    # vae_recon through the port's reconstruct on JAX's draws: per batch,
    # split(key, 3) and eps = normal(k1, (B, latent_dim)).
    model = fid.load_feature_net(str(laion64 / "clf"), fid.FeatureNet(
        num_classes=4, channels=(32, 64, 128), in_channels=3, image_size=64)).eval()
    real = fid_eval_laion.synth_set(32, 64)[0]
    vae = load_conv_vae(str(laion64 / "vae"), device="cpu")
    key, recons = jax.random.PRNGKey(1 + 1), []
    for i in range(0, 32, 16):
        key, k1, _ = jax.random.split(key, 3)
        eps = torch.from_numpy(np.array(jax.random.normal(k1, (16, 128))))
        xb = torch.from_numpy(real[i:i + 16]).permute(0, 3, 1, 2).float() / 255.0
        recons.append(reconstruct(vae, xb, eps).permute(0, 2, 3, 1).numpy())
    real_stats = fid.frechet_gaussian_stats(
        fid.featurize(model, fid_eval_laion.to_m1(real), batch_size=16))
    recon_stats = fid.frechet_gaussian_stats(
        fid.featurize(model, np.concatenate(recons) * 2.0 - 1.0, batch_size=16))
    assert fid.fid_from_stats(*real_stats, *recon_stats) == pytest.approx(
        want["vae_recon"], rel=ROW_RTOL, abs=ROW_ATOL)


def test_mnist_tool_end_to_end_on_the_cpu(data_root, tmp_path):
    out = tmp_path / "rows.jsonl"
    result = fid_eval.main(["--checkpoint", CHECKPOINT, "--variants", "ddim2,ddim2-bf16",
                            "--n", "16", "--sample-batch", "8", "--data-root", data_root,
                            "--device", "cpu", "--json-out", str(out)])
    names = [r["variant"] for r in result["rows"]]
    assert names == ["real-train", "noise", "ddim2", "ddim2-bf16"]
    assert all(np.isfinite(r["fid"]) and r["fid"] > 0 and r["n"] == 16 for r in result["rows"])
    assert set(result["sample_s"]) == {"ddim2", "ddim2-bf16"}
    with open(out) as f:
        assert len(f.readlines()) == 4
