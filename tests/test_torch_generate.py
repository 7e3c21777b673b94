"""The port's serving CLI and its image I/O, on the CPU.

``obs/images.py``'s PNG reader, ``load_image28`` and labelled grids against
PIL and the JAX package's ``save_image_grid`` (the port's machines have no
PIL, so it keeps its own); ``tinydiffusion_torch.generate`` in every mode on
a small class-conditional checkpoint trained with label dropout, on the
committed CFG checkpoint, and its parser errors, which are the root
``generate.py``'s.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from chip_smoke import SERVE_FORWARDS, SERVE_REQUESTS
from tests.test_torch_diffusion import SMALL
from tests.test_torch_sampler_graph import stand_in  # noqa: F401 (a fixture)
from tinydiffusion_torch.core.graphs import GRAPH_WARMUP_STEPS
from tinydiffusion_tpu.obs.images import save_image_grid as jax_save_image_grid
from tinydiffusion_torch import generate, generate_laion
from tinydiffusion_torch.io.checkpoint import save_checkpoint
from tinydiffusion_torch.models.unet28 import UNet28
from tinydiffusion_torch.obs import images
from tinydiffusion_torch.train.trainer import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_CHECKPOINT = os.path.join(REPO, "checkpoints", "conditional_cfg_ema_best")
LAION_CHECKPOINT = os.path.join(REPO, "checkpoints", "laion_diffusion_1000ep")
LATENT_CHECKPOINT = os.path.join(REPO, "checkpoints", "latent_diffusion_best")
MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops; the suite runs several workers on a
    few cores, where torch's default of one thread a core oversubscribes
    them. One thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- PNG and load_image28 ----------------------------------------------------------


def _filtered_png(pixels: np.ndarray, kind: int) -> bytes:
    """A PNG whose every scanline uses filter ``kind`` (0-4), written here
    from the PNG specification's filter definitions."""
    h, w, c = pixels.shape
    raw = pixels.astype(np.int64).reshape(h, w * c)
    lines = []
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        lines.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(lines))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reader_reads_every_filter_and_pil_files(mode):
    c = MODES[mode]
    pixels = np.random.default_rng(c).integers(0, 256, (13, 17, c), dtype=np.uint8)
    for kind in range(5):
        png = _filtered_png(pixels, kind)
        np.testing.assert_array_equal(images.decode_png(png), pixels, err_msg=f"filter {kind}")
        pil = np.asarray(Image.open(io.BytesIO(png)))
        np.testing.assert_array_equal(pil.reshape(pixels.shape), pixels)
    for level in (0, 1, 9):  # PIL chooses its own filters
        buf = io.BytesIO()
        Image.fromarray(pixels[..., 0] if c == 1 else pixels, mode).save(
            buf, "PNG", compress_level=level)
        np.testing.assert_array_equal(images.decode_png(buf.getvalue()), pixels)
    np.testing.assert_array_equal(images.decode_png(images.encode_png(pixels)), pixels)


def test_png_reader_refuses_what_it_cannot_read():
    buf = io.BytesIO()
    Image.new("P", (4, 4)).save(buf, "PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        images.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        images.decode_png(b"GIF89a")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("size", [(28, 28), (56, 56), (100, 37), (31, 29), (13, 90)])
def test_load_image28_matches_pil(tmp_path, mode, size):
    """Pillow's ``convert("L").resize((28, 28))`` (the root generate.py's
    ``load_image28``), then [-1, 1]: the same bytes at 28x28 and when
    shrinking or stretching, so the same floats."""
    c = MODES[mode]
    rng = np.random.default_rng(size[0] * 7 + c)
    smooth = np.cumsum(rng.integers(0, 256, size + (c,)), axis=1) // np.arange(1, size[1] + 1)[
        None, :, None]
    for pixels in (rng.integers(0, 256, size + (c,)), smooth):
        pixels = pixels.astype(np.uint8)
        path = str(tmp_path / f"in_{mode}.png")
        Image.fromarray(pixels[..., 0] if c == 1 else pixels, mode).save(path)
        img = Image.open(path).convert("L").resize((28, 28))
        want = (np.asarray(img, np.float32) / 255.0 * 2 - 1).reshape(28, 28, 1)
        np.testing.assert_array_equal(images.load_image28(path), want)


def test_labelled_grid_equals_jax_byte_for_byte(tmp_path):
    """A 4x4 grid of 28x28 tiles with a digit on each, and a 2x2 grid with a
    two-digit label: the pixels JAX's grid writes through PIL."""
    rng = np.random.default_rng(0)
    for n, nrow, labels in ((16, 4, rng.integers(0, 10, 16)), (4, 2, [7, 10, 0, 99])):
        tiles = rng.uniform(0, 1, (n, 28, 28, 1)).astype(np.float32)
        jax_save_image_grid(tiles, str(tmp_path / "jax.png"), nrow=nrow, labels=labels)
        images.save_image_grid(tiles, str(tmp_path / "port.png"), nrow=nrow, labels=labels)
        want = np.asarray(Image.open(tmp_path / "jax.png"))
        np.testing.assert_array_equal(images.read_png(str(tmp_path / "port.png")), want)
    jax_save_image_grid(tiles, str(tmp_path / "jax.png"), nrow=2)
    images.save_image_grid(tiles, str(tmp_path / "port.png"), nrow=2)
    np.testing.assert_array_equal(images.read_png(str(tmp_path / "port.png"))[..., 0],
                                  np.asarray(Image.open(tmp_path / "jax.png")))
    # A character beyond printable ASCII is drawn as Pillow draws it (here
    # the font's missing-glyph box), where it once raised.
    canvas = Image.new("RGB", (24, 16))
    ImageDraw.Draw(canvas).text((0, 0), "-1\u00e9", fill=(255, 64, 64))
    pixels = np.zeros((16, 24, 3), np.uint8)
    images.draw_label(pixels, 0, 0, "-1\u00e9")
    np.testing.assert_array_equal(pixels, np.asarray(canvas))


# --- the serving CLI -------------------------------------------------------------------


def _small_cfg_checkpoint(path: str, num_timesteps: int = 20) -> str:
    """A base-width-8 class-conditional UNet28 with the null row and an EMA
    shadow, saved as the port's run saves it."""
    torch.manual_seed(0)
    model = UNet28(**SMALL, num_classes=11)
    state = create_train_state(model, torch.optim.Adam(model.parameters()), 0, ema=True)
    with torch.no_grad():
        for e in state.ema_params.values():
            e.mul_(0.5)  # a shadow unlike the params
    config = {**SMALL, "num_classes": 10, "label_dropout": 0.1, "num_timesteps": num_timesteps,
              "noise_schedule": "linear", "prediction": "eps"}
    save_checkpoint(path, state, config=config)
    return path


def _pngs(tmp_path):
    rng = np.random.default_rng(1)
    init = str(tmp_path / "init.png")
    mask = str(tmp_path / "mask.png")
    images.write_png(init, rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
    m = np.zeros((28, 28, 1), np.uint8)
    m[:, :14] = 255  # keep the left half
    images.write_png(mask, m)
    return init, mask


def _main(ckpt, out, *flags):
    return generate.main(["--checkpoint", ckpt, "--device", "cpu", "--n", "4", "--out", out,
                          *flags])


@pytest.mark.parametrize("flags, forwards", [
    (["--guidance-scale", "2.0", "--digit", "3"], 20),
    (["--sampler", "ddim", "--sample-steps", "5", "--eta", "1.0"], 5),
    (["--sampler", "dpmpp", "--sample-steps", "6", "--guidance-scale", "3.0"], 6),
    (["--sampler", "ddim", "--sample-steps", "40", "--init-image", "INIT", "--strength",
      "0.4"], 9),
    (["--sampler", "ddim", "--sample-steps", "5", "--inpaint-image", "INIT",
      "--inpaint-mask", "MASK"], 5),
    (["--inpaint-image", "INIT", "--inpaint-mask", "MASK", "--sample-dtype", "bfloat16"], 20),
])
def test_generate_serves_every_mode(tmp_path, capsys, flags, forwards):
    ckpt = _small_cfg_checkpoint(str(tmp_path / "cfg"))
    init, mask = _pngs(tmp_path)
    flags = [init if f == "INIT" else mask if f == "MASK" else f for f in flags]
    out = str(tmp_path / "out.png")
    result = _main(ckpt, out, *flags)
    samples = result["samples"]
    assert samples.shape == (4, 1, 28, 28) and torch.isfinite(samples).all()
    assert result["forwards"] == forwards and len(result["labels"]) == 4
    if "--digit" in flags:
        assert result["labels"] == [3] * 4
    assert images.read_png(out).shape == (2 + 2 * 30, 2 + 2 * 30, 3)  # labelled: RGB
    printed = capsys.readouterr().out
    assert "sampling from EMA params" in printed and f"{forwards} model forwards" in printed
    if "--inpaint-image" in flags:
        x_known = torch.from_numpy(images.load_image28(init)).permute(2, 0, 1)
        keep = torch.from_numpy(images.load_image28(mask) >= 0).permute(2, 0, 1)
        got = samples.float()
        assert torch.equal(got[:, keep], x_known.to(samples.dtype).float()[keep].expand(4, -1))
    if "--init-image" in flags:
        assert "t_start=8" in printed  # round(0.4 * 19)


def test_generate_serves_the_committed_cfg_checkpoint(tmp_path):
    """Full width, the EMA shadow, guidance 2, two DPM-Solver++ steps."""
    out = str(tmp_path / "cfg.png")
    a = _main(CFG_CHECKPOINT, out, "--sampler", "dpmpp", "--sample-steps", "2",
              "--guidance-scale", "2.0", "--digit", "7", "--seed", "3")
    b = _main(CFG_CHECKPOINT, out, "--sampler", "dpmpp", "--sample-steps", "2",
              "--guidance-scale", "2.0", "--digit", "7", "--seed", "3")
    assert a["forwards"] == 2 and torch.equal(a["samples"], b["samples"])
    assert torch.isfinite(a["samples"]).all() and a["labels"] == [7] * 4


def test_generate_counts_the_replayed_forwards_of_the_card_requests(tmp_path, capsys, stand_in):
    """``chip_smoke.py``'s five serving requests (guidance 2, digit 7) on a
    T = 1000 checkpoint, their chains replayed from stand-in graphs: the
    forwards come from the chains' counts (a forward hook would fire at the
    capture only), beside the captures and replays, as the card counts them."""
    ckpt = _small_cfg_checkpoint(str(tmp_path / "cfg"), num_timesteps=1000)
    init, mask = _pngs(tmp_path)
    for name, flags in SERVE_REQUESTS.items():
        flags = [init if f == "INIT" else mask if f == "MASK" else f for f in flags]
        result = _main(ckpt, str(tmp_path / f"{name}.png"), "--guidance-scale", "2.0",
                       "--digit", "7", *flags)
        forwards = SERVE_FORWARDS[name]
        assert (result["forwards"], result["captures"], result["replays"]) == (
            forwards, 2 if name == "ddpm1000" else 1, forwards - GRAPH_WARMUP_STEPS), name
        assert (f"{forwards} model forwards, {result['captures']} graph captures, "
                f"{forwards - GRAPH_WARMUP_STEPS} replays") in capsys.readouterr().out


def test_generate_laion_counts_the_replayed_forwards(tmp_path, stand_in):
    """``generate_laion``'s first request, DDIM-4 on the committed checkpoint
    with stand-in graphs: 4 forwards, 2 of them the warm-ups, the step
    captured once and replayed twice; the decode's graph waits for the second
    request (``--repeat 2``)."""
    out = generate_laion.main(["--device", "cpu", "--out", str(tmp_path / "out.png"),
                               "--checkpoint", LAION_CHECKPOINT, "--sampler", "ddim",
                               "--sample-steps", "4", "--prompt", "a photo of a dog",
                               "--dump-dir", str(tmp_path / "dump"), "--repeat", "2"])
    assert (out["forwards"], out["captures"], out["replays"]) == (4, 1, 2)
    assert [gens for _, gens in stand_in.captured] == [(), ()]  # DDIM at eta 0 draws nothing
    assert len(out["dumped"]) == 2


@pytest.mark.parametrize("flags, message", [
    (["--guidance-scale", "2.0"], "--guidance-scale needs a checkpoint trained with"),
    (["--init-image", "INIT"], "requires --sampler ddim"),
    (["--sampler", "ddim", "--init-image", "INIT", "--strength", "0"], "--strength must be"),
    (["--inpaint-image", "INIT"], "BOTH --inpaint-image and --inpaint-mask"),
    (["--sampler", "dpmpp", "--inpaint-image", "INIT", "--inpaint-mask", "MASK"],
     "inpainting requires --sampler ddpm or ddim"),
])
def test_generate_refuses_what_jax_refuses(tmp_path, capsys, flags, message):
    ckpt = str(tmp_path / "plain")
    torch.manual_seed(0)
    model = UNet28(**SMALL, num_classes=10)
    save_checkpoint(ckpt, create_train_state(model, torch.optim.Adam(model.parameters()), 0),
                    config={**SMALL, "num_classes": 10, "num_timesteps": 20})
    init, mask = _pngs(tmp_path)
    flags = [init if f == "INIT" else mask if f == "MASK" else f for f in flags]
    with pytest.raises(SystemExit) as exc:
        _main(ckpt, str(tmp_path / "x.png"), *flags)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_generate_refuses_a_latent_checkpoint(tmp_path, capsys):
    """A latent checkpoint is served (tests/test_torch_latent_serving.py),
    but not in a pixel mode: guidance is refused with JAX's message."""
    with pytest.raises(SystemExit) as exc:
        _main(LATENT_CHECKPOINT, str(tmp_path / "x.png"), "--guidance-scale", "2.0")
    assert exc.value.code == 2 and "pixel-checkpoint modes" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()
