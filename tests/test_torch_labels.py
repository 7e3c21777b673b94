"""Labels beyond printable ASCII, drawn as Pillow draws them, on the CPU.

The JAX package labels grids with ``ImageDraw.text`` in Pillow's default
font, which draws any string: the glyphs the font holds, a box for those it
lacks, a new line at each newline. The port keeps that font as data
(``obs/font.py``) and composes the same pixels (``obs/images.py``); Pillow is
the oracle here and the port never imports it. ``generate_laion.main``
samples first and labels the grid after, so a prompt it could not label
used to lose the whole request.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from tests.test_torch_generate_laion import CHECKPOINT
from tinydiffusion_tpu.obs.images import save_image_grid as jax_save_image_grid
from tinydiffusion_torch import generate_laion
from tinydiffusion_torch.experiments.conditional_diffusion_laion import to_nhwc
from tinydiffusion_torch.obs import font, images

NON_ASCII = ["a café", "über", "straße", "a — b", "5 €", "猫", "the cat’s",
             "é", "ü", "ß", "—", "€", "’"]


def _pillow(text: str, size=(96, 40), origin=(3, 2)) -> np.ndarray:
    canvas = Image.new("RGB", size, (10, 20, 30))
    ImageDraw.Draw(canvas).text(origin, text, fill=(255, 64, 64))
    return np.asarray(canvas)


def _port(text: str, size=(96, 40), origin=(3, 2)) -> np.ndarray:
    pixels = np.empty((size[1], size[0], 3), np.uint8)
    pixels[...] = (10, 20, 30)
    images.draw_label(pixels, *origin, text)
    return pixels


@pytest.mark.parametrize("text", NON_ASCII)
def test_non_ascii_label_equals_pillow(text):
    np.testing.assert_array_equal(_port(text), _pillow(text))


def test_every_held_glyph_and_the_box_equal_pillow():
    """Each glyph of the table beyond ASCII, the box on characters the font
    lacks (a control character, Latin-1, CJK, an emoji), a newline, and
    all of them in one string between ASCII letters."""
    extra = "".join(ch for ch in font.GLYPHS if ord(ch) > 126)
    assert len(extra) == 18 and "’" in extra
    for text in [extra[:9], extra[9:], "\x07\x7fé一\U0001f600", "a\nb",
                 "ab" + extra[::3] + "éz"]:
        np.testing.assert_array_equal(_port(text, (160, 48)), _pillow(text, (160, 48)),
                                      err_msg=repr(text))


def test_the_box_is_what_the_font_draws_for_a_missing_glyph():
    """The table's box against a fresh render of the font's missing glyph."""
    default = ImageFont.load_default()
    canvas = Image.new("L", (16, 16))
    ImageDraw.Draw(canvas).text((4, 4), "一", fill=255, font=default)
    mask = np.asarray(canvas)
    left, top, advance, rows = font.MISSING_GLYPH
    box = np.array([[int(r[i : i + 2], 16) for i in range(0, len(r), 2)] for r in rows.split()])
    assert advance == default.getlength("一")
    np.testing.assert_array_equal(mask[4 + top : 4 + top + box.shape[0],
                                       4 + left : 4 + left + box.shape[1]], box)
    assert mask.sum() == box.sum()


def test_generate_laion_writes_a_grid_for_non_ascii_prompts(tmp_path):
    """DDIM-2 on two non-ASCII prompts: the grid is written, its labels the
    pixels JAX's grid draws on the same samples."""
    prompts = ["a café at night", "猫 — the cat’s €5"]
    out = generate_laion.main(["--device", "cpu", "--out", str(tmp_path / "port.png"),
                               "--checkpoint", CHECKPOINT, "--sampler", "ddim",
                               "--sample-steps", "2", "--prompt", prompts[0],
                               "--prompt", prompts[1]])
    assert out["prompts"] == prompts
    tiles = to_nhwc(out["images"])
    jax_save_image_grid(tiles, str(tmp_path / "jax.png"), nrow=2, normalize=False,
                        labels=prompts)
    np.testing.assert_array_equal(images.read_png(str(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))
