"""The port's CLIP seam against the JAX package, on the CPU.

``compat/clip_tokenizer.py`` (ids token for token against JAX's
``CLIPBPETokenizer`` on the synthetic vocabulary of
``tests/test_clip_tokenizer.py``; the hand-written word scanner against
CLIP's ``regex`` pattern over every assigned code point; the tokenizer with
``regex`` refused), ``compat/clip.py`` (``last_hidden_state`` and the pooled
row against ``clip_text_forward`` at a tiny config, and at CLIP-L's widths
on two prompts through ``from_local`` on both sides; a transformers
``CLIPTextModel`` state dict loaded ``strict``), ``io/from_jax.py``'s
``clip_text_from_jax`` and ``compat/text_encoder.py::get_text_encoder``'s
CLIP branches. Weights are random: seeded torch inits, or
``chip_smoke.write_synthetic_clip`` for CLIP-L.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import json
import sys
import unicodedata

import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from chip_smoke import synthetic_clip_vocab, write_synthetic_clip
from tests.test_clip_tokenizer import TINY_MERGES, _build_vocab
from tinydiffusion_tpu.compat.clip import CLIPTextConfig as JaxCLIPTextConfig
from tinydiffusion_tpu.compat.clip import CLIPTextFlaxEncoder, clip_text_forward, convert_clip_text
from tinydiffusion_tpu.compat.clip_tokenizer import CLIPBPETokenizer as JaxTokenizer
from tinydiffusion_torch.compat import clip, clip_tokenizer, text_encoder
from tinydiffusion_torch.io.from_jax import clip_text_from_jax

# Hidden states of the LayerNorm'd output, of order 1: float32 sums in
# another order, through up to 12 layers. As tight as the JAX package's own
# CLIP parity test (tests/test_pretrained_seams.py).
ATOL = RTOL = 1e-4
TINY = dict(vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=16)
# CLIP's word pattern, as the JAX copy compiles it with `regex`.
CLIP_PATTERN = regex.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)
TEXTS = {
    "ascii": ["the cat", "a photo of the cat", "", "sitting on the mat, and the cat sits 7"],
    "contractions": ["the cat's toy", "it'S THE cat'll", "''s 'd've 'RE", "don't 'ſ"],
    "unicode": ["café naïve ünïcode", "五十 cats ２ ⅷ ½ 三", "东京 tower 99", "zebra crossing\t!",
                "emoji 🐈 cat", "aͅb control\x07chars"],
    "long": [" ".join(["the cat and the dog"] * 30)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tok_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cliptok")
    with open(d / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(_build_vocab(), f, ensure_ascii=False)
    with open(d / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in TINY_MERGES))
    return str(d / "vocab.json"), str(d / "merges.txt")


@pytest.fixture(scope="module")
def clip_l_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_l")
    write_synthetic_clip(str(d), seed=3)
    return str(d)


@pytest.mark.parametrize("group", sorted(TEXTS))
def test_tokenizer_ids_match_jax(tok_files, group):
    """Tokens, the padded ids and mask (77, eos padding, truncation to 75
    ids between bos and eos) and the decode, equal to JAX's."""
    ours, theirs = clip_tokenizer.CLIPBPETokenizer.from_files(*tok_files), JaxTokenizer.from_files(
        *tok_files)
    texts = TEXTS[group]
    for text in texts:
        assert ours.tokenize(text) == theirs.tokenize(text), text
    got, want = ours(texts), theirs(texts, padding="max_length", max_length=77, truncation=True)
    for key in ("input_ids", "attention_mask"):
        assert got[key].shape == (len(texts), 77) and got[key].dtype == np.int64
        np.testing.assert_array_equal(got[key], want[key])
    for row in got["input_ids"]:
        assert ours.decode(row) == theirs.decode(row)
    if group == "long":
        assert got["attention_mask"].sum() == 77 and got["input_ids"][0, -1] == ours.eos_token_id


def test_word_scanner_matches_the_regex_pattern():
    """``words`` against CLIP's ``regex`` pattern around every code point
    that Python's Unicode tables assign (a newer ``regex`` may know letters
    that they do not): beside letters, digits, an apostrophe, a
    contraction, punctuation and itself."""
    points = [chr(c) for c in range(0x110000)
              if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
    for start in range(0, len(points), 512):
        text = "".join(f"a{c}b1{c}2'{c}{c}{c}'s-{c}- " for c in points[start : start + 512])
        assert clip_tokenizer.words(text) == CLIP_PATTERN.findall(text), start


def test_tokenizer_needs_no_regex(tok_files, monkeypatch):
    """With ``regex`` (and ``ftfy``) refused, the port's tokenizer builds and
    gives JAX's ids, computed before the refusal."""
    texts = TEXTS["unicode"] + TEXTS["contractions"]
    want = JaxTokenizer.from_files(*tok_files)(texts)["input_ids"]
    monkeypatch.setitem(sys.modules, "regex", None)
    monkeypatch.setitem(sys.modules, "ftfy", None)
    ours = clip_tokenizer.CLIPBPETokenizer.from_files(*tok_files)
    assert ours._fix_text is None
    np.testing.assert_array_equal(ours(texts)["input_ids"], want)


def test_synthetic_vocabulary_spells_the_caption_words():
    """The smoke run's vocabulary: specials at CLIP's ids, each caption word
    one token, every merge's symbol in the vocabulary."""
    vocab, merges = synthetic_clip_vocab()
    assert vocab[clip_tokenizer.BOS_TOKEN] == 49406 and vocab[clip_tokenizer.EOS_TOKEN] == 49407
    assert all(a + b in vocab for a, b in merges) and 200 <= len(merges) <= 400
    tok = clip_tokenizer.CLIPBPETokenizer(vocab, merges)
    assert tok.tokenize("a photo of a horse") == ["a</w>", "photo</w>", "of</w>", "a</w>",
                                                 "horse</w>"]


def test_tiny_forward_and_pooled_row_match_jax():
    """The port's transformer at a tiny config (4 heads, 2 layers) against
    ``clip_text_forward`` on JAX's conversion of the same weights: every
    position, the pooled last one, and the tree mapped back by
    ``clip_text_from_jax`` to the same state dict."""
    torch.manual_seed(0)
    config = clip.CLIPTextConfig(**TINY)
    model = clip.CLIPTextTransformer(config).eval()
    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"], (3, 16))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    tree = convert_clip_text(model.state_dict())
    want = np.asarray(clip_text_forward(tree, jnp.asarray(ids), JaxCLIPTextConfig(**TINY)))
    assert got.shape == want.shape == (3, 16, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[:, -1], want[:, -1], atol=ATOL, rtol=RTOL)
    back = clip_text_from_jax(tree)
    assert set(back) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key


def test_clip_l_encode_matches_jax_on_two_prompts(clip_l_dir):
    """CLIP-L's widths (49408 x 768, 12 layers of 12 heads, 3072 MLP, 77
    positions) from one synthetic directory: the port's ``from_local`` on the
    CPU against JAX's ``CLIPTextFlaxEncoder.from_local``, the pooled rows
    and every hidden state."""
    prompts = ["a photo of a cat", "a small painting of the sea at sunset, in winter!"]
    files = [f"{clip_l_dir}/{name}" for name in ("clip_text.pth", "vocab.json", "merges.txt")]
    ours = clip.CLIPTextEncoder.from_local(*files, device="cpu")
    theirs = CLIPTextFlaxEncoder.from_local(*files)
    assert ours.config == clip.CLIPTextConfig() and ours.dim == 768
    got = ours.encode(prompts)
    assert got.shape == (2, 768) and got.dtype == np.float32
    np.testing.assert_allclose(got, theirs.encode(prompts), atol=ATOL, rtol=RTOL)
    ids = ours.tokenizer(prompts)["input_ids"]
    with torch.no_grad():
        hidden = ours.model(torch.from_numpy(ids)).numpy()
    want = np.asarray(clip_text_forward(theirs.params, jnp.asarray(ids), theirs.config))
    np.testing.assert_allclose(hidden, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got, hidden[:, -1])  # the last position, padding


def test_from_local_loads_a_transformers_state_dict_strict(tok_files, tmp_path):
    """A transformers ``CLIPTextModel`` state dict, saved as transformers
    saves it (``text_model.`` keys, ``embeddings.position_ids`` in some
    versions), loads ``strict`` and encodes as transformers computes; a key
    missing from the file raises."""
    from transformers import CLIPTextConfig as HFConfig
    from transformers import CLIPTextModel

    vocab_size = len(_build_vocab())
    torch.manual_seed(1)
    hf = CLIPTextModel(HFConfig(**dict(TINY, vocab_size=vocab_size))).eval()
    state = dict(hf.state_dict())
    state["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    torch.save(state, tmp_path / "clip_text.pth")
    config = clip.CLIPTextConfig(**dict(TINY, vocab_size=vocab_size),
                                 layer_norm_eps=hf.config.layer_norm_eps,
                                 hidden_act=hf.config.hidden_act)
    enc = clip.CLIPTextEncoder.from_local(str(tmp_path / "clip_text.pth"), *tok_files,
                                          config=config, device="cpu")
    prompts = ["the cat sits", "and the cat's thing"]
    ids = enc.tokenizer(prompts)["input_ids"]
    assert ids.shape == (2, 16)
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).last_hidden_state[:, -1].numpy()
    np.testing.assert_allclose(enc.encode(prompts), want, atol=ATOL, rtol=RTOL)
    del state["text_model.final_layer_norm.bias"]
    torch.save(state, tmp_path / "clip_text.pth")
    with pytest.raises(RuntimeError, match="final_layer_norm.bias"):
        clip.CLIPTextEncoder.from_local(str(tmp_path / "clip_text.pth"), *tok_files,
                                        config=config, device="cpu")


def test_get_text_encoder_reaches_clip(clip_l_dir, monkeypatch):
    """``"clip"`` and ``"auto"`` with a directory build ``CLIPTextEncoder``
    on the asked device; ``"clip"`` without one goes to ``from_pretrained``,
    which raises ``ImportError`` where transformers is absent (refused here,
    so nothing reaches for the network); ``"hash"`` stays the hash encoder."""
    for name in ("clip", "auto"):
        enc = text_encoder.get_text_encoder(name, clip_local_dir=clip_l_dir, device="cpu")
        assert isinstance(enc, clip.CLIPTextEncoder) and enc.device == torch.device("cpu")
        assert next(enc.model.parameters()).device == torch.device("cpu")
    emb = enc.encode(["a photo of a dog", ""])
    assert emb.shape == (2, 768) and np.isfinite(emb).all() and not np.allclose(emb[0], emb[1])
    assert isinstance(text_encoder.get_text_encoder("hash"), text_encoder.HashTextEncoder)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        text_encoder.get_text_encoder("clip", device="cpu")
    with pytest.raises(ValueError, match="text_encoder"):
        text_encoder.get_text_encoder("t5")
