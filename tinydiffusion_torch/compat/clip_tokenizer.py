"""CLIP's byte-level BPE tokenizer, offline, from ``vocab.json`` and ``merges.txt``.

Copy of ``CLIPBPETokenizer`` from ``tinydiffusion_tpu/compat/clip_tokenizer.py``
(the reference tokenizes with ``transformers.CLIPTokenizer``, padded to the
model's 77 tokens, conditional_diffusion_laion.py:209-218): each word's UTF-8
bytes map to printable symbols (``byte_to_unicode``), the lowest-ranked
adjacent pair is merged until none is in the merge table, the word's last
symbol carries the ``</w>`` marker, and the ids are framed as
``<|startoftext|> ids <|endoftext|>`` and padded with the eos id.

Text cleanup follows transformers' split: with ``ftfy`` importable,
``fix_text`` then whitespace collapsed and lower-cased; without it, the
BasicTokenizer-style pass (control characters dropped, CJK ideographs
spaced, NFC, whitespace split, lower-cased; no accent stripping, no
punctuation split).

CLIP's word pattern needs ``\\p{L}`` and ``\\p{N}``, which the standard
``re`` module lacks; the JAX copy takes them from ``regex``, which ships with
``transformers`` and is not on the card. ``words`` scans the same pattern by
hand: the two special tokens, the contractions ``'s 't 're 've 'm 'll 'd``
(case-insensitive, as the pattern is compiled), a run of letters, a single
number character, or a run of anything else that is not whitespace, the
first alternative that matches winning at each position. Letters and
numbers are the characters whose Unicode category starts with ``L`` or
``N`` (``str.isnumeric`` would also take CJK numeral ideographs, which are
``Lo``).
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache
from typing import Sequence

import numpy as np

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"
# The pattern's literal alternatives, in its order: a contraction is tried
# before the letter run, so "'s" wins over "'" followed by "s".
_LITERALS = (BOS_TOKEN, EOS_TOKEN, "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# CLIP reads this many merge rows after the "#version" header.
N_MERGES = 49152 - 256 - 2


@lru_cache()
def byte_to_unicode() -> dict[int, str]:
    """The GPT-2/CLIP reversible byte -> printable character table: printable
    latin-1 bytes map to themselves, the others to U+0100 upwards."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table, offset = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + offset)
            offset += 1
    return table


def _is_control(ch: str) -> bool:
    return ch not in ("\t", "\n", "\r") and unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _basic_clean(text: str) -> str:
    """transformers' no-ftfy path: BasicTokenizer(strip_accents=False,
    do_split_on_punc=False), rejoined with single spaces."""
    out = []
    for ch in text:
        if ord(ch) in (0, 0xFFFD) or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in out)
    text = unicodedata.normalize("NFC", text)
    return " ".join(tok.lower() for tok in text.split())


def _ftfy_clean(text: str, fix_text) -> str:
    """transformers' ftfy path: ``fix_text``, whitespace collapsed, lower-cased."""
    return re.sub(r"\s+", " ", fix_text(text)).strip().lower()


# ``str.isspace`` also holds for these separators, which are not Unicode
# White_Space (``\\s`` in the pattern). Cleaning drops them before the scan.
_NOT_WHITESPACE = frozenset("\x1c\x1d\x1e\x1f")


def _class(ch: str) -> str:
    """``"L"`` (a letter), ``"N"`` (a number), ``"O"`` (another character
    that is not whitespace) or ``" "`` (a character no alternative matches).

    The pattern is compiled case-insensitively, so a character that is no
    letter or number while one of its case variants is (the combining
    ypogegrammeni U+0345, ``Mn``, folds to iota) is outside the negated
    class too: no alternative matches it, as none matches whitespace."""
    if ch.isspace() and ch not in _NOT_WHITESPACE:
        return " "
    cat = unicodedata.category(ch)[0]
    if cat in ("L", "N"):
        return cat
    variants = (ch.lower(), ch.upper(), ch.casefold())
    if any(len(c) == 1 and unicodedata.category(c)[0] in ("L", "N") for c in variants):
        return " "
    return "O"


def _same_letter(ch: str, lit: str) -> bool:
    """Whether ``ch`` matches the ASCII ``lit`` case-insensitively, by simple
    case folding (the long s ``ſ`` matches ``s``, as ``regex.IGNORECASE`` has it)."""
    return ch == lit or ch.lower() == lit or ch.upper() == lit.upper()


def _literal_at(text: str, i: int) -> int:
    """The length of the first of ``_LITERALS`` that matches at ``i``, or 0."""
    for lit in _LITERALS:
        if len(text) - i >= len(lit) and all(
                _same_letter(text[i + j], c) for j, c in enumerate(lit)):
            return len(lit)
    return 0


def words(text: str) -> list[str]:
    """CLIP's pre-tokenizer: the matches of its word pattern in ``text``, in
    order (the module docstring gives the pattern)."""
    out, i, n = [], 0, len(text)
    while i < n:
        kind = _class(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + (_literal_at(text, i) if text[i] in "<'" else 0)  # how every literal starts
        if j == i:
            j = i + 1
            if kind != "N":  # a number character is a word of its own
                while j < n and _class(text[j]) == kind:
                    j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPBPETokenizer:
    """CLIP's byte-level BPE from a local vocabulary and merge table. It is
    called as the reference calls ``transformers.CLIPTokenizer``:
    ``tokenizer(texts, padding="max_length", max_length=77,
    truncation=True)`` -> ``input_ids`` and ``attention_mask``, (B, 77) int64."""

    def __init__(self, vocab: dict[str, int], merges: Sequence[tuple[str, str]],
                 model_max_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.ranks = {tuple(pair): i for i, pair in enumerate(merges)}
        self.model_max_length = model_max_length
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = self.encoder[BOS_TOKEN]
        self.eos_token_id = self.encoder[EOS_TOKEN]
        self.pad_token_id = self.eos_token_id  # CLIP pads with eos
        self.unk_token = EOS_TOKEN
        self._bpe_cache: dict[str, str] = {BOS_TOKEN: BOS_TOKEN, EOS_TOKEN: EOS_TOKEN}
        try:
            from ftfy import fix_text
        except ImportError:
            fix_text = None
        self._fix_text = fix_text

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str,
                   model_max_length: int = 77) -> "CLIPBPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        # The first line is the "#version:" header.
        merges = [tuple(line.split()) for line in lines[1 : N_MERGES + 1]]
        return cls(vocab, merges, model_max_length)

    def _bpe(self, token: str) -> str:
        """Lowest-rank pair merging, the last symbol marked ``</w>``."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        if not token:
            return token
        symbols = list(token[:-1]) + [token[-1] + "</w>"]
        while len(symbols) > 1:
            ranked = [(self.ranks[p], p) for p in zip(symbols, symbols[1:]) if p in self.ranks]
            if not ranked:
                break
            best = min(ranked)[1]
            merged, i = [], 0
            while i < len(symbols):
                if i + 1 < len(symbols) and (symbols[i], symbols[i + 1]) == best:
                    merged.append(best[0] + best[1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        result = " ".join(symbols)
        self._bpe_cache[token] = result
        return result

    def tokenize(self, text: str) -> list[str]:
        text = (_ftfy_clean(text, self._fix_text) if self._fix_text is not None
                else _basic_clean(text))
        tokens = []
        for word in words(text):
            mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            tokens.extend(self._bpe(mapped).split(" "))
        return tokens

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> list[int]:
        unk = self.encoder[self.unk_token]
        return [self.encoder.get(t, unk) for t in tokens]

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        """bos + the BPE ids + eos, truncated to ``max_length`` in all."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if max_length is not None:
            ids = ids[: max(max_length - 2, 0)]
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def __call__(self, texts, padding: str = "max_length", max_length: int | None = None,
                 truncation: bool = True) -> dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        if max_length is None:
            max_length = self.model_max_length
        rows = [self.encode(text, max_length if truncation else None) for text in texts]
        width = max_length if padding == "max_length" else max(len(r) for r in rows)
        input_ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, ids in enumerate(rows):
            input_ids[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        specials = {self.bos_token_id, self.eos_token_id}
        text = "".join(self.decoder[i] for i in ids
                       if not (skip_special_tokens and i in specials))
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
