"""Text conditioning: the offline hash encoder.

Copy of ``HashTextEncoder`` from ``tinydiffusion_tpu/compat/text_encoder.py``
(the reference conditions on CLIP-L's last-token embedding, 768-d; the
committed LAION checkpoint was trained offline with this substitute). Each
lower-cased whitespace token maps to a fixed Gaussian vector (the first 8
bytes of its md5 seed ``np.random.default_rng``); a text's embedding is
``mean(token vectors) + 0.5 * last token vector``, scaled to norm
``sqrt(dim)``; an empty text is the token ``<empty>``. Numpy only, so the
embeddings equal the JAX package's to the bit.

The CLIP encoder (``compat/clip.py`` and its tokenizer in the JAX package)
is not ported yet: it needs converted weights and a vocabulary that cannot
be fetched here. ``get_text_encoder`` raises for it rather than handing back
the hash encoder in its place.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Sequence

import numpy as np

CLIP_NOT_PORTED = ("the CLIP text encoder is not ported yet (ROADMAP Queue 1 #1: the "
                   "converters for CLIP, its tokenizer and the SD-VAE); use "
                   "text_encoder='hash'")


class HashTextEncoder:
    """Deterministic offline text embedder (see the module docstring)."""

    def __init__(self, dim: int = 768):
        self.dim = dim
        self._cache: dict[str, np.ndarray] = {}

    def _token_vec(self, token: str) -> np.ndarray:
        if token not in self._cache:
            seed = int.from_bytes(hashlib.md5(token.encode("utf-8")).digest()[:8], "little")
            self._cache[token] = np.random.default_rng(seed).standard_normal(
                self.dim).astype(np.float32)
        return self._cache[token]

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """(len(texts), dim) float32."""
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            tokens = text.lower().split() or ["<empty>"]
            vecs = np.stack([self._token_vec(t) for t in tokens])
            emb = vecs.mean(0) + 0.5 * vecs[-1]  # last-token emphasis
            out[i] = emb / max(np.linalg.norm(emb) / np.sqrt(self.dim), 1e-6)
        return out


def get_text_encoder(name: str = "auto", dim: int = 768, clip_local_dir: str = ""):
    """``"hash"``, or ``"auto"`` without a ``clip_local_dir``: the hash
    encoder (JAX's ``"auto"`` ends there offline, with the same warning).
    ``"clip"``, and ``"auto"`` with a ``clip_local_dir``, raise: the CLIP
    encoder is not ported."""
    if name == "hash":
        return HashTextEncoder(dim)
    if name == "clip" or (name == "auto" and clip_local_dir):
        raise NotImplementedError(CLIP_NOT_PORTED)
    if name != "auto":
        raise ValueError(f"text_encoder={name!r}; choose 'clip', 'hash' or 'auto'")
    logging.getLogger("tinydiffusion_torch.text").warning(
        "CLIP weights unavailable (offline) — using deterministic hash text-encoder substitute")
    return HashTextEncoder(dim)
