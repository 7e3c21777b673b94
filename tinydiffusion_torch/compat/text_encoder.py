"""Text conditioning: the CLIP-L encoder and the offline hash encoder.

Copy of ``HashTextEncoder`` from ``tinydiffusion_tpu/compat/text_encoder.py``
(the reference conditions on CLIP-L's last-token embedding, 768-d; the
committed LAION checkpoint was trained offline with this substitute). Each
lower-cased whitespace token maps to a fixed Gaussian vector (the first 8
bytes of its md5 seed ``np.random.default_rng``); a text's embedding is
``mean(token vectors) + 0.5 * last token vector``, scaled to norm
``sqrt(dim)``; an empty text is the token ``<empty>``. Numpy only, so the
embeddings equal the JAX package's to the bit.

``get_text_encoder("clip")`` is ``compat/clip.py``'s ``CLIPTextEncoder``: from
a local directory (``clip_text.pth``, ``vocab.json``, ``merges.txt``) with no
network, else through transformers' ``from_pretrained``.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Sequence

import numpy as np
import torch

from tinydiffusion_torch.compat.clip import CLIPTextEncoder


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


def get_text_encoder(name: str = "auto", dim: int = 768, clip_local_dir: str = "",
                     device: str | torch.device = "cuda"):
    """``"hash"``: the hash encoder. ``"clip"`` or ``"auto"`` with a
    ``clip_local_dir``: ``CLIPTextEncoder.from_local`` on its
    ``clip_text.pth``, ``vocab.json`` and ``merges.txt``, the transformer on
    ``device``. ``"clip"`` without one: ``from_pretrained`` (``ImportError``
    without transformers). ``"auto"`` without one: the hash encoder, with
    JAX's offline warning (JAX's ``"auto"`` tries ``from_pretrained`` first;
    the port, offline as every run of the LAION path is, does not)."""
    if name == "hash":
        return HashTextEncoder(dim)
    if name not in ("clip", "auto"):
        raise ValueError(f"text_encoder={name!r}; choose 'clip', 'hash' or 'auto'")
    if clip_local_dir:
        return CLIPTextEncoder.from_local(os.path.join(clip_local_dir, "clip_text.pth"),
                                          os.path.join(clip_local_dir, "vocab.json"),
                                          os.path.join(clip_local_dir, "merges.txt"),
                                          device=device)
    if name == "clip":
        return CLIPTextEncoder.from_pretrained(device=device)
    logging.getLogger("tinydiffusion_torch.text").warning(
        "CLIP weights unavailable (offline) — using deterministic hash text-encoder substitute")
    return HashTextEncoder(dim)
