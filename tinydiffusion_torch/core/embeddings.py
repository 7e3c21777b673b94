"""Sinusoidal timestep embedding.

Counterpart of ``tinydiffusion_tpu/core/embeddings.py``
(``sinusoidal_time_embedding``; the reference's
conditional_diffusion_laion.py:223-232): ``concat(sin(t f), cos(t f))`` with
``f_i = exp(-ln(10000) i / (half - 1))``, zero-padded when ``dim`` is odd.
The frequencies are computed on the host in float64 and cast to float32, as
JAX does, so both packages multiply by the same float32 table. A model keeps
that table on its device (``sinusoidal_frequencies``, a buffer) and passes
it in: an upload inside a step would break a CUDA graph's capture.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sinusoidal_frequencies(dim: int) -> torch.Tensor:
    """The (dim // 2,) float32 frequency table, on the CPU."""
    half = dim // 2
    return torch.from_numpy(
        np.exp(-np.log(10000.0) * np.arange(half) / (half - 1)).astype(np.float32))


def sinusoidal_time_embedding(t: torch.Tensor, dim: int,
                              freqs: torch.Tensor | None = None) -> torch.Tensor:
    """(B,) integer or float timesteps -> (B, dim) float32 on ``t``'s device.
    ``freqs``: ``sinusoidal_frequencies(dim)`` already on that device."""
    if freqs is None:
        freqs = sinusoidal_frequencies(dim).to(t.device)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
