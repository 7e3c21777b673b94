"""Deterministic shuffled batches on the host, normalised on the device.

Counterpart of the host path of ``tinydiffusion_tpu/data/loader.py``
(``BatchIterator`` and its ``device_transform``). The (seed, epoch) pair
fixes the order, ``np.random.default_rng([seed, epoch]).permutation(n)``,
as in JAX, so both packages see the same batches. A batch is a numpy gather
and stays uint8 until it reaches the device: ``to_device`` copies it from
pinned memory without blocking and applies ``u8 * scale + shift`` there (a
quarter of the bytes of float32 cross the bus). The host prepares the next
batch while the card runs the current step, so no worker thread is needed.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch


class BatchIterator:
    """Fixed-shape batches over aligned host arrays; a partial last batch is
    dropped. ``u8_normalize=(scale, shift)`` applies, in ``to_device``, to
    the uint8 arrays only (labels pass through)."""

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        u8_normalize: tuple[float, float] | None = None,
    ):
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("arrays must be aligned")
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.u8_normalize = u8_normalize

    def __len__(self) -> int:
        return self.n // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, ...]]:
        """Yield host batches for one epoch (deterministic in (seed, epoch))."""
        if self.shuffle:
            order = np.random.default_rng([self.seed, epoch]).permutation(self.n)
        else:
            order = np.arange(self.n)
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs : (b + 1) * bs]
            yield tuple(a[idx] for a in self.arrays)

    def to_device(
        self, batch: tuple[np.ndarray, ...], device: torch.device
    ) -> tuple[torch.Tensor, ...]:
        """The batch on ``device``: uint8 arrays as float32 ``u8 * scale +
        shift`` when ``u8_normalize`` is set, the rest as they are."""
        out = []
        for a in batch:
            x = torch.from_numpy(a)
            if device.type == "cuda":
                x = x.pin_memory().to(device, non_blocking=True)
            else:
                x = x.to(device)
            if a.dtype == np.uint8 and self.u8_normalize is not None:
                scale, shift = self.u8_normalize
                x = x.to(torch.float32) * scale + shift
            out.append(x)
        return tuple(out)
