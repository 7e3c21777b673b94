"""A dataset resident in device memory: batches are gathers on the card.

Counterpart of ``tinydiffusion_tpu/data/device.py`` (``DeviceDataset``), for
what the resident steps read: one uint8 image array and, beside it, the
integer labels of a class-conditional model and/or the float rows of a
text-conditional one (the LAION set's (N, 768) text embeddings). They go to
the device once (MNIST is 47 MB, 640 LAION images at 256² 126 MB); a batch
is then an index gather and ``u8 * scale + shift`` in float32 on the device,
inside the step, so the only upload of an epoch is its index batches. The
scale and shift are ``u8_normalize``: MNIST's by default, ``(2 / 255, -1)``
for the LAION set, as JAX's ``u8_normalize`` takes them. The order is the host path's:
``epoch_index_batches(epoch)`` is the same
``np.random.default_rng([seed, epoch]).permutation`` stream as
``data.loader.BatchIterator.epoch`` with ``shuffle=True`` (the data order
with ``shuffle=False``, a validation split's), with the partial last batch
dropped, and ``gather`` computes what ``BatchIterator.to_device`` does with the
same ``u8_normalize``, in the same operations, so both paths see the
same batches to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from tinydiffusion_torch.data.mnist import MNIST_SCALE, MNIST_SHIFT


class DeviceDataset:
    """uint8 images (N, H, W, C), and optionally their integer labels (N,)
    and float rows ``embeds`` (N, D), held on ``device``, gathered by index
    batches into ``u8 * scale + shift`` float32 (and int64 labels, float32
    rows); shuffled each epoch unless ``shuffle=False``."""

    def __init__(self, images: np.ndarray, batch_size: int, seed: int = 0,
                 device: str | torch.device = "cuda", labels: np.ndarray | None = None,
                 shuffle: bool = True, embeds: np.ndarray | None = None,
                 u8_normalize: tuple[float, float] = (MNIST_SCALE, MNIST_SHIFT)):
        if images.dtype != np.uint8:
            raise TypeError(f"DeviceDataset holds uint8 images, not {images.dtype}")
        if labels is not None and np.shape(labels) != (len(images),):
            raise ValueError(f"labels of shape {np.shape(labels)} for {len(images)} images")
        if embeds is not None and (np.ndim(embeds) != 2 or len(embeds) != len(images)):
            raise ValueError(f"embeds of shape {np.shape(embeds)} for {len(images)} images")
        self.device = torch.device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        self.labels = (None if labels is None else
                       torch.from_numpy(np.asarray(labels, np.int64)).to(self.device))
        self.embeds = (None if embeds is None else
                       torch.from_numpy(np.ascontiguousarray(embeds, np.float32)).to(self.device))
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.u8_normalize = u8_normalize

    @property
    def num_batches(self) -> int:
        return len(self.images) // self.batch_size

    def epoch_index_batches(self, epoch: int = 0) -> np.ndarray:
        """(num_batches, B) int64 host array: the epoch's batches in order."""
        if self.shuffle:
            order = np.random.default_rng([self.seed, epoch]).permutation(len(self.images))
        else:
            order = np.arange(len(self.images))
        nb = self.num_batches
        return order[: nb * self.batch_size].reshape(nb, self.batch_size).astype(np.int64)

    def gather(self, idx: torch.Tensor):
        """One batch from an integer index tensor on the dataset's device:
        float32 ``images[idx] * scale + shift`` (NHWC) alone, or, when the
        dataset holds labels and/or embeds, the tuple ``(images, labels[idx],
        embeds[idx])`` of those it holds. Reads no device value, so a CUDA
        graph can capture it."""
        scale, shift = self.u8_normalize
        x = self.images.index_select(0, idx).to(torch.float32) * scale + shift
        rows = [a.index_select(0, idx) for a in (self.labels, self.embeds) if a is not None]
        return (x, *rows) if rows else x
