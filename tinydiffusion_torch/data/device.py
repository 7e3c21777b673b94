"""A dataset resident in device memory: batches are gathers on the card.

Counterpart of ``tinydiffusion_tpu/data/device.py`` (``DeviceDataset``), for
what the resident steps read: one uint8 image array and, for a
class-conditional model, its labels. They go to the device once (MNIST is
47 MB); a batch is then an index gather and ``u8 * MNIST_SCALE +
MNIST_SHIFT`` in float32 on the device, inside the step, so the only upload
of an epoch is its index batches. The order is the host path's:
``epoch_index_batches(epoch)`` is the same
``np.random.default_rng([seed, epoch]).permutation`` stream as
``data.loader.BatchIterator.epoch`` with ``shuffle=True`` (the data order
with ``shuffle=False``, a validation split's), with the partial last batch
dropped, and ``gather`` computes what ``BatchIterator.to_device`` does with
MNIST's ``u8_normalize``, in the same operations, so both paths see the
same batches to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from tinydiffusion_torch.data.mnist import MNIST_SCALE, MNIST_SHIFT


class DeviceDataset:
    """uint8 images (N, H, W, C), and optionally their integer labels (N,),
    held on ``device``, gathered by index batches into [-1, 1] (and int64
    labels); shuffled each epoch unless ``shuffle=False``."""

    def __init__(self, images: np.ndarray, batch_size: int, seed: int = 0,
                 device: str | torch.device = "cuda", labels: np.ndarray | None = None,
                 shuffle: bool = True):
        if images.dtype != np.uint8:
            raise TypeError(f"DeviceDataset holds uint8 images, not {images.dtype}")
        if labels is not None and np.shape(labels) != (len(images),):
            raise ValueError(f"labels of shape {np.shape(labels)} for {len(images)} images")
        self.device = torch.device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        self.labels = (None if labels is None else
                       torch.from_numpy(np.asarray(labels, np.int64)).to(self.device))
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle

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
        float32 ``images[idx] * MNIST_SCALE + MNIST_SHIFT`` (NHWC) and, when
        the dataset holds labels, ``(images, labels[idx])`` with int64
        labels. Reads no device value, so a CUDA graph can capture it."""
        x = self.images.index_select(0, idx).to(torch.float32) * MNIST_SCALE + MNIST_SHIFT
        if self.labels is None:
            return x
        return x, self.labels.index_select(0, idx)
