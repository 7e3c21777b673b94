"""Align-corners bilinear resizes as JAX computes them: two products.

Counterpart of ``tinydiffusion_tpu/nn/resize.py``'s
``resize_bilinear_align_corners`` and ``upsample_bilinear_2x``. JAX resizes
with a dense (out, in) interpolation matrix along H and then along W, both
cast to the activations' dtype: in bfloat16 the matrix's coefficients and
the intermediate after the H pass are rounded, where
``F.interpolate(bilinear, align_corners=True)`` mixes with exact
coefficients and rounds once. The products here round where JAX's do, and
their backward is two products as well (JAX's VJP), free of the atomics of
that op's CUDA backward. In float32 they equal ``F.interpolate``.

A model keeps the matrices of its resizes as buffers on its device
(``register_resize_matrices``); the products cast them to the activations'
dtype at each call. The max-pool needs nothing of JAX's: torch's
``max_pool2d(ceil_mode=True)`` is the rule JAX's custom VJP copies.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The (n_out, n_in) float32 matrix of 1-D align-corners bilinear
    interpolation, built in float64 as JAX builds it."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    w = np.zeros((n_out, n_in), np.float64)
    if n_out == 1:
        w[0, 0] = 1.0
        return w.astype(np.float32)
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = min(int(np.floor(src)), n_in - 1)
        hi = min(lo + 1, n_in - 1)
        w[i, lo] += 1.0 - (src - lo)
        w[i, hi] += src - lo
    return w.astype(np.float32)


def register_resize_matrices(module: nn.Module, pairs) -> None:
    """Each ``(n_in, n_out)`` of ``pairs``'s matrix as a buffer of ``module``
    (``resize_matrix(module, n_in, n_out)`` reads it back); not weights."""
    for n_in, n_out in pairs:
        module.register_buffer(f"resize_{n_in}_{n_out}",
                               torch.from_numpy(align_corners_matrix(n_in, n_out)),
                               persistent=False)


def resize_matrix(module: nn.Module, n_in: int, n_out: int) -> torch.Tensor:
    return getattr(module, f"resize_{n_in}_{n_out}")


def resize_bilinear_align_corners(x: torch.Tensor, mh: torch.Tensor,
                                  mw: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, H, W) with ``mh`` (H, h) and ``mw`` (W, w)
    (``align_corners_matrix``), along H and then along W, each product in
    ``x``'s dtype. The products run on the channels-last view (B, h, w, C),
    so a channels-last ``x`` (the UNets') is read in place and the result
    comes back channels-last."""
    b, c, h, w = x.shape
    big_h, big_w = mh.shape[0], mw.shape[0]
    mh, mw = mh.to(x.dtype), mw.to(x.dtype)
    xl = x.permute(0, 2, 3, 1).reshape(b, h, w * c)
    y = torch.matmul(mh, xl).reshape(b * big_h, w, c)
    y = torch.matmul(mw, y).reshape(b, big_h, big_w, c)
    return y.permute(0, 3, 1, 2)


def upsample_bilinear_2x(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(B, C, n, n) -> (B, C, 2n, 2n) with ``m = align_corners_matrix(n, 2n)``."""
    return resize_bilinear_align_corners(x, m, m)
